"""Microcanonical Langevin Monte Carlo (MCLMC).

Robnik, De Luca, Silverstein & Seljak (2023, JMLR "Microcanonical
Hamiltonian Monte Carlo"; 2024 Langevin variant): sampling from the
ISOKINETIC ensemble — momentum lives on the unit sphere, the dynamics
conserve |u| = 1 exactly, and the marginal of x under the microcanonical
measure is the target. No Metropolis correction: like SGLD the bias is
controlled by the step size, here measured DIRECTLY by the per-step
energy-error variance, which is what :meth:`MCLMCSampler.tune` drives to
the paper's target (Var[ΔE]/d ≈ 5e-4 keeps the asymptotic bias below
Monte-Carlo error in the benchmarked targets).

Why it earns a slot next to HMC/NUTS here: the kernel is one gradient,
a few vector ops and a partial momentum refresh per step — no
accept/reject branch, no U-turn recursion, no dynamic trajectory
lengths. That is the ideal XLA shape: a fixed-work `lax.scan` body,
chains vmapped as a (C, P) batch whose axis shards over the mesh like
every other engine (the per-chain reductions — |g|, u·e, |u+νz| — are
lane reductions, not cross-chain collectives).

Dynamics per step (isokinetic leapfrog, one gradient evaluation):

  u  <- esh(u, g(x), eps/2)        # momentum half-step toward ∇logp
  x  <- x + eps · u                # position full step on the sphere flow
  u  <- esh(u, g(x'), eps/2)       # second half-step (gradient reused
                                   #   next step — 1 eval amortized)
  u  <- normalize(u + nu · z)      # Langevin partial refresh,
                                   #   nu² = (e^{2 eps/L} − 1)/d

with the exact isokinetic momentum map (d = n_params)

  esh(u, g, dt):  e = g/|g|,  δ = dt·|g|/(d−1)
      u' = (u + e(sinh δ + (u·e)(cosh δ − 1))) / (cosh δ + (u·e) sinh δ)

whose kinetic-energy change (d−1)·log(cosh δ + (u·e) sinh δ) plus the
potential change −Δlogp gives the per-step energy error ΔE used for
step-size tuning. L is the momentum-decoherence length; the tuner sets
it to ``1.6·sqrt(Σ_i Var[x_i])`` from the adaptation draws (the paper's
Gaussian-optimal scaling).

No reference counterpart (the reference is gradient-free) — this extends
the gradient family the same way SGLD did (SURVEY.md north-star scope).
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from mcmcpp_tpu.chain import Chain, append_device_chunk


class MCLMCState(NamedTuple):
    position: jax.Array  # (C, P)
    momentum: jax.Array  # (C, P) unit rows
    logp: jax.Array      # (C,)
    grad: jax.Array      # (C, P)


def _esh(u, g, dt, d):
    """Exact isokinetic momentum update; returns (u', ΔK per chain).

    Evaluated in exp(−δ) factors, NOT raw sinh/cosh: δ = dt·|g|/(d−1)
    overflows float32 cosh at δ ≳ 89 (sharp targets hit that on step
    one), silently turning the chain into NaNs. Multiplying numerator
    and denominator by 2e^{−δ} gives the overflow-free form
        u' ∝ 2ζu + e(1−ζ)(1+ζ+u·e(1−ζ)),   ζ = e^{−δ},
        ΔK = (d−1)[δ − log2 + log((1+u·e) + (1−u·e)ζ²)],
    and normalizing u' to the sphere replaces the division entirely.
    """
    g_norm = jnp.maximum(jnp.linalg.norm(g, axis=-1, keepdims=True), 1e-30)
    e = g / g_norm
    ue = jnp.sum(u * e, axis=-1, keepdims=True)
    delta = dt * g_norm / (d - 1.0)
    zeta = jnp.exp(-delta)
    uu = e * (1.0 - zeta) * (1.0 + zeta + ue * (1.0 - zeta)) + 2.0 * zeta * u
    u_new = uu / jnp.maximum(
        jnp.linalg.norm(uu, axis=-1, keepdims=True), 1e-30
    )
    dk = (d - 1.0) * (
        delta[..., 0] - np.log(2.0)
        + jnp.log(jnp.maximum(
            (1.0 + ue[..., 0]) + (1.0 - ue[..., 0]) * zeta[..., 0] ** 2,
            1e-30,
        ))
    )
    return u_new, dk


class MCLMCSampler:
    """Microcanonical Langevin MC over C parallel chains.

    logp_fn: (P,) -> scalar (vmapped internally). ``step_size`` (eps) and
    ``decoherence_length`` (L) are the two hyperparameters; leave them
    and call :meth:`tune` for the energy-error-targeted automation, or
    set them explicitly. ``d >= 2`` required (the isokinetic map divides
    by d−1).
    """

    def __init__(self, logp_fn, n_chains, n_params, seed=0,
                 dtype=jnp.float32, step_size=None,
                 decoherence_length=None, inv_mass=None,
                 max_chain_bytes=2 << 30, mesh=None, chain=None):
        if int(n_params) < 2:
            raise ValueError("MCLMC needs n_params >= 2 (isokinetic map "
                             "divides by d-1)")
        self.n_chains = int(n_chains)
        self.n_params = int(n_params)
        self.dtype = dtype
        self._logp_fn = logp_fn
        self._vg = jax.vmap(jax.value_and_grad(logp_fn))
        # Gaussian-calibrated defaults: eps ~ 0.3·sqrt(d) then tuned; the
        # sphere flow moves |dx| = eps per step regardless of d
        self.step_size = (float(step_size) if step_size is not None
                          else 0.3 * float(np.sqrt(self.n_params)))
        self.decoherence_length = (
            float(decoherence_length) if decoherence_length is not None
            else 1.6 * float(np.sqrt(self.n_params))
        )
        self._key = jax.random.key(seed)
        self.state = None
        self.energy_var = float("nan")  # Var[ΔE]/d from the last tune leg
        # bumped whenever inv_mass is (re)assigned — run-program cache key
        # (the metric is baked into the jitted programs as a constant, so
        # a stale cache entry would silently sample with the OLD metric)
        self._metric_version = 0
        # diagonal preconditioner: the dynamics run in whitened z = x/s
        # coordinates (s = sqrt(inv_mass)), implemented without a
        # reparametrized target — gradients scale by s, position steps by
        # s·u (exactly the dense-metric trick restricted to a diagonal)
        self.inv_mass = (None if inv_mass is None
                         else jnp.asarray(inv_mass, dtype))
        # per-launch stored-step cap (None = the 64 MB default only);
        # heavy-trajectory subclasses set it to bound per-launch work
        self.max_chunk_steps = None
        if chain is not None:
            if (chain.n_walkers, chain.n_params) != (
                self.n_chains, self.n_params,
            ):
                raise ValueError("injected chain store geometry mismatch")
            self.chain = chain
        else:
            self.chain = Chain(
                n_walkers=self.n_chains, n_params=self.n_params,
                max_bytes=max_chain_bytes,
                dtype=np.dtype(jax.dtypes.canonicalize_dtype(dtype)),
            )
        self.mesh = mesh
        self._chain_sharding = None
        if mesh is not None:
            from mcmcpp_tpu.parallel.mesh import walker_sharding

            if self.n_chains % mesh.size != 0:
                raise ValueError(
                    f"n_chains={self.n_chains} not divisible by mesh "
                    f"size {mesh.size}"
                )
            self._chain_sharding = walker_sharding(mesh)
        self._run_cache = {}

    @property
    def inv_mass(self):
        """Diagonal inverse mass (whitening scales²), or None. Setting
        it bumps the internal metric version so cached run programs —
        which bake the metric in as a trace-time constant — are never
        reused with a stale value."""
        return self._inv_mass

    @inv_mass.setter
    def inv_mass(self, value):
        if value is not None:
            value = jnp.asarray(value, self.dtype)
            if value.shape != (self.n_params,):
                raise ValueError(
                    f"inv_mass must be ({self.n_params},) diagonal"
                )
        self._inv_mass = value
        self._metric_version += 1

    # -- kernel --------------------------------------------------------------

    def _constrain(self, state):
        if self._chain_sharding is None:
            return state
        from mcmcpp_tpu.parallel.mesh import vector_sharding

        c = lambda x: jax.lax.with_sharding_constraint(
            x, self._chain_sharding
        )
        v = lambda x: jax.lax.with_sharding_constraint(
            x, vector_sharding(self._chain_sharding)
        )
        return MCLMCState(c(state.position), c(state.momentum),
                          v(state.logp), c(state.grad))

    def _scale(self):
        """Whitening scale s = sqrt(inv_mass) (None -> identity)."""
        return (None if self.inv_mass is None
                else jnp.sqrt(self.inv_mass)[None, :])

    def _step(self, key, state, eps, length):
        """One MCLMC transition; returns (state, ΔE (C,))."""
        d = float(self.n_params)
        s = self._scale()
        state = self._constrain(state)
        g0 = state.grad if s is None else state.grad * s
        u, dk1 = _esh(state.momentum, g0, eps / 2.0, d)
        x = state.position + eps * (u if s is None else u * s)
        logp, grad = self._vg(x)
        g1 = grad if s is None else grad * s
        u, dk2 = _esh(u, g1, eps / 2.0, d)
        # Langevin partial refresh (O-step)
        nu = jnp.sqrt(jnp.expm1(2.0 * eps / length) / d)
        z = jax.random.normal(key, u.shape, u.dtype)
        un = u + nu * z
        u = un / jnp.linalg.norm(un, axis=-1, keepdims=True)
        d_energy = dk1 + dk2 - (logp - state.logp)
        return self._constrain(MCLMCState(x, u, logp, grad)), d_energy

    # -- init ----------------------------------------------------------------

    def init(self, positions):
        positions = jnp.asarray(positions, self.dtype)
        if positions.shape != (self.n_chains, self.n_params):
            raise ValueError(
                f"positions must be ({self.n_chains}, {self.n_params})"
            )
        if self._chain_sharding is not None:
            positions = jax.device_put(positions, self._chain_sharding)
        self._key, k_u = jax.random.split(self._key)
        u = jax.random.normal(k_u, positions.shape, self.dtype)
        u = u / jnp.linalg.norm(u, axis=-1, keepdims=True)
        logp, grad = self._vg(positions)
        self.state = self._constrain(MCLMCState(positions, u, logp, grad))
        return self

    def init_ball(self, center, scale=1.0, seed=None):
        key = self._key if seed is None else jax.random.key(seed)
        key = jax.random.fold_in(key, 0x3C1)
        center = jnp.asarray(center, self.dtype)
        z = jax.random.normal(key, (self.n_chains, self.n_params),
                              self.dtype)
        return self.init(center[None, :] + scale * z)

    # -- tuning --------------------------------------------------------------

    def _tune_eps_rounds(self, leg, rounds, target_energy_var):
        """Multiplicative eps search against the energy-error target;
        one jitted leg program per call (re-call after changing the
        metric). Returns the last leg's draws."""

        def run_leg(state, key, eps):
            def body(carry, k):
                st, _ = carry
                st, de = self._step(k, st, eps, self.decoherence_length)
                return (st, de), (de, st.position)

            keys = jax.random.split(key, leg)
            (state, _), (des, xs) = jax.lax.scan(
                body, (state, jnp.zeros((self.n_chains,), self.dtype)),
                keys,
            )
            return state, des, xs

        run_leg = jax.jit(run_leg)
        eps = self.step_size
        xs = None
        for _ in range(int(rounds)):
            self._key, k = jax.random.split(self._key)
            self.state, des, xs = run_leg(
                self.state, k, jnp.asarray(eps, self.dtype)
            )
            var_e = float(jnp.var(des)) / self.n_params
            self.energy_var = var_e
            ratio = (target_energy_var / max(var_e, 1e-12)) ** 0.25
            eps *= float(np.clip(ratio, 0.5, 2.0))
        self.step_size = float(eps)
        return xs

    def tune(self, n_steps=600, target_energy_var=5e-4, rounds=6,
             precondition=False):
        """Automation (paper §3.3 / the Blackjax recipe, simplified to a
        fixed-round multiplicative search):

        1. step size: run ``n_steps/rounds`` steps per round, measure
           Var[ΔE]/d over chains and steps, update
           ``eps *= (target/measured)^{1/4}`` (ΔE ∝ eps², so Var ∝ eps⁴),
           clipped to [½, 2] per round;
        2. (``precondition=True``) diagonal metric: after the first half
           of the rounds, ``inv_mass = Var[x_i]`` per dimension from the
           adaptation draws — the dynamics then run in whitened
           coordinates (gradient × s, position step × s, s = √inv_mass)
           and the remaining rounds re-find eps under the new metric;
        3. decoherence length: ``L = 1.6·sqrt(Σ_i Var[z_i])`` from the
           final round's WHITENED draws.

        Leaves the chain store untouched. Returns self.
        """
        if self.state is None:
            raise RuntimeError("call init/init_ball first")
        leg = max(int(n_steps) // int(rounds), 10)
        if precondition:
            rounds_a = max(int(rounds) // 2, 1)
            xs = self._tune_eps_rounds(leg, rounds_a, target_energy_var)
            flat = np.asarray(xs, np.float64).reshape(-1, self.n_params)
            var = np.maximum(flat.var(axis=0), 1e-12)
            self.inv_mass = jnp.asarray(var, self.dtype)
            # whitened space is ~unit scale: reset L for the re-search
            self.decoherence_length = 1.6 * float(np.sqrt(self.n_params))
            xs = self._tune_eps_rounds(
                leg, max(int(rounds) - rounds_a, 2), target_energy_var
            )
        else:
            xs = self._tune_eps_rounds(leg, int(rounds), target_energy_var)
        flat = np.asarray(xs, np.float64).reshape(-1, self.n_params)
        scale2 = (np.ones(self.n_params) if self.inv_mass is None
                  else np.asarray(self.inv_mass, np.float64))
        self.decoherence_length = float(
            1.6 * np.sqrt((flat.var(axis=0) / scale2).sum())
        )
        return self

    # -- run -----------------------------------------------------------------

    def _run_scan(self, state, key, n_store, thin):
        eps = jnp.asarray(self.step_size, self.dtype)
        length = self.decoherence_length

        def body(carry, k):
            st = carry

            def inner(j, sk):
                s, kk = sk
                kk, sub = jax.random.split(kk)
                s, _ = self._step(sub, s, eps, length)
                return (s, kk)

            st, _ = jax.lax.fori_loop(0, thin, inner, (st, k))
            return st, (st.position, st.logp)

        keys = jax.random.split(key, n_store)
        state, (pos, lps) = jax.lax.scan(body, state, keys)
        return state, pos, lps

    def run(self, n_steps, thin=1):
        """Advance ``n_steps``, storing every thin-th (position, logp).
        Pipelined device->host like the other drivers; False on the chain
        byte cap (EndOfChain semantics)."""
        if self.state is None:
            raise RuntimeError("call init/init_ball first")
        thin = int(thin)
        n_store = int(n_steps) // thin
        from mcmcpp_tpu.chain import default_chunk_steps, run_pipelined

        chunk = default_chunk_steps(self.n_chains, self.n_params,
                                    self.dtype)
        if self.max_chunk_steps is not None:
            # heavy-trajectory drivers: bound the per-launch work (one
            # launch's device time and the host's wait between syncs)
            chunk = min(chunk, int(self.max_chunk_steps))

        def launch(take):
            cache_key = (take, thin, self.step_size,
                         self.decoherence_length, self._metric_version)
            fn = self._run_cache.get(cache_key)
            if fn is None:
                fn = jax.jit(
                    lambda st, k, t=take, th=thin: self._run_scan(
                        st, k, t, th
                    )
                )
                self._run_cache[cache_key] = fn
            self._key, run_key = jax.random.split(self._key)
            self.state, pos, lps = fn(self.state, run_key)
            return (pos, lps)

        def fetch(futures):
            self.chain, appended = append_device_chunk(
                self.chain, futures[0], futures[1]
            )
            return appended

        return run_pipelined(n_store, chunk, launch, fetch)

    def get_samples(self, burn_in=0, thin=1, flat=False):
        return self.chain.get(burn_in=burn_in, thin=thin, flat=flat)

    def get_log_probs(self, burn_in=0, thin=1, flat=False):
        return self.chain.get_logp(burn_in=burn_in, thin=thin, flat=flat)


class MAMSSampler(MCLMCSampler):
    """Metropolis-ADJUSTED microcanonical sampler (Robnik & Seljak 2024).

    The exact sibling of :class:`MCLMCSampler`: each transition draws a
    fresh uniform-sphere momentum, integrates the SAME isokinetic
    leapfrog for a jittered number of steps (≈ L/eps, uniform jitter
    breaking resonances), and Metropolis-accepts the whole trajectory
    with ``min(1, exp(−ΔE))`` — the tracked energy error IS the correct
    MH log-ratio because the (d−1)·log(cosh δ + u·e sinh δ) kinetic
    terms are exactly the esh map's phase-space log-Jacobian. Rejection
    keeps the current point; momentum is refreshed fully either way.

    Zero asymptotic bias (unlike MCLMC) at the cost of the accept branch;
    still branchless per INTEGRATION step and fixed-work per transition,
    so the XLA program shape stays a scan over a `fori_loop` — the
    jittered step count is drawn per transition and padded to the static
    maximum with masked no-op steps.

    ``tune()`` (inherited signature) targets acceptance ≈ 0.9 instead of
    an energy-variance level, then sets L from the cloud spread like the
    unadjusted tuner.
    """

    def __init__(self, *args, target_accept=0.9, max_chunk_steps=128,
                 **kw):
        self.target_accept = float(target_accept)
        super().__init__(*args, **kw)
        self.last_mean_accept = float("nan")
        # each stored step is up to ceil(2L/eps) gradient evals — cap the
        # per-launch work like PMMH does
        self.max_chunk_steps = (None if max_chunk_steps is None
                                else int(max_chunk_steps))

    def _trajectory(self, key, state, eps, n_max):
        """Jittered-length isokinetic trajectory + MH accept.

        n_max is the STATIC step cap; the live length is drawn uniform
        in [1, n_max] per transition and later steps are masked no-ops.
        """
        d = float(self.n_params)
        k_len, k_u, k_acc = jax.random.split(key, 3)
        n_live = jax.random.randint(k_len, (), 1, n_max + 1)
        u = jax.random.normal(k_u, state.position.shape, self.dtype)
        u = u / jnp.linalg.norm(u, axis=-1, keepdims=True)

        s = self._scale()

        def body(i, carry):
            x, u, logp, grad, de = carry
            live = i < n_live
            g0 = grad if s is None else grad * s
            u2, dk1 = _esh(u, g0, eps / 2.0, d)
            x2 = x + eps * (u2 if s is None else u2 * s)
            logp2, grad2 = self._vg(x2)
            g1 = grad2 if s is None else grad2 * s
            u2, dk2 = _esh(u2, g1, eps / 2.0, d)
            de2 = de + dk1 + dk2 - (logp2 - logp)
            # masked no-op beyond the live length (static-shape jitter)
            return (
                jnp.where(live, x2, x), jnp.where(live, u2, u),
                jnp.where(live, logp2, logp),
                jnp.where(live, grad2, grad), jnp.where(live, de2, de),
            )

        x, u, logp, grad, de = jax.lax.fori_loop(
            0, n_max, body,
            (state.position, u, state.logp, state.grad,
             jnp.zeros((self.n_chains,), self.dtype)),
        )
        accept = (
            jnp.log(jax.random.uniform(k_acc, (self.n_chains,))) < -de
        )
        pos = jnp.where(accept[:, None], x, state.position)
        new_logp = jnp.where(accept, logp, state.logp)
        new_grad = jnp.where(accept[:, None], grad, state.grad)
        new_state = self._constrain(
            MCLMCState(pos, u, new_logp, new_grad)
        )
        return new_state, accept

    def _n_max(self, eps):
        return max(int(np.ceil(2.0 * self.decoherence_length / eps)), 2)

    def tune(self, n_steps=600, target_energy_var=None, rounds=6,
             precondition=False):
        """Acceptance-targeted step-size search + cloud-spread L (the
        adjusted analogue of the unadjusted tuner; ``target_energy_var``
        is ignored — acceptance is the natural adjusted target).
        ``precondition=True`` inserts the same mid-tune diagonal-metric
        estimation as the unadjusted tuner."""
        if self.state is None:
            raise RuntimeError("call init/init_ball first")
        leg = max(int(n_steps) // int(rounds), 5)
        eps = self.step_size
        xs = None
        switch_at = max(int(rounds) // 2, 1) if precondition else None
        leg_cache = {}  # (n_max, metric_version) -> jitted leg program

        def make_leg(n_max):
            def run_leg(state, key, eps_v):
                def body(carry, k):
                    st, _ = carry
                    st, acc = self._trajectory(k, st, eps_v, n_max)
                    return (st, acc), (acc, st.position)

                keys = jax.random.split(key, leg)
                (state, _), (accs, xs) = jax.lax.scan(
                    body,
                    (state, jnp.zeros((self.n_chains,), bool)),
                    keys,
                )
                return state, accs, xs

            return jax.jit(run_leg)

        for r in range(int(rounds)):
            if switch_at is not None and r == switch_at and xs is not None:
                flat = np.asarray(xs, np.float64).reshape(
                    -1, self.n_params
                )
                self.inv_mass = jnp.asarray(
                    np.maximum(flat.var(axis=0), 1e-12), self.dtype
                )
                self.decoherence_length = (
                    1.6 * float(np.sqrt(self.n_params))
                )
            n_max = self._n_max(eps)
            leg_key = (n_max, self._metric_version)
            run_leg = leg_cache.get(leg_key)
            if run_leg is None:
                run_leg = leg_cache[leg_key] = make_leg(n_max)

            self._key, k = jax.random.split(self._key)
            self.state, accs, xs = run_leg(
                self.state, k, jnp.asarray(eps, self.dtype)
            )
            acc = float(jnp.mean(accs))
            self.last_mean_accept = acc
            eps *= float(np.clip(np.exp(acc - self.target_accept),
                                 0.5, 2.0))
        self.step_size = float(eps)
        flat = np.asarray(xs, np.float64).reshape(-1, self.n_params)
        scale2 = (np.ones(self.n_params) if self.inv_mass is None
                  else np.asarray(self.inv_mass, np.float64))
        self.decoherence_length = float(
            1.6 * np.sqrt((flat.var(axis=0) / scale2).sum())
        )
        return self

    def _run_scan(self, state, key, n_store, thin):
        eps = jnp.asarray(self.step_size, self.dtype)
        n_max = self._n_max(self.step_size)

        def body(st, k):
            def inner(j, sk):
                s, kk = sk
                kk, sub = jax.random.split(kk)
                s, _ = self._trajectory(sub, s, eps, n_max)
                return (s, kk)

            st, _ = jax.lax.fori_loop(0, thin, inner, (st, k))
            return st, (st.position, st.logp)

        state, (pos, lps) = jax.lax.scan(
            body, state, jax.random.split(key, n_store)
        )
        return state, pos, lps
