"""Sequential Monte Carlo sampler with adaptive tempering.

North-star scope (no reference counterpart). Anneals particles from a prior
sample to the posterior along the likelihood-tempered path
p_β ∝ prior · like^β (β: 0 → 1), so incremental weights are like^Δβ:

1. adapt Δβ by bisection so the ESS of incremental weights stays at a
   target fraction (default 0.5) of the particle count,
2. resample systematically (O(N), sorted-uniform inverse-CDF — a single
   cumsum + searchsorted, both XLA-friendly; on a sharded particle axis the
   cumsum/gather become collectives),
3. mutate with a few stretch-move MCMC steps targeting p_β (reusing the
   ensemble mover layer, so SMC inherits every mover in movers/).

Everything per-temperature-stage runs jitted; the β ladder is adaptive so
stages loop in Python with on-device state.

**Waste-free mode** (``waste_free_k=K``; Dau & Chopin 2022, "Waste-free
sequential Monte Carlo", JRSS-B): instead of resampling N particles and
discarding the intermediate states of the K mutation steps, resample only
M = N/(K+1) seeds and keep EVERY state their K-step chains visit — the next
particle set is the union {seeds} ∪ {all K intermediate ensembles}, again of
size N. Since the mutation kernel leaves p_β invariant, the union is a valid
(dependent) sample from p_β and the standard like^Δβ weights/evidence
estimator apply; per stage only M chains are advanced instead of N, so the
same device FLOPs buy (K+1)× the particle diversity. The K collected
ensembles fall out of the mutation ``lax.scan``'s stacked outputs for free.
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from mcmcpp_tpu.movers.stretch import StretchMove


class SMCState(NamedTuple):
    particles: jax.Array  # (N, P)
    log_prior: jax.Array  # (N,)
    log_like: jax.Array  # (N,)
    beta: jax.Array  # scalar
    log_evidence: jax.Array  # scalar accumulator


def ess_from_log_weights(log_w):
    """Effective sample size of normalized weights, in particles."""
    log_w = log_w - jax.scipy.special.logsumexp(log_w)
    return jnp.exp(-jax.scipy.special.logsumexp(2.0 * log_w))


def systematic_resample(key, log_w, n):
    """Systematic resampling: indices (n,) drawn ∝ weights."""
    w = jnp.exp(log_w - jax.scipy.special.logsumexp(log_w))
    cum = jnp.cumsum(w)
    cum = cum / cum[-1]
    u0 = jax.random.uniform(key, (), cum.dtype)
    pts = (u0 + jnp.arange(n, dtype=cum.dtype)) / n
    return jnp.searchsorted(cum, pts, side="left").astype(jnp.int32)


def _find_next_beta(log_like, beta, target_ess_frac, n):
    """Largest Δβ (bisection, 32 iters) keeping incremental ESS ≥ target·N."""
    target = target_ess_frac * n

    def ess_at(b_new):
        return ess_from_log_weights((b_new - beta) * log_like)

    def body(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        ok = ess_at(mid) >= target
        return jnp.where(ok, mid, lo), jnp.where(ok, hi, mid)

    full = ess_at(jnp.ones_like(beta)) >= target
    lo, hi = jax.lax.fori_loop(
        0, 32, body, (beta, jnp.ones_like(beta))
    )
    return jnp.where(full, jnp.ones_like(beta), lo)


class SMCSampler:
    """Adaptive-tempering SMC from prior to posterior.

    Parameters
    ----------
    log_prior_fn, log_like_fn : (P,) -> scalar, JAX-traceable.
    prior_sample_fn : (key, n) -> (n, P) initial particles from the prior.
    n_particles : particle count (even; stretch mutation uses halves).
    n_mcmc : mutation steps per stage.
    target_ess : ESS fraction triggering the β step size (default 0.5).
    waste_free_k : if set, run in waste-free mode (module docstring):
        resample M = n_particles/(K+1) seeds per stage, mutate them K
        steps, and keep every intermediate ensemble as particles.
        ``n_mcmc`` is ignored in this mode. Requires n_particles divisible
        by K+1 with an even quotient.
    mutation : ``"ensemble"`` (default; the affine-invariant ``mover``,
        gradient-free) or ``"mala"`` — preconditioned MALA on the
        tempered target, with the per-dimension proposal scale set from
        the post-resampling particle spread each stage (the standard
        adaptive-SMC argument: kernel parameters are measurable wrt the
        pre-mutation state, so π_β-invariance per particle is preserved;
        cf. Chopin & Papaspiliopoulos 2020 §17.2). The gradient kernel
        is the choice in higher dimensions, where stretch acceptance
        collapses. Or ``"flow"`` — normalizing-flow-preconditioned
        mutation: each stage refits a flow to the post-resampling
        particle cloud by forward-KL maximum likelihood (one jitted Adam
        scan, warm-started across stages), then runs ``n_mcmc``
        independence-Metropolis steps proposing from the flow. Because
        proposals are GLOBAL draws from a fit of p_β itself, the kernel
        hops between modes local kernels cannot connect — the choice for
        multimodal targets (cf. Arbel, Matthews & Doucet 2021, "Annealed
        Flow Transport Monte Carlo", which anneals flows along the same
        tempered path). Validity is the same measurability argument as
        the MALA scale: the flow is a function of the pre-mutation
        state, so each of the K MH steps leaves p_β invariant exactly —
        the flow fit quality affects mixing only, never correctness.
        Or ``"hmc"`` — ChEES-style fixed-shape HMC on the tempered
        target: ``hmc_steps`` static leapfrog steps per mutation step,
        diagonal preconditioning from the post-resampling spread (the
        SAME measurability argument as the MALA scale — the mass matrix
        and base step size are functions of the pre-mutation state, so
        each trajectory's Metropolis accept leaves p_β invariant
        exactly), and per-particle step-size jitter U(0.5, 1.5) in
        place of trajectory-length adaptation — jitter breaks the
        periodic resonances fixed-length HMC suffers (the role ChEES's
        halton jitter plays, Hoffman, Radul & Sountsov 2021) while
        keeping every shape static inside the stage scan. Gradient cost
        per mutation step is ``hmc_steps`` fused value_and_grad sweeps
        vs MALA's one; the trajectories decorrelate correspondingly
        further — measured A/B on the 10-D correlated Gaussian in
        tests/test_smc_vi.py::TestHMCMutation.
    mala_scale : step multiplier; the proposal sd per dim is
        ``mala_scale · P^{-1/6} · std_d`` (MALA optimal scaling).
    hmc_steps, hmc_scale : leapfrog count and step multiplier for
        ``mutation="hmc"``; the base step is
        ``hmc_scale · P^{-1/4} · std_d`` (HMC optimal scaling).
    flow : flow object for ``mutation="flow"`` (``RealNVP`` /
        ``SplineCoupling`` / ``IAF`` from :mod:`mcmcpp_tpu.neutra`;
        default ``RealNVP(n_params)``). Needs a cheap exact ``inverse``
        for the proposal-density carry — RealNVP and SplineCoupling are
        one parallel pass; IAF's inverse is sequential (slow, avoid).
    flow_fit_steps, flow_batch, flow_lr : per-stage forward-KL Adam
        schedule. The fit is warm-started from the previous stage's
        params (the annealing path moves slowly, so late stages converge
        in a few dozen steps).
    """

    def __init__(self, log_prior_fn, log_like_fn, prior_sample_fn, n_particles,
                 n_params, n_mcmc=5, target_ess=0.5, seed=0, dtype=jnp.float32,
                 mover=None, mesh=None, waste_free_k=None,
                 mutation="ensemble", mala_scale=1.0, flow=None,
                 flow_fit_steps=150, flow_batch=256, flow_lr=1e-3,
                 hmc_steps=8, hmc_scale=0.5):
        if mutation not in ("ensemble", "mala", "flow", "hmc"):
            raise ValueError(f"unknown mutation {mutation!r}")
        self.mutation = mutation
        self.mala_scale = float(mala_scale)
        self.hmc_steps = int(hmc_steps)
        self.hmc_scale = float(hmc_scale)
        if self.hmc_steps < 1:
            raise ValueError("hmc_steps must be >= 1")
        self.log_prior_fn = log_prior_fn
        self.log_like_fn = log_like_fn
        self.prior_sample_fn = prior_sample_fn
        self.n = int(n_particles)
        self.n_params = int(n_params)
        self.n_mcmc = int(n_mcmc)
        self.target_ess = float(target_ess)
        self.waste_free_k = None if waste_free_k is None else int(waste_free_k)
        if self.waste_free_k is not None:
            k = self.waste_free_k
            if k < 1:
                raise ValueError("waste_free_k must be >= 1")
            if self.n % (k + 1):
                raise ValueError(
                    f"n_particles={self.n} not divisible by "
                    f"waste_free_k+1={k + 1}"
                )
            if (self.n // (k + 1)) % 2:
                raise ValueError(
                    f"waste-free seed count {self.n // (k + 1)} must be even "
                    "(stretch mutation uses halves)"
                )
        self.dtype = dtype
        self.mover = mover if mover is not None else StretchMove()
        self._flow = None
        if mutation == "flow":
            import optax

            if flow is None:
                from mcmcpp_tpu.neutra import RealNVP

                flow = RealNVP(self.n_params, dtype=dtype)
            self._flow = flow
            self._flow_fit_steps = int(flow_fit_steps)
            self._flow_batch = int(flow_batch)
            self._flow_opt = optax.adam(float(flow_lr))
        self._key = jax.random.key(seed)
        # optional particle-axis sharding: ESS/logsumexp reduce over the
        # mesh, resampling's cumsum/searchsorted/gather become collectives
        self._particle_sharding = None
        if mesh is not None:
            from mcmcpp_tpu.parallel.mesh import walker_sharding

            if self.n % mesh.size != 0:
                raise ValueError(
                    f"n_particles={self.n} not divisible by mesh {mesh.size}"
                )
            self._particle_sharding = walker_sharding(mesh)
        self._stage = jax.jit(self._stage_impl)
        self.state = None
        self._flow_carry = None
        self.n_stages = 0
        self.beta_ladder = []

    def init(self):
        if self._flow is not None:
            self._key, fk = jax.random.split(self._key)
            fp = self._flow.init(fk)
            self._flow_carry = (fp, self._flow_opt.init(fp))
        self._key, k = jax.random.split(self._key)
        particles = jnp.asarray(self.prior_sample_fn(k, self.n), self.dtype)
        if self._particle_sharding is not None:
            particles = jax.device_put(particles, self._particle_sharding)
        lp = jax.vmap(self.log_prior_fn)(particles)
        ll = jax.vmap(self.log_like_fn)(particles)
        self.state = SMCState(
            particles, lp, ll,
            beta=jnp.zeros((), self.dtype),
            log_evidence=jnp.zeros((), self.dtype),
        )
        return self

    # -- one adaptive stage, fully jitted ---------------------------------

    def _constrain(self, state: SMCState) -> SMCState:
        if self._particle_sharding is None:
            return state
        from mcmcpp_tpu.parallel.mesh import vector_sharding

        vec = vector_sharding(self._particle_sharding)
        c = lambda x: jax.lax.with_sharding_constraint(
            x, self._particle_sharding
        )
        v = lambda x: jax.lax.with_sharding_constraint(x, vec)
        return state._replace(
            particles=c(state.particles),
            log_prior=v(state.log_prior),
            log_like=v(state.log_like),
        )

    def _fit_flow(self, key, particles, flow_carry):
        """Per-stage forward-KL (MLE) refit of the proposal flow on the
        post-resampling particle cloud — one ``lax.scan`` of Adam steps,
        warm-started from the previous stage (runs inside the stage jit)."""
        import optax

        n = particles.shape[0]
        batch = min(self._flow_batch, n)
        const = -0.5 * self.n_params * np.log(2.0 * np.pi)
        flow = self._flow

        def logq(params, xi):
            z, ld = flow.inverse(params, xi)
            return const - 0.5 * jnp.sum(z * z) + ld

        def step(carry, k):
            params, opt_state = carry
            idx = jax.random.randint(k, (batch,), 0, n)
            xb = jnp.take(particles, idx, axis=0)
            obj, grads = jax.value_and_grad(
                lambda p: jnp.mean(jax.vmap(lambda xi: logq(p, xi))(xb))
            )(params)
            updates, opt_state = self._flow_opt.update(
                jax.tree.map(lambda g: -g, grads), opt_state
            )
            params = optax.apply_updates(params, updates)
            return (params, opt_state), obj

        keys = jax.random.split(key, self._flow_fit_steps)
        flow_carry, _ = jax.lax.scan(step, flow_carry, keys)
        return flow_carry

    def _stage_impl(self, key, state: SMCState, flow_carry=None):
        state = self._constrain(state)
        beta_new = _find_next_beta(
            state.log_like, state.beta, self.target_ess, self.n
        )
        dbeta = beta_new - state.beta
        log_w = dbeta * state.log_like
        log_evidence = state.log_evidence + (
            jax.scipy.special.logsumexp(log_w) - jnp.log(float(self.n))
        )
        k_rs, k_mut, k_fit = jax.random.split(key, 3)

        # tempered target for mutation
        def tempered_batch(x):
            return jax.vmap(self.log_prior_fn)(x) + beta_new * jax.vmap(
                self.log_like_fn
            )(x)

        mover_state = self.mover.init_state(self.n_params, self.dtype)

        def make_mcmc_step(resampled):
            """Returns (step, init_carry, flow_carry'): ``step(red, black,
            carry, key) -> (red, black, carry)`` with a mode-specific carry
            (tempered logps; MALA also carries gradients so each step costs
            ONE value_and_grad sweep; flow also carries the proposal
            density log q so each step costs one flow forward + one
            tempered sweep). ``resampled`` is the post-resampling particle
            set the kernel parameters adapt to (measurable wrt the
            pre-mutation state — valid adaptive SMC)."""
            if self.mutation == "ensemble":

                def mcmc_step(red, black, carry, key):
                    lpr, lpb = carry
                    kr, kb = jax.random.split(key)
                    red, lpr, _ = self.mover.update_half(
                        kr, red, lpr, black, tempered_batch, mover_state
                    )
                    black, lpb, _ = self.mover.update_half(
                        kb, black, lpb, red, tempered_batch, mover_state
                    )
                    return red, black, (lpr, lpb)

                return (mcmc_step,
                        lambda red, black, lpr, lpb: (lpr, lpb),
                        flow_carry)

            if self.mutation == "flow":
                # refit the flow to this stage's cloud, then K
                # independence-MH steps proposing x' = f(z), z ~ N(0, I):
                # global moves whose acceptance uses the exact proposal
                # density log q(x) = log N(f⁻¹(x)) + log|det df⁻¹/dx|
                new_carry = self._fit_flow(k_fit, resampled, flow_carry)
                params = new_carry[0]
                flow = self._flow
                const = -0.5 * self.n_params * np.log(2.0 * np.pi)
                fwd = jax.vmap(lambda zi: flow.forward(params, zi))
                inv = jax.vmap(lambda xi: flow.inverse(params, xi))

                def half_update(key, x, lp0, lq0):
                    kz, ka = jax.random.split(key)
                    z = jax.random.normal(kz, x.shape, x.dtype)
                    y, logdet = fwd(z)
                    lq1 = const - 0.5 * jnp.sum(z * z, axis=1) - logdet
                    lp1 = tempered_batch(y)
                    log_ratio = lp1 - lp0 + lq0 - lq1
                    log_u = -jax.random.exponential(ka, lp0.shape, lp0.dtype)
                    acc = log_u < log_ratio
                    return (jnp.where(acc[:, None], y, x),
                            jnp.where(acc, lp1, lp0),
                            jnp.where(acc, lq1, lq0))

                def mcmc_step(red, black, carry, key):
                    (lpr, lqr), (lpb, lqb) = carry
                    kr, kb = jax.random.split(key)
                    red, lpr, lqr = half_update(kr, red, lpr, lqr)
                    black, lpb, lqb = half_update(kb, black, lpb, lqb)
                    return red, black, ((lpr, lqr), (lpb, lqb))

                def init_carry(red, black, lpr, lpb):
                    zr, ldr = inv(red)
                    zb, ldb = inv(black)
                    lqr = const - 0.5 * jnp.sum(zr * zr, axis=1) + ldr
                    lqb = const - 0.5 * jnp.sum(zb * zb, axis=1) + ldb
                    return ((lpr, lqr), (lpb, lqb))

                return mcmc_step, init_carry, new_carry

            def tempered_one(x):
                return (self.log_prior_fn(x)
                        + beta_new * self.log_like_fn(x))

            vg = jax.vmap(jax.value_and_grad(tempered_one))

            if self.mutation == "hmc":
                # ChEES-style fixed-shape HMC (see class docstring for
                # the validity argument — identical to MALA's): whitened
                # leapfrog with kinetic 0.5|u|², dx = ε·σ·u, du = ε·σ·∇,
                # per-particle ε jitter, whole-trajectory accept. The
                # (lp, grad) carry means each leapfrog step costs ONE
                # value_and_grad sweep.
                sd_h = jnp.maximum(jnp.std(resampled, axis=0), 1e-6)
                eps0 = self.hmc_scale * self.n_params ** (-0.25)
                ell = self.hmc_steps

                def half_update(key, x, lp0, g0):
                    kp, kj, ka = jax.random.split(key, 3)
                    u0 = jax.random.normal(kp, x.shape, x.dtype)
                    eps = eps0 * jax.random.uniform(
                        kj, (x.shape[0],), x.dtype, 0.5, 1.5
                    )
                    es = eps[:, None] * sd_h[None, :]
                    u = u0 + 0.5 * es * g0

                    def body(i, c):
                        xq, uq, lp, g = c
                        xq = xq + es * uq
                        lp, g = vg(xq)
                        w = jnp.where(i < ell - 1,
                                      jnp.asarray(1.0, x.dtype),
                                      jnp.asarray(0.5, x.dtype))
                        return (xq, uq + w * es * g, lp, g)

                    x1, u1, lp1, g1 = jax.lax.fori_loop(
                        0, ell, body, (x, u, lp0, g0)
                    )
                    log_ratio = lp1 - lp0 + 0.5 * (
                        jnp.sum(u0 * u0, axis=1) - jnp.sum(u1 * u1, axis=1)
                    )
                    log_u = -jax.random.exponential(
                        ka, lp0.shape, lp0.dtype
                    )
                    acc = log_u < log_ratio
                    return (jnp.where(acc[:, None], x1, x),
                            jnp.where(acc, lp1, lp0),
                            jnp.where(acc[:, None], g1, g0))

                def mcmc_step(red, black, carry, key):
                    (lpr, gr), (lpb, gb) = carry
                    kr, kb = jax.random.split(key)
                    red, lpr, gr = half_update(kr, red, lpr, gr)
                    black, lpb, gb = half_update(kb, black, lpb, gb)
                    return red, black, ((lpr, gr), (lpb, gb))

                def init_carry(red, black, lpr, lpb):
                    _, gr = vg(red)
                    _, gb = vg(black)
                    return ((lpr, gr), (lpb, gb))

                return mcmc_step, init_carry, flow_carry

            sd = jnp.std(resampled, axis=0)
            # preconditioned MALA on the tempered target; proposal sd per
            # dim from the post-resampling spread (constant through the
            # stage — a valid adaptive-SMC kernel, see class docstring).
            # The (lp, grad) pair is CARRIED between steps, so each step
            # costs one value_and_grad sweep (at the proposal), not two.
            s = (self.mala_scale * self.n_params ** (-1.0 / 6.0)
                 * jnp.maximum(sd, 1e-6))  # (P,)

            def half_update(key, x, lp0, g0):
                kp, ka = jax.random.split(key)
                noise = jax.random.normal(kp, x.shape, x.dtype)
                drift = 0.5 * (s**2)[None, :]
                y = x + drift * g0 + s[None, :] * noise
                lp1, g1 = vg(y)
                fwd = -0.5 * jnp.sum(
                    ((y - x - drift * g0) / s[None, :]) ** 2, axis=1
                )
                rev = -0.5 * jnp.sum(
                    ((x - y - drift * g1) / s[None, :]) ** 2, axis=1
                )
                log_ratio = lp1 - lp0 + rev - fwd
                log_u = -jax.random.exponential(ka, lp0.shape, lp0.dtype)
                acc = log_u < log_ratio
                return (jnp.where(acc[:, None], y, x),
                        jnp.where(acc, lp1, lp0),
                        jnp.where(acc[:, None], g1, g0))

            def mcmc_step(red, black, carry, key):
                (lpr, gr), (lpb, gb) = carry
                kr, kb = jax.random.split(key)
                red, lpr, gr = half_update(kr, red, lpr, gr)
                black, lpb, gb = half_update(kb, black, lpb, gb)
                return red, black, ((lpr, gr), (lpb, gb))

            def init_carry(red, black, lpr, lpb):
                # lpr/lpb hold the tempered logp already; only the
                # gradients need one initial sweep
                _, gr = vg(red)
                _, gb = vg(black)
                return ((lpr, gr), (lpb, gb))

            return mcmc_step, init_carry, flow_carry

        if self.waste_free_k is None:
            idx = systematic_resample(k_rs, log_w, self.n)
            particles = jnp.take(state.particles, idx, axis=0)
            lp = jnp.take(state.log_prior, idx)
            ll = jnp.take(state.log_like, idx)
            mcmc_step, init_carry, flow_carry = make_mcmc_step(particles)
            half = self.n // 2
            logp_t = lp + beta_new * ll
            carry0 = init_carry(
                particles[:half], particles[half:], logp_t[:half],
                logp_t[half:],
            )

            def mcmc_body(i, c):
                red, black, inner, key = c
                key, ks = jax.random.split(key)
                red, black, inner = mcmc_step(red, black, inner, ks)
                return red, black, inner, key

            red, black, _, _ = jax.lax.fori_loop(
                0, self.n_mcmc, mcmc_body,
                (particles[:half], particles[half:], carry0, k_mut),
            )
            particles = jnp.concatenate([red, black], axis=0)
        else:
            # waste-free: M seeds, keep all K intermediate ensembles
            # (Dau & Chopin 2022 — see module docstring)
            m = self.n // (self.waste_free_k + 1)
            idx = systematic_resample(k_rs, log_w, m)
            seeds = jnp.take(state.particles, idx, axis=0)
            lp_s = jnp.take(state.log_prior, idx)
            ll_s = jnp.take(state.log_like, idx)
            mcmc_step, init_carry, flow_carry = make_mcmc_step(seeds)
            half = m // 2
            logp_t = lp_s + beta_new * ll_s
            carry0 = init_carry(
                seeds[:half], seeds[half:], logp_t[:half], logp_t[half:]
            )

            def scan_body(carry, key):
                red, black, inner = carry
                red, black, inner = mcmc_step(red, black, inner, key)
                return (red, black, inner), jnp.concatenate(
                    [red, black], axis=0
                )

            keys = jax.random.split(k_mut, self.waste_free_k)
            _, visited = jax.lax.scan(
                scan_body,
                (seeds[:half], seeds[half:], carry0),
                keys,
            )  # visited: (K, m, P)
            particles = jnp.concatenate(
                [seeds, visited.reshape(-1, self.n_params)], axis=0
            )
        lp = jax.vmap(self.log_prior_fn)(particles)
        ll = jax.vmap(self.log_like_fn)(particles)
        # constrain the OUTPUT too: particles stay walker-sharded across
        # stages (multi-host processes then fetch only their local shard)
        return self._constrain(
            SMCState(particles, lp, ll, beta_new, log_evidence)
        ), flow_carry

    def run(self, max_stages=100):
        """Anneal β: 0 → 1. Returns self; particles then target the posterior.

        Warns (and stops) if the adaptive β step stalls (float32 ulp near a
        very peaked likelihood) or ``max_stages`` is exhausted before β
        reaches 1 — check ``state.beta`` before trusting the particles.
        """
        import warnings

        if self.state is None:
            self.init()
        for _ in range(max_stages):
            if float(self.state.beta) >= 1.0:
                break
            beta_before = float(self.state.beta)
            self._key, k = jax.random.split(self._key)
            self.state, self._flow_carry = self._stage(
                k, self.state, self._flow_carry
            )
            self.n_stages += 1
            beta_now = float(self.state.beta)
            self.beta_ladder.append(beta_now)
            if beta_now <= beta_before:
                warnings.warn(
                    f"SMC tempering stalled at beta={beta_now:.6g} (ESS "
                    f"target unreachable within float precision); particles "
                    f"target the INTERMEDIATE distribution, log_evidence is "
                    f"partial. Lower target_ess or increase n_particles."
                )
                return self
        if float(self.state.beta) < 1.0:
            warnings.warn(
                f"SMC exhausted max_stages={max_stages} at beta="
                f"{float(self.state.beta):.4g} < 1; increase max_stages."
            )
        return self

    @property
    def particles(self):
        """Current particle set — under multi-host SPMD, the LOCAL
        particle-axis shard (multi-host-safe fetch; replicated scalars
        like ``log_evidence`` stay global)."""
        from mcmcpp_tpu.chain import fetch_addressable

        return fetch_addressable(self.state.particles, walker_axis=0)

    @property
    def log_evidence(self):
        """log Z estimate (likelihood normalizing constant)."""
        return float(self.state.log_evidence)
