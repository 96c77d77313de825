"""Hamiltonian Monte Carlo, vmapped over chains, scan-driven.

One chain's transition is a pure function (leapfrog integration under
``lax.scan`` + Metropolis correction); many chains run as a vmapped batch
whose chain axis shards over the device mesh like the ensemble walker axis.
Warmup adapts a PER-CHAIN step size by dual averaging (the Hoffman–Gelman
2014 §3.2 schedule vectorized over the chain axis — a chain initialized in
a difficult region adapts its own step instead of dragging a shared one
down) and a shared mass matrix by Welford accumulation over all chains'
positions: ``metric="diag"`` (default) estimates per-parameter variances,
``metric="dense"`` the full posterior covariance (Stan's diag_e/dense_e;
see gradient/metric.py for the four primitives kernels are written
against).

No counterpart exists in the reference (gradient-free C++ library,
cf. ``MCMCpp/Utility/UserOjbectsTest.h:144-151`` black-box Calculator
contract); this is north-star scope. Chain store / analysis layers are
shared with the ensemble sampler.
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from mcmcpp_tpu.chain import Chain, append_device_chunk
from mcmcpp_tpu.gradient.metric import (
    dense_mass_from_cov,
    mass_kinetic,
    mass_momentum,
    mass_velocity,
)


# energy-error threshold marking a transition divergent (Stan's default):
# the leapfrog has left the region where the integrator is stable, a
# geometry signal ArviZ surfaces as ``sample_stats.diverging``
DIVERGENCE_THRESHOLD = 1000.0


class HMCState(NamedTuple):
    position: jax.Array  # (C, P)
    logp: jax.Array  # (C,)
    grad: jax.Array  # (C, P)


class DualAveragingState(NamedTuple):
    log_step: jax.Array
    log_step_avg: jax.Array
    h_sum: jax.Array
    mu: jax.Array
    count: jax.Array


class WelfordState(NamedTuple):
    mean: jax.Array
    m2: jax.Array
    count: jax.Array


def _leapfrog(logp_grad_fn, position, momentum, grad, inv_mass, step_size, n_steps):
    """Leapfrog with half-step kicks fused at segment ends; scan over steps."""

    def body(carry, _):
        q, p, g = carry
        p = p + 0.5 * step_size * g
        q = q + step_size * mass_velocity(inv_mass, p)
        lp, g = logp_grad_fn(q)
        p = p + 0.5 * step_size * g
        return (q, p, g), lp

    (q, p, g), lps = jax.lax.scan(body, (position, momentum, grad), length=n_steps)
    return q, p, lps[-1], g


def hmc_kernel(logp_fn, n_leapfrog):
    """One-chain HMC transition.

    Returns ``kernel(key, q, logp, grad, step_size, inv_mass) ->
    ((q, logp, grad), (accept_prob, accepted, diverging, energy))``.
    ``inv_mass`` is the diagonal inverse mass matrix (P,) or a
    DenseMassMatrix. ``energy`` is the Hamiltonian after the momentum
    refresh (an exact draw from the energy marginal at the current
    position — the E-BFMI statistic ArviZ expects).
    """
    logp_grad_fn = jax.value_and_grad(logp_fn)

    def kernel(key, position, logp, grad, step_size, inv_mass):
        k_mom, k_acc = jax.random.split(key)
        # momentum ~ N(0, M) with M⁻¹ = inv_mass
        z = jax.random.normal(k_mom, position.shape, position.dtype)
        momentum = mass_momentum(inv_mass, z)
        kinetic0 = mass_kinetic(inv_mass, momentum)
        energy = kinetic0 - logp
        q, p, lp_new, g_new = _leapfrog(
            logp_grad_fn, position, momentum, grad, inv_mass, step_size, n_leapfrog
        )
        kinetic1 = mass_kinetic(inv_mass, p)
        log_ratio = (lp_new - kinetic1) - (logp - kinetic0)
        log_ratio = jnp.where(jnp.isnan(log_ratio), -jnp.inf, log_ratio)
        diverging = log_ratio < -DIVERGENCE_THRESHOLD
        accept_prob = jnp.minimum(1.0, jnp.exp(log_ratio))
        log_u = -jax.random.exponential(k_acc, (), position.dtype)
        accept = log_u < log_ratio
        position = jnp.where(accept, q, position)
        logp = jnp.where(accept, lp_new, logp)
        grad = jnp.where(accept, g_new, grad)
        return (position, logp, grad), (accept_prob, accept, diverging, energy)

    return kernel


# -- dual averaging (Hoffman & Gelman 2014, §3.2; vectorizes over chains) ----


def da_init(step_size):
    log_step = jnp.log(step_size)
    return DualAveragingState(
        log_step=log_step,
        log_step_avg=log_step,
        h_sum=jnp.zeros_like(log_step),
        mu=jnp.log(10.0) + log_step,
        count=jnp.zeros((), jnp.int32),
    )


def da_update(da: DualAveragingState, accept_prob, target=0.8,
              gamma=0.05, t0=10.0, kappa=0.75):
    count = da.count + 1
    tf = count.astype(da.log_step.dtype)
    h_sum = da.h_sum + (target - accept_prob)
    log_step = da.mu - (jnp.sqrt(tf) / gamma) * h_sum / (tf + t0)
    eta = tf ** (-kappa)
    log_step_avg = eta * log_step + (1 - eta) * da.log_step_avg
    return DualAveragingState(log_step, log_step_avg, h_sum, da.mu, count)


# -- Welford moments (batched over chains; diag variance or full cov) --------


def welford_init(shape, dtype):
    """``shape=(P,)`` accumulates per-parameter variance; ``shape=(P, P)``
    accumulates the full scatter matrix for the dense metric."""
    p = shape[0]
    return WelfordState(
        mean=jnp.zeros((p,), dtype),
        m2=jnp.zeros(shape, dtype),
        count=jnp.zeros((), jnp.int32),
    )


def welford_update_batch(w: WelfordState, x):
    """Fold a whole (C, P) batch into the running moments (Chan et al.).

    Dispatches on the accumulator rank: ``m2`` of rank 1 tracks diagonal
    second moments, rank 2 the full scatter matrix (one (C,P)ᵀ(C,P)
    matmul per warmup step, shared across chains).
    """
    c = x.shape[0]
    count = w.count + c
    batch_mean = jnp.mean(x, axis=0)
    centered = x - batch_mean
    delta = batch_mean - w.mean
    nf = count.astype(x.dtype)
    wf = w.count.astype(x.dtype)
    mean = w.mean + delta * (c / nf)
    if w.m2.ndim == 2:
        batch_m2 = centered.T @ centered
        m2 = w.m2 + batch_m2 + jnp.outer(delta, delta) * (wf * c / nf)
    else:
        batch_m2 = jnp.sum(centered**2, axis=0)
        m2 = w.m2 + batch_m2 + delta**2 * (wf * c / nf)
    return WelfordState(mean, m2, count)


def welford_variance(w: WelfordState, regularize=True):
    n = jnp.maximum(w.count - 1, 1).astype(w.m2.dtype)
    var = w.m2 / n
    if regularize:  # Stan-style shrinkage toward 1e-3 at small counts
        c = w.count.astype(w.m2.dtype)
        var = (c / (c + 5.0)) * var + 1e-3 * (5.0 / (c + 5.0))
    return var


def welford_covariance(w: WelfordState, regularize=True):
    """Covariance estimate from a rank-2 accumulator, with Stan's
    dense_e shrinkage toward 1e-3·I at small counts (keeps the Cholesky
    well-posed before the estimate stabilizes)."""
    n = jnp.maximum(w.count - 1, 1).astype(w.m2.dtype)
    cov = w.m2 / n
    if regularize:
        c = w.count.astype(w.m2.dtype)
        eye = jnp.eye(cov.shape[0], dtype=cov.dtype)
        cov = (c / (c + 5.0)) * cov + 1e-3 * (5.0 / (c + 5.0)) * eye
    return cov


class GradientSampler:
    """Shared driver for vmapped gradient kernels (HMC/NUTS/MALA subclasses).

    ``logp_fn`` maps (P,) -> scalar. ``n_chains`` chains run as one vmapped
    batch. ``warmup`` adapts; ``run`` samples into the shared host Chain.
    """

    needs_mass = True

    def __init__(self, logp_fn, n_chains, n_params, seed=0, dtype=jnp.float32,
                 step_size=0.1, target_accept=0.8, max_chain_bytes=2 << 30,
                 mesh=None, chain=None, metric="diag"):
        self.logp_fn = logp_fn
        self.n_chains = int(n_chains)
        self.n_params = int(n_params)
        self.dtype = dtype
        self.step_size = float(step_size)
        self.target_accept = float(target_accept)
        self._key = jax.random.key(seed)
        if metric not in ("diag", "dense"):
            raise ValueError(f"metric must be 'diag' or 'dense', got {metric!r}")
        self.metric = metric
        if metric == "dense":
            self.inv_mass = dense_mass_from_cov(
                jnp.eye(self.n_params, dtype=dtype)
            )
        else:
            self.inv_mass = jnp.ones((self.n_params,), dtype)
        self.state = None
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
        # optional chains-axis sharding: the vmapped chain batch distributes
        # over the mesh exactly like the ensemble walker axis (see
        # parallel/mesh.py); scalars (step size, mass) stay replicated
        self.mesh = mesh
        self._chain_sharding = None
        if mesh is not None:
            from mcmcpp_tpu.parallel.mesh import walker_sharding

            if self.n_chains % mesh.size != 0:
                raise ValueError(
                    f"n_chains={self.n_chains} not divisible by mesh size "
                    f"{mesh.size}"
                )
            self._chain_sharding = walker_sharding(mesh)
        self._kernel = self._make_kernel()
        self._step = self._batched_step(self._kernel)
        self._run_cache = {}
        self._warmup_cache = {}
        self.last_mean_accept = None
        # per-stored-step sample stats, appended per fetched chunk
        self._divergences = []  # list of (S_chunk, C) bool
        self._energies = []  # list of (S_chunk, C) dtype

    def _make_kernel(self):
        """Subclass hook: (key, q, lp, g, step_size, inv_mass) -> (s3, info)."""
        raise NotImplementedError

    def _constrain(self, state):
        if self._chain_sharding is None:
            return state
        from mcmcpp_tpu.parallel.mesh import vector_sharding

        vec = vector_sharding(self._chain_sharding)
        c = lambda x: jax.lax.with_sharding_constraint(x, self._chain_sharding)
        v = lambda x: jax.lax.with_sharding_constraint(x, vec)
        return HMCState(c(state.position), v(state.logp), c(state.grad))

    def _batched_step(self, kernel):
        def step(key, state, step_size, inv_mass):
            state = self._constrain(state)
            keys = jax.random.split(key, self.n_chains)
            step_vec = jnp.broadcast_to(step_size, (self.n_chains,))
            (q, lp, g), (ap, acc, div, en) = jax.vmap(
                lambda k, q, lp, g, ss: kernel(k, q, lp, g, ss, inv_mass)
            )(keys, state.position, state.logp, state.grad, step_vec)
            return self._constrain(HMCState(q, lp, g)), (ap, acc, div, en)

        return step

    # -- init ----------------------------------------------------------------

    def init(self, positions):
        positions = jnp.asarray(positions, self.dtype)
        if positions.shape != (self.n_chains, self.n_params):
            raise ValueError(f"positions must be ({self.n_chains}, {self.n_params})")
        if self._chain_sharding is not None:
            positions = jax.device_put(positions, self._chain_sharding)
        lp, g = jax.vmap(jax.value_and_grad(self.logp_fn))(positions)
        self.state = HMCState(positions, lp, g)
        return self

    def init_ball(self, center, scale=1.0, seed=None):
        key = self._key if seed is None else jax.random.key(seed)
        key = jax.random.fold_in(key, 0xD06)
        center = jnp.asarray(center, self.dtype)
        z = jax.random.normal(key, (self.n_chains, self.n_params), self.dtype)
        return self.init(center[None, :] + scale * z)

    # -- warmup ----------------------------------------------------------------

    def _welford_init(self):
        p = self.n_params
        shape = (p, p) if self.metric == "dense" else (p,)
        return welford_init(shape, self.dtype)

    def _mass_from_welford(self, wf):
        """Current mass-matrix estimate from the Welford accumulator
        (rebuilt each warmup step so early steps use the shrunk prior)."""
        if self.metric == "dense":
            return dense_mass_from_cov(welford_covariance(wf))
        return welford_variance(wf)

    def warmup(self, n_steps, adapt_mass=True):
        """Adapt step size (dual averaging) and the mass matrix (Welford
        variances for ``metric="diag"``, full covariance for ``"dense"``)."""
        if self.state is None:
            raise RuntimeError("call init/init_ball first")
        adapt_mass = bool(adapt_mass and self.needs_mass)
        fn = self._warmup_cache.get((int(n_steps), adapt_mass))
        if fn is None:
            fn = jax.jit(
                lambda state, key, step0, im0: self._warmup_scan(
                    state, key, step0, im0, int(n_steps), adapt_mass
                )
            )
            self._warmup_cache[(int(n_steps), adapt_mass)] = fn
        self._key, run_key = jax.random.split(self._key)
        step0 = jnp.broadcast_to(
            jnp.asarray(self.step_size, self.dtype), (self.n_chains,)
        )
        state, log_step_avg, inv_mass = fn(
            self.state, run_key, step0, self.inv_mass
        )
        self.state = jax.block_until_ready(state)
        # per-chain adapted step sizes (a chain initialized in a hard region
        # adapts its own step instead of dragging a shared one down)
        self.step_size = jnp.exp(log_step_avg)
        self.inv_mass = inv_mass
        return self

    def _warmup_scan(self, state, key, step0, im0, n_steps, adapt_mass):
        step = self._step

        def body(carry, _):
            state, da, wf, key = carry
            key, sub = jax.random.split(key)
            inv_mass = self._mass_from_welford(wf) if adapt_mass else im0
            state, (ap, *_) = step(sub, state, jnp.exp(da.log_step), inv_mass)
            da = da_update(da, ap, target=self.target_accept)
            if adapt_mass:
                wf = welford_update_batch(wf, state.position)
            return (state, da, wf, key), None

        da = da_init(step0)
        wf = self._welford_init()
        (state, da, wf, _), _ = jax.lax.scan(
            body, (state, da, wf, key), length=n_steps
        )
        inv_mass = self._mass_from_welford(wf) if adapt_mass else im0
        return state, da.log_step_avg, inv_mass

    # -- sampling ---------------------------------------------------------------

    def _run_scan(self, state, key, step_size, inv_mass, n_store, thin):
        step = self._step

        def body(carry, _):
            state, key = carry
            zeros_c = jnp.zeros((self.n_chains,), jnp.bool_)

            def inner(j, sk):
                s, k, a, d, _ = sk
                k, sub = jax.random.split(k)
                s, (ap, _, div, en) = step(sub, s, step_size, inv_mass)
                # any divergence within the thin window flags the stored
                # step; energy is the last substep's refresh draw
                return (s, k, a + jnp.mean(ap), d | div, en)

            state, key, acc, div, en = jax.lax.fori_loop(
                0, thin, inner,
                (state, key, jnp.zeros((), self.dtype), zeros_c,
                 jnp.zeros((self.n_chains,), self.dtype)),
            )
            return (state, key), (state.position, state.logp, acc / thin,
                                  div, en)

        (state, _), (pos, lp, acc, div, en) = jax.lax.scan(
            body, (state, key), length=n_store
        )
        return state, pos, lp, jnp.mean(acc), div, en

    def _store_chunk_steps(self):
        """Bound each scan's device-side output to ~64 MiB (like the
        ensemble sampler's store_chunk_steps)."""
        from mcmcpp_tpu.chain import default_chunk_steps

        return default_chunk_steps(self.n_chains, self.n_params, self.dtype)

    def _get_run_fn(self, take, thin):
        fn = self._run_cache.get((take, thin))
        if fn is None:
            fn = jax.jit(
                lambda state, key, ss, im, t=take, th=thin: self._run_scan(
                    state, key, ss, im, t, th
                )
            )
            self._run_cache[(take, thin)] = fn
        return fn

    def run(self, n_steps, thin=1, checkpoint_path=None, checkpoint_every=1):
        """Sample ``n_steps`` post-warmup transitions, storing every thin-th.

        Returns True, or False if the host chain hit its byte capacity
        (subsequent samples are NOT silently dropped). ``n_steps % thin``
        leftover steps still advance the state (unstored), matching the
        ensemble sampler.

        The store loop pipelines like the ensemble driver (sampler.py):
        chunk k is launched before chunk k-1's device->host fetch, so long
        NUTS runs overlap compute with the D2H copy instead of blocking on
        ``np.asarray`` per chunk. Under multi-host SPMD each process stores
        only its chain-axis shard (chain.append_device_chunk).

        ``checkpoint_path``: if set, a full resumable checkpoint
        (io.checkpoint) is written after every ``checkpoint_every`` chunks,
        with the pipeline drained first so the snapshot is exactly
        consistent (state == chain == stats); saves are atomic.
        """
        if self.state is None:
            raise RuntimeError("call init/init_ball first")
        thin = int(thin)
        n_store = int(n_steps) // thin
        leftover = int(n_steps) - n_store * thin
        step_vec = jnp.broadcast_to(
            jnp.asarray(self.step_size, self.dtype), (self.n_chains,)
        )
        from mcmcpp_tpu.chain import fetch_addressable, run_pipelined

        chunk = self._store_chunk_steps()
        acc_sum, acc_n = 0.0, 0

        def launch(take):
            fn = self._get_run_fn(take, thin)
            self._key, run_key = jax.random.split(self._key)
            self.state, pos, lp, acc, div, en = fn(
                self.state, run_key, step_vec, self.inv_mass
            )
            return (pos, lp, acc, div, en, take)

        def fetch(chunk_data):
            nonlocal acc_sum, acc_n
            p_pos, p_lp, p_acc, p_div, p_en, p_take = chunk_data
            before = self.chain.n_steps
            self.chain, appended = append_device_chunk(self.chain, p_pos, p_lp)
            # stats stay exactly chain-aligned even through a partial
            # (cap-truncated) append: keep only the rows the chain took
            took = self.chain.n_steps - before
            self._divergences.append(
                fetch_addressable(p_div, walker_axis=1)[:took]
            )
            self._energies.append(
                fetch_addressable(p_en, walker_axis=1)[:took]
            )
            acc_sum += float(p_acc) * p_take
            acc_n += p_take
            return appended

        def on_drop(launched):
            # the launched chunk still advanced the state; keep its
            # acceptance statistics even though it can't be stored
            nonlocal acc_sum, acc_n
            acc_sum += float(launched[2]) * launched[-1]
            acc_n += launched[-1]

        checkpoint_save = None
        if checkpoint_path is not None:
            from mcmcpp_tpu.io.checkpoint import save_checkpoint

            checkpoint_save = lambda: save_checkpoint(self, checkpoint_path)

        ok = run_pipelined(
            n_store, chunk, launch, fetch, on_drop=on_drop,
            checkpoint_save=checkpoint_save, checkpoint_every=checkpoint_every,
        )
        if ok and leftover:
            fn = self._get_run_fn(1, leftover)
            self._key, run_key = jax.random.split(self._key)
            state, _, _, acc, _, _ = fn(
                self.state, run_key, step_vec, self.inv_mass
            )
            self.state = state
            acc_sum += float(acc)
            acc_n += 1
        if acc_n:
            self.last_mean_accept = acc_sum / acc_n
        if ok and checkpoint_path is not None:
            from mcmcpp_tpu.io.checkpoint import save_checkpoint

            save_checkpoint(self, checkpoint_path)  # final snapshot
        return ok

    def get_samples(self, burn_in=0, thin=1, flat=False):
        return self.chain.get(burn_in=burn_in, thin=thin, flat=flat)

    def get_log_probs(self, burn_in=0, thin=1, flat=False):
        return self.chain.get_logp(burn_in=burn_in, thin=thin, flat=flat)

    def get_sample_stats(self, burn_in=0, thin=1):
        """Per-stored-step geometry diagnostics, sliced like
        :meth:`get_samples`: ``diverging`` (S, C) bool — any divergent
        transition (energy error beyond DIVERGENCE_THRESHOLD, Stan's
        criterion) inside the step's thin window — and ``energy`` (S, C),
        the post-refresh Hamiltonian whose lag-1 variance ratio is the
        E-BFMI statistic. Consumed by ``export.to_inference_dict`` into
        the ArviZ ``sample_stats`` group."""
        if self._divergences:
            div = np.concatenate(self._divergences, axis=0)
            en = np.concatenate(self._energies, axis=0)
        else:
            div = np.zeros((0, self.n_chains), bool)
            en = np.zeros((0, self.n_chains), np.float32)
        n = self.chain.n_steps  # cap-truncated chunks store fewer rows
        return {
            "diverging": div[:n][burn_in::thin],
            "energy": en[:n][burn_in::thin],
        }

    @property
    def divergence_count(self):
        """Total stored-step divergences per chain, (C,) int64."""
        stats = self.get_sample_stats()
        return stats["diverging"].sum(axis=0)


class HMCSampler(GradientSampler):
    """HMC with fixed leapfrog length ``n_leapfrog`` and adapted step size."""

    def __init__(self, *args, n_leapfrog=16, **kwargs):
        self.n_leapfrog = int(n_leapfrog)
        super().__init__(*args, **kwargs)

    def _make_kernel(self):
        return hmc_kernel(self.logp_fn, self.n_leapfrog)
