"""ChEES-HMC: gradient-adapted trajectory lengths, accelerator-shaped.

Hoffman, Radul & Sountsov (2021, AISTATS) "An Adaptive-MCMC Scheme for
Setting Trajectory Lengths in Hamiltonian Monte Carlo". NUTS's recursive
tree is a poor fit for XLA (dynamic per-chain control flow, worst-case
2^depth gradient evaluations); ChEES-HMC instead runs PLAIN fixed-length
HMC whose trajectory length is adapted by maximizing the Change in the
Estimator of the Expected Square criterion

    ChEES(T) = 1/4 E[ (||q' - E q'||^2 - ||q - E q||^2)^2 ]

with a one-dimensional Adam ascent on log T. Every chain in the batch
shares the SAME jittered trajectory each iteration, so the leapfrog loop
has a single (dynamic) trip count for the whole ``(C, P)`` batch — one
compiled program, no per-chain shape divergence, and the cross-chain
means the criterion needs are just batch reductions (``psum`` when the
chain axis is mesh-sharded).

Jitter: trajectory time t = 2·u·T with u from the base-2 van der Corput
(Halton) sequence during warmup (low-discrepancy → low-variance
adaptation gradients) and u ~ U(0,1) during sampling (breaks integrator
resonances; any iid jitter preserves the stationary distribution).

No reference counterpart (the C++ library is gradient-free,
``MCMCpp/Utility/UserOjbectsTest.h:144-151``) — north-star scope.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mcmcpp_tpu.gradient.hmc import (
    GradientSampler,
    HMCState,
    da_init,
    da_update,
    welford_update_batch,
)
from mcmcpp_tpu.gradient.metric import (
    mass_kinetic,
    mass_momentum,
    mass_velocity,
)


class AdamState(NamedTuple):
    m: jax.Array
    v: jax.Array
    count: jax.Array


def adam_init(dtype):
    z = jnp.zeros((), dtype)
    return AdamState(m=z, v=z, count=jnp.zeros((), jnp.int32))


def adam_step(a: AdamState, grad, lr=0.025, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step; returns (delta_to_ADD_for_ascent, new_state)."""
    count = a.count + 1
    m = b1 * a.m + (1 - b1) * grad
    v = b2 * a.v + (1 - b2) * grad**2
    tf = count.astype(m.dtype)
    mhat = m / (1 - b1**tf)
    vhat = v / (1 - b2**tf)
    return lr * mhat / (jnp.sqrt(vhat) + eps), AdamState(m, v, count)


def halton2(i):
    """Base-2 van der Corput radical inverse of int32 ``i`` in [0, 1)."""
    b = i.astype(jnp.uint32)
    b = ((b & 0x55555555) << 1) | ((b >> 1) & 0x55555555)
    b = ((b & 0x33333333) << 2) | ((b >> 2) & 0x33333333)
    b = ((b & 0x0F0F0F0F) << 4) | ((b >> 4) & 0x0F0F0F0F)
    b = ((b & 0x00FF00FF) << 8) | ((b >> 8) & 0x00FF00FF)
    b = ((b & 0x0000FFFF) << 16) | ((b >> 16) & 0x0000FFFF)
    # offset half an ulp so i=0 doesn't yield a zero-length trajectory
    return (b.astype(jnp.float32) + 0.5) * jnp.float32(2.0**-32)


def chees_batch_step(logp_fn, max_leapfrog=1024):
    """Build the whole-batch ChEES-HMC transition.

    Returns ``step(key, state, eps, inv_mass, traj_len, u) ->
    (state, info)`` operating on the full ``(C, P)`` batch. ``u`` in (0, 1)
    jitters the trajectory time to ``2·u·traj_len``; the leapfrog count
    ``ceil(t/eps)`` is a traced value shared by every chain (lowered to a
    single ``while_loop``). ``info`` carries per-chain accept stats and the
    ChEES trajectory-length gradient estimate.
    """
    batch_lp_grad = jax.vmap(jax.value_and_grad(logp_fn))
    cap = int(max_leapfrog)

    def step(key, state, eps, inv_mass, traj_len, u):
        q0, lp0, g0 = state.position, state.logp, state.grad
        k_mom, k_acc = jax.random.split(key)
        z = jax.random.normal(k_mom, q0.shape, q0.dtype)
        p0 = mass_momentum(inv_mass, z)
        kin0 = mass_kinetic(inv_mass, p0)

        t = 2.0 * u * traj_len
        n_leap = jnp.clip(jnp.ceil(t / eps).astype(jnp.int32), 1, cap)

        def body(carry):
            i, q, p, lp, g = carry
            p = p + 0.5 * eps * g
            q = q + eps * mass_velocity(inv_mass, p)
            lp, g = batch_lp_grad(q)
            p = p + 0.5 * eps * g
            return i + 1, q, p, lp, g

        _, q1, p1, lp1, g1 = jax.lax.while_loop(
            lambda c: c[0] < n_leap, body, (jnp.int32(0), q0, p0, lp0, g0)
        )

        kin1 = mass_kinetic(inv_mass, p1)
        log_ratio = (lp1 - kin1) - (lp0 - kin0)
        log_ratio = jnp.where(jnp.isnan(log_ratio), -jnp.inf, log_ratio)
        from mcmcpp_tpu.gradient.hmc import DIVERGENCE_THRESHOLD

        diverging = log_ratio < -DIVERGENCE_THRESHOLD
        energy = kin0 - lp0  # post-refresh Hamiltonian (E-BFMI statistic)
        accept_prob = jnp.minimum(1.0, jnp.exp(log_ratio))
        log_un = -jax.random.exponential(k_acc, lp0.shape, q0.dtype)
        accept = log_un < log_ratio
        q = jnp.where(accept[:, None], q1, q0)
        lp = jnp.where(accept, lp1, lp0)
        g = jnp.where(accept[:, None], g1, g0)

        # ChEES dT gradient estimate (paper eq. 6, acceptance-weighted):
        # centered squared-radius change x end-point velocity projection.
        # dt/dT ∝ u is folded in; Adam makes the constant factor moot.
        mu0 = jnp.mean(q0, axis=0)
        mu1 = jnp.mean(q1, axis=0)
        d0 = q0 - mu0[None, :]
        d1 = q1 - mu1[None, :]
        delta = jnp.sum(d1**2, axis=1) - jnp.sum(d0**2, axis=1)
        vel_proj = jnp.sum(d1 * mass_velocity(inv_mass, p1), axis=1)
        wsum = jnp.sum(accept_prob)
        per_chain = accept_prob * u * delta * vel_proj
        traj_grad = jnp.where(wsum > 0, jnp.sum(per_chain) / (wsum + 1e-20), 0.0)

        return HMCState(q, lp, g), (
            accept_prob, accept, traj_grad, n_leap, diverging, energy
        )

    return step


class CheesHMCSampler(GradientSampler):
    """HMC with ChEES-adapted trajectory length and jittered trajectories.

    Warmup jointly adapts: a SHARED step size by dual averaging on the
    harmonic-mean acceptance (the paper's choice — dominated by the worst
    chains; default target 0.651, the jittered-HMC optimum), the log
    trajectory length by Adam ascent on the ChEES gradient, and the
    diagonal mass matrix by Welford (shared with HMC/NUTS). Sampling then
    runs fixed-``traj_length`` jittered HMC — or, with
    ``continuous_adapt=True``, keeps adapting log T during sampling with
    a diminishing Adam rate ``adam_lr·(1 + t/adapt_t0)^-adapt_kappa``
    (kappa in (0.5, 1] satisfies the Roberts & Rosenthal 2007
    diminishing-adaptation conditions, so the chain stays ergodic;
    useful when warmup was short or the typical set drifts).
    """

    def __init__(self, logp_fn, n_chains, n_params, seed=0,
                 target_accept=0.651, init_traj_length=None,
                 max_leapfrog=1024, adam_lr=0.025, continuous_adapt=False,
                 adapt_kappa=0.6, adapt_t0=100.0, **kwargs):
        self.max_leapfrog = int(max_leapfrog)
        self.adam_lr = float(adam_lr)
        self.continuous_adapt = bool(continuous_adapt)
        self.adapt_kappa = float(adapt_kappa)
        self.adapt_t0 = float(adapt_t0)
        self._init_traj = init_traj_length
        self.traj_length = None  # set by warmup (or defaulted at first run)
        self._sadapt = None  # (log_traj, AdamState) when continuous_adapt
        super().__init__(logp_fn, n_chains, n_params, seed=seed,
                         target_accept=target_accept, **kwargs)

    def _make_kernel(self):
        return chees_batch_step(self.logp_fn, self.max_leapfrog)

    def _batched_step(self, kernel):
        # the ChEES kernel is already whole-batch; adapt it to the base
        # class's (key, state, step_size, inv_mass) shape for reuse paths
        def step(key, state, step_size, inv_mass):
            state = self._constrain(state)
            k_jit, k_step = jax.random.split(key)
            u = jax.random.uniform(k_jit, (), state.position.dtype)
            eps = jnp.mean(step_size)
            traj = jnp.asarray(self._traj_or_default(), state.position.dtype)
            state, (ap, acc, _, _, div, en) = kernel(
                k_step, state, eps, inv_mass, traj, u
            )
            return self._constrain(state), (ap, acc, div, en)

        return step

    def _traj_or_default(self):
        if self.traj_length is not None:
            return self.traj_length
        if self._init_traj is not None:
            return float(self._init_traj)
        # one ~16-step trajectory at the current step size
        return 16.0 * float(jnp.mean(jnp.asarray(self.step_size)))

    # -- warmup: joint (eps, T, mass) adaptation -----------------------------

    def warmup(self, n_steps, adapt_mass=True):
        if self.state is None:
            raise RuntimeError("call init/init_ball first")
        adapt_mass = bool(adapt_mass and self.needs_mass)
        fn = self._warmup_cache.get((int(n_steps), adapt_mass))
        if fn is None:
            fn = jax.jit(
                lambda state, key, eps0, t0, im0: self._chees_warmup_scan(
                    state, key, eps0, t0, im0, int(n_steps), adapt_mass
                )
            )
            self._warmup_cache[(int(n_steps), adapt_mass)] = fn
        self._key, run_key = jax.random.split(self._key)
        eps0 = jnp.asarray(float(jnp.mean(jnp.asarray(self.step_size))), self.dtype)
        t0 = jnp.asarray(self._traj_or_default(), self.dtype)
        state, log_eps_avg, log_traj_avg, inv_mass = fn(
            self.state, run_key, eps0, t0, self.inv_mass
        )
        self.state = jax.block_until_ready(state)
        self.step_size = jnp.exp(log_eps_avg)  # shared scalar
        self.traj_length = float(jnp.exp(log_traj_avg))
        # the jitted run programs bake traj_length in at trace time
        self._run_cache.clear()
        # continuous adaptation restarts from the fresh warmup result
        self._sadapt = None
        self.inv_mass = inv_mass
        return self

    def _chees_warmup_scan(self, state, key, eps0, t0, im0, n_steps, adapt_mass):
        kernel = self._kernel
        dt = self.dtype

        def body(carry, i):
            state, da, adam, log_traj, log_traj_avg, wf, key = carry
            key, sub = jax.random.split(key)
            eps = jnp.exp(da.log_step)
            inv_mass = self._mass_from_welford(wf) if adapt_mass else im0
            u = halton2(i)
            state = self._constrain(state)
            state, (ap, _, traj_grad, _, _, _) = kernel(
                sub, state, eps, inv_mass, jnp.exp(log_traj), u
            )
            # harmonic-mean acceptance: dominated by the worst chains
            hm_accept = 1.0 / jnp.mean(1.0 / jnp.maximum(ap, 1e-10))
            da = da_update(da, hm_accept, target=self.target_accept)
            # Adam ascent on log T, then iterate-average like dual averaging
            delta, adam = adam_step(adam, traj_grad * jnp.exp(log_traj),
                                    lr=self.adam_lr)
            lo = da.log_step  # T below one step is meaningless
            hi = da.log_step + jnp.log(float(self.max_leapfrog))
            log_traj = jnp.clip(log_traj + delta, lo, hi)
            eta = (adam.count.astype(dt)) ** -0.75
            log_traj_avg = eta * log_traj + (1 - eta) * log_traj_avg
            if adapt_mass:
                wf = welford_update_batch(wf, state.position)
            return (state, da, adam, log_traj, log_traj_avg, wf, key), None

        da = da_init(eps0)
        adam = adam_init(dt)
        log_t = jnp.log(t0)
        wf = self._welford_init()
        (state, da, adam, log_t, log_t_avg, wf, _), _ = jax.lax.scan(
            body, (state, da, adam, log_t, log_t, wf, key),
            jnp.arange(n_steps, dtype=jnp.int32),
        )
        inv_mass = self._mass_from_welford(wf) if adapt_mass else im0
        return state, da.log_step_avg, log_t_avg, inv_mass

    # -- sampling: the base run() drives this via self._step -----------------

    def current_traj_length(self):
        """Trajectory length in effect now (tracks ``continuous_adapt``)."""
        if self.continuous_adapt and self._sadapt is not None:
            return float(jnp.exp(self._sadapt[0]))
        return self._traj_or_default()

    def _get_run_fn(self, take, thin):
        """With ``continuous_adapt``, the jitted program takes the
        adaptation state as an ARGUMENT (a closure would bake the traced
        value in at compile time and never move) and the wrapper writes
        the updated state back — still async, so the base run()'s
        pipelined store loop is undisturbed (Roberts & Rosenthal 2007
        diminishing adaptation: per-step rate ``adam_lr·t^-kappa`` with
        kappa in (0.5, 1] keeps the chain ergodic)."""
        if not self.continuous_adapt:
            return super()._get_run_fn(take, thin)
        key = ("cadapt", take, thin)
        fn = self._run_cache.get(key)
        if fn is None:
            fn = jax.jit(
                lambda state, k, ss, im, ad, t=take, th=thin:
                    self._run_scan_adapt(state, k, ss, im, ad, t, th)
            )
            self._run_cache[key] = fn
        if self._sadapt is None:
            self._sadapt = (
                jnp.log(jnp.asarray(self._traj_or_default(), self.dtype)),
                adam_init(self.dtype),
            )

        def call(state, run_key, step_vec, inv_mass):
            state, pos, lp, acc, div, en, sadapt = fn(
                state, run_key, step_vec, inv_mass, self._sadapt
            )
            self._sadapt = sadapt
            return state, pos, lp, acc, div, en

        return call

    def _run_scan_adapt(self, state, key, step_size, inv_mass, sadapt,
                        n_store, thin):
        kernel = self._kernel
        eps = jnp.mean(step_size)
        lo = jnp.log(eps)  # T below one step is meaningless
        hi = lo + jnp.log(float(self.max_leapfrog))
        dt = self.dtype

        def inner(j, carry):
            s, k, a, d, _, log_traj, adam = carry
            k, k_jit, sub = jax.random.split(k, 3)
            u = jax.random.uniform(k_jit, (), s.position.dtype)
            s = self._constrain(s)
            s, (ap, _, traj_grad, _, div, en) = kernel(
                sub, s, eps, inv_mass, jnp.exp(log_traj), u
            )
            # diminishing Adam ascent on log T; the t0 horizon keeps the
            # early rate near adam_lr (diminishing-from-step-1 would cap
            # total movement at ~1 log unit) while t^-kappa still drives
            # the rate to zero
            lr_t = self.adam_lr * (
                1.0 + adam.count.astype(dt) / self.adapt_t0
            ) ** (-self.adapt_kappa)
            delta, adam = adam_step(adam, traj_grad * jnp.exp(log_traj),
                                    lr=lr_t)
            log_traj = jnp.clip(log_traj + delta, lo, hi)
            return (s, k, a + jnp.mean(ap), d | div, en, log_traj, adam)

        def body(carry, _):
            state, key, log_traj, adam = carry
            state, key, acc, div, en, log_traj, adam = jax.lax.fori_loop(
                0, thin, inner,
                (state, key, jnp.zeros((), dt),
                 jnp.zeros((self.n_chains,), jnp.bool_),
                 jnp.zeros((self.n_chains,), dt), log_traj, adam),
            )
            return (state, key, log_traj, adam), (
                state.position, state.logp, acc / thin, div, en
            )

        log_traj, adam = sadapt
        (state, _, log_traj, adam), (pos, lp, acc, div, en) = jax.lax.scan(
            body, (state, key, log_traj, adam), length=n_store
        )
        return state, pos, lp, jnp.mean(acc), div, en, (log_traj, adam)

    def _run_scan(self, state, key, step_size, inv_mass, n_store, thin):
        kernel = self._kernel
        eps = jnp.mean(step_size)
        traj = jnp.asarray(self._traj_or_default(), self.dtype)

        def body(carry, _):
            state, key = carry

            def inner(j, sk):
                s, k, a, d, _ = sk
                k, k_jit, sub = jax.random.split(k, 3)
                u = jax.random.uniform(k_jit, (), s.position.dtype)
                s = self._constrain(s)
                s, (ap, _, _, _, div, en) = kernel(
                    sub, s, eps, inv_mass, traj, u
                )
                return (s, k, a + jnp.mean(ap), d | div, en)

            state, key, acc, div, en = jax.lax.fori_loop(
                0, thin, inner,
                (state, key, jnp.zeros((), self.dtype),
                 jnp.zeros((self.n_chains,), jnp.bool_),
                 jnp.zeros((self.n_chains,), self.dtype)),
            )
            return (state, key), (state.position, state.logp, acc / thin,
                                  div, en)

        (state, _), (pos, lp, acc, div, en) = jax.lax.scan(
            body, (state, key), length=n_store
        )
        return state, pos, lp, jnp.mean(acc), div, en
