"""Particle filtering and particle MCMC for non-linear / non-Gaussian
state-space models: bootstrap particle filter, particle marginal
Metropolis–Hastings (PMMH), and particle Gibbs with ancestor sampling
(PGAS) as a trajectory block for :class:`~mcmcpp_tpu.gibbs.BlockedGibbsSampler`.

No reference counterpart (jmatta1/MCMCpp's model surface is the scalar
``calcLogPostProb``, ``MCMCpp/EnsembleSampler.h:80-96`` — it has no
sequential-latent machinery); north-star scope, completing the time-series
layer next to the exact linear-Gaussian path in
:mod:`mcmcpp_tpu.models.lgss`.

Accelerator-native design
-----------------
The particle axis is the vector axis: every user hook takes the FULL
``(N, D)`` particle block, so one filter step is a handful of fused
elementwise ops plus a ``searchsorted`` gather, and the time dimension is
a single ``lax.scan``. PMMH then vmaps whole filters over chains — the
device sees a ``(C, N, D)`` batch per step, and the chain axis shards
over a :func:`~mcmcpp_tpu.parallel.mesh.make_walker_mesh` exactly like
every other engine. Particle Gibbs runs one conditional SMC per chain
inside the blocked-Gibbs vmapped sweep.

Estimator facts used by the tests (`tests/test_particle.py`):

- the bootstrap filter's likelihood estimate is UNBIASED:
  ``E[exp(loglik_hat)] = p(y_{1:T})`` exactly, for any N ≥ 1 and any
  resampling schedule measurable w.r.t. the past (Del Moral 2004,
  Prop. 7.4.1) — verified against the Kalman evidence on an LGSS model;
- PMMH targets the EXACT posterior despite the noisy likelihood
  (pseudo-marginal argument, Andrieu & Roberts 2009): the estimate is
  carried with the state and never recomputed at the current point;
- PGAS (Lindsten, Jordan & Schön 2014) leaves the joint
  ``p(x_{1:T} | y, θ)`` invariant for any N ≥ 2; ancestor sampling
  breaks the path-degeneracy that makes plain conditional SMC mix
  poorly in T.
"""

from typing import Callable, NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from mcmcpp_tpu.chain import Chain, append_device_chunk
from mcmcpp_tpu.smc import ess_from_log_weights, systematic_resample


class StateSpaceModel(NamedTuple):
    """Functional SSM spec. All hooks are JAX-traceable and VECTORIZED
    over the leading particle axis; ``t`` is the (traced) integer time
    index so time-varying models need no per-step closures; ``theta`` is
    an arbitrary pytree of (hyper)parameters.

    init_sample(key, n, theta) -> (n, D)      draw x_1 ~ p(x_1 | θ)
    trans_sample(key, x, t, theta) -> (n, D)  draw x_t ~ p(· | x_{t-1}=x)
    obs_logpdf(y, x, t, theta) -> (n,)        log p(y_t | x_t=x)
    trans_logpdf(x_next, x, t, theta) -> (n,) log p(x_next | x) — needed
        only for PGAS ancestor sampling; ``x_next`` arrives broadcast to
        the particle axis.
    """

    init_sample: Callable
    trans_sample: Callable
    obs_logpdf: Callable
    trans_logpdf: Optional[Callable] = None
    trans_mean: Optional[Callable] = None
    """trans_mean(x, t, theta) -> (n, D): a point lookahead (the
    transition mean) — the auxiliary filter's first-stage weights are
    ``obs_logpdf(y, trans_mean(x))`` when no ``lookahead_logpdf`` is
    given (Pitt & Shephard's original point-lookahead)."""
    lookahead_logpdf: Optional[Callable] = None
    """lookahead_logpdf(y, x, t, theta) -> (n,): log p̂(y_t | x_{t-1}) —
    the auxiliary filter's first-stage weights; supply the EXACT
    predictive where available (fully-adapted APF)."""
    prop_sample: Optional[Callable] = None
    """prop_sample(key, x, y, t, theta) -> (n, D): guided-filter
    proposal q(x_t | x_{t-1}, y_t); with it the weight increment becomes
    ``obs + trans_logpdf − prop_logpdf`` (locally-optimal proposals give
    near-zero-variance increments). Requires prop_logpdf AND
    trans_logpdf."""
    prop_logpdf: Optional[Callable] = None
    """prop_logpdf(x_next, x, y, t, theta) -> (n,): density of
    ``prop_sample``."""


class PFResult(NamedTuple):
    loglik: jnp.ndarray         # scalar log p_hat(y_{1:T} | theta)
    filter_means: jnp.ndarray   # (T, D) self-normalized filtered means
    ess: jnp.ndarray            # (T,) effective sample size per step
    particles: Optional[jnp.ndarray] = None    # (T, N, D) clouds
    log_weights: Optional[jnp.ndarray] = None  # (T, N) normalized


def particle_filter(key, ssm: StateSpaceModel, theta, ys, n_particles,
                    ess_frac=0.5, auxiliary=False,
                    return_particles=False, mesh=None):
    """Bootstrap particle filter (Gordon, Salmond & Smith 1993) with
    adaptive systematic resampling, or — ``auxiliary=True`` — the
    auxiliary particle filter (Pitt & Shephard 1999).

    ys: (T, E) observations (a (T,) vector is promoted to (T, 1)).
    Resampling triggers when ESS < ``ess_frac * n_particles``
    (``ess_frac=1.0`` resamples every step, ``0.0`` never).

    ``auxiliary=True`` requires ``ssm.trans_mean`` and resamples EVERY
    step from first-stage weights tilted by the lookahead likelihood
    λ_i = log p(y_t | trans_mean(x_{t-1,i})); the second-stage correction
    ``ll − λ_anc`` keeps the evidence estimate unbiased (the combined
    increment is logΣ w_i e^{λ_i} + logΣ_j e^{ll_j − λ_aj} − log N).
    Worth it when the lookahead predicts the realized weight well
    (tight transitions; Johansen & Doucet 2008 show the point-lookahead
    variant can LOSE when the transition is diffuse — measured, not
    assumed, in tests/test_particle.py).

    Guided mode: supplying ``ssm.prop_sample``/``prop_logpdf`` (with
    ``trans_logpdf``) replaces the bootstrap proposal with
    q(x_t | x_{t-1}, y_t) and corrects the weight by
    ``obs + trans − prop``. The locally-optimal proposal
    p(x_t | x_{t-1}, y_t) plus the exact ``lookahead_logpdf``
    p(y_t | x_{t-1}) is the FULLY-ADAPTED auxiliary filter: its weight
    increments are deterministic given the ancestors, collapsing the
    estimator variance (the dramatic, stable win the point-lookahead
    APF only approximates).

    ``mesh=``: shard the PARTICLE axis of this one filter over the mesh
    (for huge-N single filters; the PMMH/SMC² pattern of vmapping whole
    device-local filters is usually the better fit at moderate N).

    Returns :class:`PFResult`; ``loglik`` is the unbiased-in-expectation
    evidence estimate (see module docstring). Fully differentiable in
    ``theta`` EXCEPT through the resampling indices — gradients flow
    through the weights, giving the standard biased-but-consistent PF
    score estimator (verified against the exact Kalman score,
    tests/test_smc2.py); for gradient-based hyperparameter work prefer
    the collapsed :func:`mcmcpp_tpu.models.lgss.lgss_loglik` when the
    model is linear-Gaussian.
    """
    ys = jnp.asarray(ys)
    if ys.ndim == 1:
        ys = ys[:, None]
    if auxiliary and ssm.trans_mean is None \
            and ssm.lookahead_logpdf is None:
        raise ValueError(
            "auxiliary=True needs ssm.trans_mean or ssm.lookahead_logpdf"
        )
    guided = ssm.prop_sample is not None
    if guided and (ssm.prop_logpdf is None or ssm.trans_logpdf is None):
        raise ValueError(
            "a guided filter (ssm.prop_sample) needs ssm.prop_logpdf "
            "and ssm.trans_logpdf"
        )
    n = int(n_particles)
    logn = jnp.log(jnp.asarray(float(n)))
    k_init, k_scan = jax.random.split(key)
    from mcmcpp_tpu.parallel.mesh import particle_constrainer

    constrain = particle_constrainer(mesh, n)

    def propagate(k, x_r, y, t):
        """(x', per-particle log weight increment) under the bootstrap
        or guided proposal."""
        if not guided:
            xn = ssm.trans_sample(k, x_r, t, theta)
            return xn, ssm.obs_logpdf(y, xn, t, theta)
        xn = ssm.prop_sample(k, x_r, y, t, theta)
        return xn, (
            ssm.obs_logpdf(y, xn, t, theta)
            + ssm.trans_logpdf(xn, x_r, t, theta)
            - ssm.prop_logpdf(xn, x_r, y, t, theta)
        )

    def lookahead(y, x, t):
        if ssm.lookahead_logpdf is not None:
            return ssm.lookahead_logpdf(y, x, t, theta)
        return ssm.obs_logpdf(y, ssm.trans_mean(x, t, theta), t, theta)

    x0 = ssm.init_sample(k_init, n, theta)
    dt = x0.dtype
    ll0 = ssm.obs_logpdf(ys[0], x0, 0, theta)
    incr0 = jax.scipy.special.logsumexp(ll0) - logn
    lw0 = ll0 - jax.scipy.special.logsumexp(ll0)
    x0, lw0 = constrain(x0, lw0)
    w0 = jnp.exp(lw0)
    mean0 = w0 @ x0
    ess0 = ess_from_log_weights(lw0)

    def step(carry, inp):
        x, lw, key = carry
        y, t = inp
        key, k_rs, k_prop = jax.random.split(key, 3)
        ess = ess_from_log_weights(lw)
        do_rs = ess < ess_frac * n
        idx = systematic_resample(k_rs, lw, n)
        idx = jnp.where(do_rs, idx, jnp.arange(n, dtype=jnp.int32))
        x = jnp.take(x, idx, axis=0)
        lw = jnp.where(do_rs, jnp.full((n,), -logn, lw.dtype), lw)
        x, ll = propagate(k_prop, x, y, t)
        incr = jax.scipy.special.logsumexp(lw + ll)
        lw = lw + ll - incr
        x, lw = constrain(x, lw)
        w = jnp.exp(lw)
        out = (incr, w @ x, ess_from_log_weights(lw))
        if return_particles:
            out = out + (x, lw)
        return (x, lw, key), out

    def step_aux(carry, inp):
        x, lw, key = carry
        y, t = inp
        key, k_rs, k_prop = jax.random.split(key, 3)
        lam = lookahead(y, x, t)
        first = lw + lam
        norm1 = jax.scipy.special.logsumexp(first)
        idx = systematic_resample(k_rs, first, n)
        x_r = jnp.take(x, idx, axis=0)
        lam_r = jnp.take(lam, idx, axis=0)
        xn, ll = propagate(k_prop, x_r, y, t)
        second = ll - lam_r
        norm2 = jax.scipy.special.logsumexp(second)
        incr = norm1 + norm2 - logn
        lw_new = second - norm2
        xn, lw_new = constrain(xn, lw_new)
        w = jnp.exp(lw_new)
        out = (incr, w @ xn, ess_from_log_weights(lw_new))
        if return_particles:
            out = out + (xn, lw_new)
        return (xn, lw_new, key), out

    t_idx = jnp.arange(1, ys.shape[0])
    (_, _, _), outs = jax.lax.scan(
        step_aux if auxiliary else step, (x0, lw0, k_scan),
        (ys[1:], t_idx)
    )
    incrs, means, esss = outs[:3]
    loglik = incr0 + jnp.sum(incrs)
    particles = log_weights = None
    if return_particles:
        particles = jnp.concatenate([x0[None], outs[3]], axis=0)
        log_weights = jnp.concatenate([lw0[None], outs[4]], axis=0)
    return PFResult(
        loglik.astype(dt),
        jnp.concatenate([mean0[None], means], axis=0),
        jnp.concatenate([ess0[None], esss], axis=0),
        particles, log_weights,
    )


class SmootherResult(NamedTuple):
    trajectories: jnp.ndarray     # (J, T, D) joint smoothing draws
    smoothed_means: jnp.ndarray   # (T, D) pooled E[x_t | y_{1:T}]
    loglik: jnp.ndarray           # scalar, from the forward filter


def particle_smoother(key, ssm: StateSpaceModel, theta, ys, n_particles,
                      n_draws, ess_frac=0.5, auxiliary=False, mesh=None):
    """Forward-filter backward-simulation smoother (Godsill, Doucet &
    West 2004): ``n_draws`` joint draws from p(x_{1:T} | y_{1:T}, θ).

    Requires ``ssm.trans_logpdf``. The forward pass is one
    :func:`particle_filter` keeping the (T, N, D) clouds; the backward
    pass re-weights each stored cloud by the transition density to the
    already-sampled next state and draws categorically — all ``n_draws``
    paths advance together, so each backward step evaluates one
    (J, N) ``trans_logpdf`` block (batched work, not a per-draw loop)
    inside a single reverse `lax.scan`.

    Complements :class:`ParticleGibbsKernel` (which targets the joint
    with θ inside a Gibbs sweep): this is the fixed-θ smoother for
    state estimation and EM-style algorithms. Per-draw cost is O(T·N);
    degeneracy-free unlike genealogy tracing because every backward
    step resamples against the FULL stored cloud.

    ``mesh=`` shards the particle axis of the forward filter AND the
    backward (J, N) reweighting blocks over the mesh (the J draw axis
    stays replicated; the categorical ancestor pick is a cross-device
    argmax-style reduction GSPMD lowers for free).

    Returns :class:`SmootherResult`; pooled moments of ``trajectories``
    estimate the marginal smoothing distributions (RTS-oracle-tested on
    the linear-Gaussian model, tests/test_particle.py).
    """
    if ssm.trans_logpdf is None:
        raise ValueError("particle_smoother needs ssm.trans_logpdf")
    ys = jnp.asarray(ys)
    if ys.ndim == 1:
        ys = ys[:, None]
    j_n = int(n_draws)
    k_fwd, k_last, k_back = jax.random.split(key, 3)
    res = particle_filter(
        k_fwd, ssm, theta, ys, n_particles, ess_frac=ess_frac,
        auxiliary=auxiliary, return_particles=True, mesh=mesh,
    )
    xs, lws = res.particles, res.log_weights          # (T, N, D), (T, N)
    t_n = xs.shape[0]

    b_last = jax.random.categorical(k_last, lws[-1], shape=(j_n,))
    x_last = jnp.take(xs[-1], b_last, axis=0)          # (J, D)

    def back(carry, inp):
        x_next, key = carry                            # (J, D)
        x_t, lw_t, t = inp                             # (N, D), (N,)
        key, k = jax.random.split(key)
        lp = jax.vmap(
            lambda xn: ssm.trans_logpdf(
                jnp.broadcast_to(xn[None, :], x_t.shape), x_t,
                t + 1, theta,
            )
        )(x_next)                                      # (J, N)
        b = jax.random.categorical(k, lw_t[None, :] + lp, axis=-1)
        x_sel = jnp.take(x_t, b, axis=0)
        return (x_sel, key), x_sel

    t_idx = jnp.arange(t_n - 1)
    (_, _), sel = jax.lax.scan(
        back, (x_last, k_back), (xs[:-1], lws[:-1], t_idx), reverse=True
    )                                                  # (T-1, J, D)
    traj = jnp.concatenate([sel, x_last[None]], axis=0)
    traj = jnp.swapaxes(traj, 0, 1)                    # (J, T, D)
    return SmootherResult(traj, jnp.mean(traj, axis=0), res.loglik)


def particle_forecast(key, ssm: StateSpaceModel, theta, particles,
                      log_weights, t0, horizon, obs_sample=None,
                      mesh=None):
    """k-step-ahead predictive simulation from a filter's final cloud.

    Complements :func:`mcmcpp_tpu.models.lgss.forecast` (which is exact
    for the linear-Gaussian case) on non-linear models: resample the
    weighted cloud once to equal weights, then propagate every particle
    ``horizon`` steps through ``trans_sample`` — the Monte Carlo
    predictive p(x_{t0+k} | y_{1:t0}). Feed it the ``particles`` /
    ``log_weights`` from ``particle_filter(..., return_particles=True)``
    (last row) and ``t0 = T``.

    obs_sample : optional ``(key, x, t, theta) -> (n, E)`` observation
        simulator; when given, per-step predictive OBSERVATION draws are
        returned too (None otherwise) — predictive bands for y.

    ``mesh=`` shards the cloud's particle axis over the mesh (the
    propagation is embarrassingly parallel after the one resample).

    Returns ``(x_paths (H, N, D), y_draws (H, N, E) | None)``.
    """
    from mcmcpp_tpu.parallel.mesh import particle_constrainer

    particles = jnp.asarray(particles)
    n = particles.shape[0]
    constrain = particle_constrainer(mesh, n)
    k_rs, k_scan = jax.random.split(key)
    idx = systematic_resample(k_rs, jnp.asarray(log_weights), n)
    (x,) = constrain(jnp.take(particles, idx, axis=0))

    def step(carry, t):
        x, key = carry
        key, k_f, k_o = jax.random.split(key, 3)
        x = ssm.trans_sample(k_f, x, t, theta)
        y = (obs_sample(k_o, x, t, theta) if obs_sample is not None
             else jnp.zeros((0,)))
        return (x, key), (x, y)

    t_idx = jnp.arange(t0, t0 + int(horizon))
    (_, _), (xs, ys) = jax.lax.scan(step, (x, k_scan), t_idx)
    return xs, (ys if obs_sample is not None else None)


class PMMHState(NamedTuple):
    position: jax.Array   # (C, P) theta
    loglik: jax.Array     # (C,) carried PF estimate (pseudo-marginal)
    logprior: jax.Array   # (C,)
    accepted: jax.Array   # (C,) int32


class PMMHSampler:
    """Particle marginal Metropolis–Hastings (Andrieu, Doucet & Holenstein
    2010): Gaussian random-walk MH on a flat ``(P,)`` hyperparameter
    vector whose likelihood is the particle filter's estimate.

    ssm hooks receive theta as the flat ``(P,)`` vector. ``log_prior``
    maps (P,) -> scalar (return -inf outside the support; the filter
    must still be SAFE to trace there — use transformed/unconstrained
    parametrizations when in doubt). ``proposal_scale``: scalar or (P,)
    random-walk scale. The rough N rule of thumb: tune ``n_particles``
    so that std[loglik_hat] ≈ 1–2 nats at representative theta
    (Doucet et al. 2015), e.g. via repeated :func:`particle_filter`
    calls.

    Driver surface (init/run/get_samples) matches the other engines;
    storage via the shared Chain (``MCMCpp/Chain/Chain.h`` analogue);
    ``mesh=`` shards the chain axis like every other engine.
    """

    def __init__(self, ssm: StateSpaceModel, ys, log_prior, n_params,
                 n_particles=256, proposal_scale=0.1, n_chains=16, seed=0,
                 ess_frac=0.5, dtype=jnp.float32, max_chain_bytes=2 << 30,
                 mesh=None, chain=None, max_chunk_steps=128,
                 loglik_fn=None, auxiliary=False):
        """``loglik_fn``: optional ``(key, theta) -> scalar`` override of
        the likelihood estimator (pass ``ssm=None, ys=None`` with it).
        Any non-negatively-biased estimator keeps the pseudo-marginal
        chain exact: a Rao-Blackwellised filter
        (:func:`mcmcpp_tpu.rbpf.rao_blackwell_filter` — lower-variance,
        hence better acceptance at the same cost), or the EXACT
        likelihood (e.g. :func:`mcmcpp_tpu.models.lgss.lgss_loglik`),
        which degenerates to plain MH on the hyperparameter posterior."""
        if loglik_fn is None and ssm is None:
            raise ValueError("need either an ssm or a loglik_fn")
        self._loglik_fn = loglik_fn
        self.auxiliary = bool(auxiliary)
        self.ssm = ssm
        self.ys = None if ys is None else jnp.asarray(ys)
        self.log_prior = log_prior
        self.n_params = int(n_params)
        self.n_particles = int(n_particles)
        self.proposal_scale = jnp.broadcast_to(
            jnp.asarray(proposal_scale, dtype), (self.n_params,)
        )
        # full proposal Cholesky (diagonal until tune() learns better);
        # threaded through the jitted programs as an ARGUMENT so adapting
        # it never leaves stale closures in _run_cache
        self._prop_chol = jnp.diag(self.proposal_scale)
        self.n_chains = int(n_chains)
        self.ess_frac = float(ess_frac)
        self.max_chunk_steps = (
            None if max_chunk_steps is None else max(1, int(max_chunk_steps))
        )
        self.dtype = dtype
        self._key = jax.random.key(seed)
        self.state = None
        self._n_steps_done = 0
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
                    f"n_chains={self.n_chains} not divisible by mesh size "
                    f"{mesh.size}"
                )
            self._chain_sharding = walker_sharding(mesh)
        self._run_cache = {}

    def _constrain(self, state):
        if self._chain_sharding is None:
            return state
        from mcmcpp_tpu.parallel.mesh import vector_sharding

        vs = vector_sharding(self._chain_sharding)
        c = lambda x: jax.lax.with_sharding_constraint(
            x, self._chain_sharding
        )
        v = lambda x: jax.lax.with_sharding_constraint(x, vs)
        return PMMHState(
            c(state.position), v(state.loglik), v(state.logprior),
            v(state.accepted),
        )

    def _pf_loglik(self, key, theta):
        if self._loglik_fn is not None:
            return self._loglik_fn(key, theta)
        return particle_filter(
            key, self.ssm, theta, self.ys, self.n_particles,
            ess_frac=self.ess_frac, auxiliary=self.auxiliary,
        ).loglik

    def init(self, positions, seed=None):
        """positions: (C, P) initial theta (or (P,) broadcast). The
        initial PF estimates are drawn here (one filter per chain)."""
        positions = jnp.asarray(positions, self.dtype)
        if positions.ndim == 1:
            positions = jnp.broadcast_to(
                positions[None, :], (self.n_chains, self.n_params)
            )
        if positions.shape != (self.n_chains, self.n_params):
            raise ValueError(
                f"positions must be ({self.n_chains}, {self.n_params})"
            )
        if self._chain_sharding is not None:
            positions = jax.device_put(positions, self._chain_sharding)
        key = self._key if seed is None else jax.random.key(seed)
        key = jax.random.fold_in(key, 0x9337)
        lls = jax.vmap(self._pf_loglik)(
            jax.random.split(key, self.n_chains), positions
        )
        lps = jax.vmap(self.log_prior)(positions)
        self.state = self._constrain(PMMHState(
            positions, lls.astype(self.dtype), lps.astype(self.dtype),
            jnp.zeros((self.n_chains,), jnp.int32),
        ))
        self._n_steps_done = 0
        return self

    # -- one transition, whole (C, P) batch -----------------------------------

    def _step(self, key, state, prop_chol):
        state = self._constrain(state)
        k_prop, k_pf, k_u = jax.random.split(key, 3)
        c = self.n_chains
        z = jax.random.normal(k_prop, state.position.shape, self.dtype)
        prop = state.position + z @ prop_chol.T
        lp_new = jax.vmap(self.log_prior)(prop).astype(self.dtype)
        ll_new = jax.vmap(self._pf_loglik)(
            jax.random.split(k_pf, c), prop
        ).astype(self.dtype)
        log_acc = (lp_new + ll_new) - (state.logprior + state.loglik)
        u = jax.random.uniform(k_u, (c,), self.dtype, minval=1e-37)
        ok = (jnp.log(u) < log_acc) & jnp.isfinite(lp_new) \
            & jnp.isfinite(ll_new)
        return self._constrain(PMMHState(
            jnp.where(ok[:, None], prop, state.position),
            jnp.where(ok, ll_new, state.loglik),
            jnp.where(ok, lp_new, state.logprior),
            state.accepted + ok.astype(jnp.int32),
        ))

    # -- driver (mirrors elliptical.py / chain.run_pipelined) -----------------

    def _run_scan(self, state, key, prop_chol, n_store, thin):
        def body(carry, _):
            state, key = carry

            def inner(j, sk):
                s, k = sk
                k, sub = jax.random.split(k)
                return (self._step(sub, s, prop_chol), k)

            state, key = jax.lax.fori_loop(0, thin, inner, (state, key))
            return (state, key), (
                state.position, state.logprior + state.loglik,
            )

        (state, _), (pos, lp) = jax.lax.scan(
            body, (state, key), length=n_store
        )
        return state, pos, lp

    def run(self, n_steps, thin=1):
        """Store every thin-th theta; the stored logp column is
        ``log_prior + loglik_hat`` (the pseudo-marginal target).
        Leftover ``n_steps % thin`` transitions advance unstored.
        Returns False on chain byte-cap (EndOfChain)."""
        if self.state is None:
            raise RuntimeError("call init first")
        thin = int(thin)
        n_store = int(n_steps) // thin
        leftover = int(n_steps) - n_store * thin
        from mcmcpp_tpu.chain import default_chunk_steps, run_pipelined

        # every transition runs C whole particle filters, so the byte
        # budget alone would produce minutes-long launches; cap the steps
        # per launch too (one extra ~25 ms dispatch per chunk is noise
        # against the per-chunk filter compute)
        chunk = default_chunk_steps(self.n_chains, self.n_params, self.dtype)
        if self.max_chunk_steps is not None:
            chunk = min(chunk, self.max_chunk_steps)

        def launch(take):
            fn = self._run_cache.get((take, thin))
            if fn is None:
                fn = jax.jit(
                    lambda st, k, pc, t=take, th=thin: self._run_scan(
                        st, k, pc, t, th
                    )
                )
                self._run_cache[(take, thin)] = fn
            self._key, run_key = jax.random.split(self._key)
            self.state, pos, lp = fn(self.state, run_key, self._prop_chol)
            return (pos, lp)

        def fetch(futures):
            self.chain, appended = append_device_chunk(
                self.chain, futures[0], futures[1]
            )
            return appended

        ok = run_pipelined(n_store, chunk, launch, fetch)
        self._n_steps_done += n_store * thin
        if ok and leftover:
            fn = self._run_cache.get((1, leftover))
            if fn is None:
                fn = jax.jit(
                    lambda st, k, pc, lo=leftover: self._run_scan(
                        st, k, pc, 1, lo
                    )
                )
                self._run_cache[(1, leftover)] = fn
            self._key, run_key = jax.random.split(self._key)
            self.state, _, _ = fn(self.state, run_key, self._prop_chol)
            self._n_steps_done += leftover
        return ok

    def tune(self, n_steps=300, window=50, target_accept=0.234,
             adapt_cov=True, jitter=1e-6):
        """Adapt the random-walk proposal BEFORE sampling (frozen once
        sampling starts, so the kept chain is exact MH).

        Runs ``n_steps`` unstored transitions in ``window``-sized spans;
        after each span the global scale moves by Robbins–Monro toward
        ``target_accept`` (Roberts & Rosenthal's 0.234 — for very noisy
        likelihood estimates the optimum drifts lower, ~0.10–0.15;
        Sherlock et al. 2015), and with ``adapt_cov`` the proposal shape
        is re-estimated from the CROSS-CHAIN spread of positions scaled
        by Haario's 2.38²/P (no history needed — the chain axis is the
        sample). Returns self; acceptance counters reset afterwards so
        ``acceptance_fraction`` reflects the frozen kernel only.
        """
        if self.state is None:
            raise RuntimeError("call init first")
        window = max(1, int(window))
        n_spans = max(1, int(n_steps) // window)
        fn = jax.jit(
            lambda st, k, pc, w=window: self._run_scan(st, k, pc, 1, w)
        )
        log_s = 0.0
        base = self._prop_chol
        for i in range(n_spans):
            acc0 = int(np.asarray(self.state.accepted).sum())
            self._key, run_key = jax.random.split(self._key)
            self.state, _, _ = fn(
                self.state, run_key, jnp.exp(log_s) * base
            )
            acc = (int(np.asarray(self.state.accepted).sum()) - acc0) / (
                window * self.n_chains
            )
            gain = 1.0 / np.sqrt(i + 1.0)
            log_s += gain * (acc - target_accept)
            if adapt_cov and self.n_chains > self.n_params:
                pos = np.asarray(self.state.position, np.float64)
                cov = np.cov(pos.T).reshape(self.n_params, self.n_params)
                # adopt the cross-chain shape only once the chains have
                # actually spread: with identical inits and a rejected
                # first window, cov ~ 0 and adopting it would collapse
                # the proposal onto the jitter floor and stall the tune
                spread_ok = (
                    np.isfinite(cov).all()
                    and np.trace(cov) > self.n_params * jitter * 100.0
                )
                if spread_ok:
                    cov = (2.38**2 / self.n_params) * cov
                    cov += jitter * np.eye(self.n_params)
                    base = jnp.asarray(
                        np.linalg.cholesky(cov), self.dtype
                    )
        self._prop_chol = jnp.exp(log_s) * base
        self.state = self._constrain(PMMHState(
            self.state.position, self.state.loglik, self.state.logprior,
            jnp.zeros((self.n_chains,), jnp.int32),
        ))
        self._n_steps_done = 0
        return self

    @property
    def acceptance_fraction(self):
        """(C,) per-chain accept fraction since init."""
        if self.state is None or self._n_steps_done == 0:
            return np.zeros((self.n_chains,))
        return np.asarray(self.state.accepted) / self._n_steps_done

    def get_samples(self, burn_in=0, thin=1, flat=False):
        return self.chain.get(burn_in=burn_in, thin=thin, flat=flat)

    def get_log_probs(self, burn_in=0, thin=1, flat=False):
        return self.chain.get_logp(burn_in=burn_in, thin=thin, flat=flat)


class ParticleGibbsKernel:
    """Blocked-Gibbs kernel resampling a latent trajectory x_{1:T} from
    (approximately-exactly) its full conditional via conditional SMC with
    ancestor sampling (PGAS — Lindsten, Jordan & Schön 2014; invariant
    for any ``n_particles`` ≥ 2).

    Declare the trajectory as a flat ``(T*D,)`` block, exactly like
    :class:`mcmcpp_tpu.models.lgss.LGSSKernel` (which is the EXACT
    special case when the model is linear-Gaussian)::

        BlockedGibbsSampler([
            ("x", T * D, ParticleGibbsKernel(ssm, ys, n_particles=64,
                                             theta_fn=...)),
            ("phi", 1, <any kernel>),
        ], ...)

    theta_fn: pytree, or callable ``others -> theta pytree`` reading the
        live hyperparameter blocks.
    ancestor_sampling requires ``ssm.trans_logpdf``; set it False to fall
    back to plain conditional SMC (valid but slow-mixing in T).
    """

    def __init__(self, ssm: StateSpaceModel, ys, n_particles=64,
                 theta_fn=None, ancestor_sampling=True):
        self.ssm = ssm
        self.ys = jnp.asarray(ys)
        if self.ys.ndim == 1:
            self.ys = self.ys[:, None]
        self.n = int(n_particles)
        if self.n < 2:
            raise ValueError("PGAS needs n_particles >= 2")
        self._theta = theta_fn
        self.ancestor_sampling = bool(ancestor_sampling)
        if ancestor_sampling and ssm.trans_logpdf is None:
            raise ValueError(
                "ancestor_sampling=True needs ssm.trans_logpdf; pass "
                "ancestor_sampling=False for plain conditional SMC"
            )

    def step(self, key, x, others):
        theta = self._theta(others) if callable(self._theta) else self._theta
        t_n = self.ys.shape[0]
        d = x.shape[0] // t_n
        x_ref = x.reshape(t_n, d)
        n = self.n
        k_init, k_scan, k_pick = jax.random.split(key, 3)

        # t = 0: free particles from the initial law; slot n-1 is the
        # reference; weights are the observation densities
        x0 = self.ssm.init_sample(k_init, n, theta).astype(x.dtype)
        x0 = x0.at[n - 1].set(x_ref[0])
        lw0 = self.ssm.obs_logpdf(self.ys[0], x0, 0, theta)
        lw0 = lw0 - jax.scipy.special.logsumexp(lw0)

        def step_t(carry, inp):
            xp, lw, key = carry
            y, xr, t = inp
            key, k_a, k_as, k_prop = jax.random.split(key, 4)
            # multinomial ancestors for the n-1 free particles
            anc = jax.random.categorical(k_a, lw, shape=(n,))
            if self.ancestor_sampling:
                # reference slot: weights tilted by the transition to x_ref
                as_logits = lw + self.ssm.trans_logpdf(
                    jnp.broadcast_to(xr[None, :], xp.shape), xp, t, theta
                )
                a_ref = jax.random.categorical(k_as, as_logits)
            else:
                a_ref = jnp.int32(n - 1)
            anc = anc.at[n - 1].set(a_ref)
            xres = jnp.take(xp, anc, axis=0)
            xnew = self.ssm.trans_sample(k_prop, xres, t, theta)
            xnew = xnew.at[n - 1].set(xr)
            lw = self.ssm.obs_logpdf(y, xnew, t, theta)
            lw = lw - jax.scipy.special.logsumexp(lw)
            return (xnew, lw, key), (xnew, anc)

        t_idx = jnp.arange(1, t_n)
        (xl, lw_last, _), (xs, ancs) = jax.lax.scan(
            step_t, (x0, lw0, k_scan), (self.ys[1:], x_ref[1:], t_idx)
        )
        xs = jnp.concatenate([x0[None], xs], axis=0)  # (T, n, D)

        # draw the output path: index at T-1, then trace the ancestry back
        b_last = jax.random.categorical(k_pick, lw_last)

        def back(b, a):
            b2 = a[b]
            return b2, b2

        _, prev = jax.lax.scan(back, b_last, ancs, reverse=True)  # (T-1,)
        idx = jnp.concatenate([prev, b_last[None]])
        traj = jnp.take_along_axis(
            xs, idx[:, None, None].astype(jnp.int32), axis=1
        )[:, 0, :]
        return traj.reshape(-1).astype(x.dtype)
