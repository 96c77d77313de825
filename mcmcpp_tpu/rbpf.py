"""Rao-Blackwellised particle filtering (mixture Kalman filter) for
conditionally linear-Gaussian state-space models.

Doucet, de Freitas, Murphy & Russell (2000); Chen & Liu (2000, "Mixture
Kalman filters"). For models whose latent splits into a nonlinear (often
discrete) component z_t and a linear-Gaussian component x_t,

    z_t ~ p(z_t | z_{t-1})
    x_t = A(z_t) x_{t-1} + b(z_t) + N(0, Q(z_t))
    y_t = H(z_t) x_t    + c(z_t) + N(0, R(z_t)),

the filter particles live ONLY on z-paths; conditional on each path the
x-marginal is exactly Gaussian, so every particle carries Kalman moments
(m, P) instead of x samples and the weight increment is the EXACT
predictive density N(y_t; H m_pred + c, H P_pred Hᵀ + R). Marginalizing
the linear substate strictly reduces estimator variance versus a plain
bootstrap filter on (z, x) (Rao-Blackwell/conditioning argument; the
variance ordering is tested, not assumed — tests/test_rbpf.py).

No reference counterpart (jmatta1/MCMCpp has no sequential machinery —
its model surface is the scalar ``calcLogPostProb``,
``MCMCpp/EnsembleSampler.h:80-96``); north-star scope completing the
time-series layer: this is the exact bridge between the pure-Kalman path
(:mod:`mcmcpp_tpu.models.lgss`) and the pure-sampling path
(:mod:`mcmcpp_tpu.particle`), and the natural filter for the switching
SSMs the Gibbs layer fits offline (HMMKernel × LGSSKernel).

Accelerator-native design
-----------------
The per-step work is N independent tiny Kalman updates — the worst
possible shapes one at a time, but batched over the particle axis they
become (N, D, D) einsum matmuls and one batched (N, E, E) Cholesky: matmul
work, not elementwise loops. Time is a single ``lax.scan``; resampling gathers
(z, m, P) together; the covariance update uses the Joseph form so f32
moments stay symmetric-PSD over long streams.
"""

from typing import Callable, NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from mcmcpp_tpu.smc import ess_from_log_weights, systematic_resample


class RaoBlackwellSSM(NamedTuple):
    """Conditionally linear-Gaussian SSM spec. All hooks are
    JAX-traceable and vectorized over the leading particle axis; ``t``
    is the traced time index.

    z_init_sample(key, n) -> (n, ...)        draw z_1
    z_trans_sample(key, z, t) -> (n, ...)    draw z_t | z_{t-1}
    cond_params(z, t) -> (A, b, Q, H, c, R)  per-particle conditional
        matrices, shapes (n,D,D), (n,D), (n,D,D), (n,E,D), (n,E),
        (n,E,E). Convention matches :class:`~mcmcpp_tpu.models.lgss.
        LGSSParams`: A/b/Q govern the transition INTO step t (unused at
        t=0), H/c/R observe step t.
    m0 (D,), P0 (D,D): x_1 ~ N(m0, P0) (the ``initial="state"``
        convention of the lgss module).
    z_stat_fn(z) -> (n, S), optional: per-step filtered statistics of z
        accumulated as weighted averages (e.g. regime one-hots).
    """

    z_init_sample: Callable
    z_trans_sample: Callable
    cond_params: Callable
    m0: jnp.ndarray
    P0: jnp.ndarray
    z_stat_fn: Optional[Callable] = None


class RBPFResult(NamedTuple):
    loglik: jnp.ndarray    # scalar log p_hat(y_{1:T}); unbiased in exp
    x_means: jnp.ndarray   # (T, D) weighted filtered E[x_t | y_{1:t}]
    z_stats: jnp.ndarray   # (T, S) weighted z_stat_fn averages
    ess: jnp.ndarray       # (T,)
    final_z: Optional[object] = None        # (N, ...) final z-particles
    final_means: Optional[jnp.ndarray] = None   # (N, D) Kalman means
    final_covs: Optional[jnp.ndarray] = None    # (N, D, D) Kalman covs
    final_log_weights: Optional[jnp.ndarray] = None  # (N,) normalized


def _kalman_observe(m, P, H, c, R, y):
    """Batched measurement update + exact predictive loglik.

    m (n,D), P (n,D,D); H (n,E,D), c (n,E), R (n,E,E); y (E,).
    Returns (m', P', loglik (n,)). Joseph-form covariance update.
    """
    e = H.shape[-2]
    S = jnp.einsum("nij,njk,nlk->nil", H, P, H) + R
    chol = jnp.linalg.cholesky(S)
    innov = y[None, :] - (jnp.einsum("nij,nj->ni", H, m) + c)
    v = jax.scipy.linalg.solve_triangular(chol, innov[..., None],
                                          lower=True)[..., 0]
    loglik = (
        -0.5 * jnp.sum(v * v, axis=-1)
        - jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1)
        - 0.5 * e * np.log(2.0 * np.pi)
    )
    pht = jnp.einsum("nij,nkj->nik", P, H)            # (n, D, E)
    # S⁻¹ via the Cholesky already in hand (one factorization per step,
    # not a second LU inside linalg.solve)
    gain = jnp.swapaxes(
        jax.scipy.linalg.cho_solve(
            (chol, True), jnp.swapaxes(pht, -1, -2)
        ), -1, -2,
    )                                                  # (n, D, E)
    m_new = m + jnp.einsum("nde,ne->nd", gain, innov)
    d = m.shape[-1]
    imkh = jnp.eye(d, dtype=m.dtype)[None] - jnp.einsum(
        "nde,nei->ndi", gain, H
    )
    p_new = (
        jnp.einsum("nij,njk,nlk->nil", imkh, P, imkh)
        + jnp.einsum("nde,nef,ngf->ndg", gain, R, gain)
    )
    return m_new, p_new, loglik


def rao_blackwell_filter(key, model: RaoBlackwellSSM, ys, n_particles,
                         ess_frac=0.5, mesh=None):
    """Mixture Kalman filter with adaptive systematic resampling.

    ys: (T, E) observations ((T,) promoted to (T, 1)). Resampling
    triggers when the z-path ESS < ``ess_frac * n_particles``. Returns
    :class:`RBPFResult`; ``exp(loglik)`` is unbiased for p(y_{1:T})
    (standard SMC unbiasedness — the weight increments are exact
    conditional predictives), with strictly less variance than the
    plain bootstrap filter on the joint (z, x).

    ``mesh=``: shard the particle axis (z-paths AND their Kalman
    moments) over the mesh — the batched Kalman algebra is embarrassingly
    parallel per particle; only the weight reductions and resampling
    need collectives (GSPMD inserts them; CPU-mesh parity tested).
    """
    ys = jnp.asarray(ys)
    if ys.ndim == 1:
        ys = ys[:, None]
    n = int(n_particles)
    from mcmcpp_tpu.parallel.mesh import particle_constrainer

    constrain = particle_constrainer(mesh, n)
    logn = jnp.log(jnp.asarray(float(n)))
    # default z statistic: all leaves flattened side by side — the
    # resample path supports pytree z, so the default must too
    zstat = model.z_stat_fn or (lambda z: jnp.concatenate(
        [jnp.asarray(leaf, jnp.float32).reshape(n, -1)
         for leaf in jax.tree.leaves(z)], axis=1,
    ))
    k_init, k_scan = jax.random.split(key)

    m0 = jnp.asarray(model.m0)
    dt = m0.dtype
    z0 = model.z_init_sample(k_init, n)
    m = jnp.broadcast_to(m0[None], (n,) + m0.shape).astype(dt)
    p = jnp.broadcast_to(
        jnp.asarray(model.P0)[None], (n,) + jnp.asarray(model.P0).shape
    ).astype(dt)
    _, _, _, h0, c0, r0 = model.cond_params(z0, jnp.int32(0))
    m, p, ll0 = _kalman_observe(m, p, h0, c0, r0, ys[0])
    norm0 = jax.scipy.special.logsumexp(ll0)
    lw = ll0 - norm0
    incr0 = norm0 - logn
    z0 = jax.tree.map(lambda a: constrain(a)[0], z0)
    m, p, lw = constrain(m, p, lw)
    w0 = jnp.exp(lw)
    out0 = (w0 @ m, w0 @ zstat(z0), ess_from_log_weights(lw))

    def step(carry, inp):
        z, m, p, lw, key = carry
        y, t = inp
        key, k_rs, k_z = jax.random.split(key, 3)
        ess = ess_from_log_weights(lw)
        do_rs = ess < ess_frac * n
        idx = systematic_resample(k_rs, lw, n)
        idx = jnp.where(do_rs, idx, jnp.arange(n, dtype=jnp.int32))
        z = jax.tree.map(lambda a: jnp.take(a, idx, axis=0), z)
        m = jnp.take(m, idx, axis=0)
        p = jnp.take(p, idx, axis=0)
        lw = jnp.where(do_rs, jnp.full((n,), -logn, lw.dtype), lw)
        z = model.z_trans_sample(k_z, z, t)
        a_t, b_t, q_t, h_t, c_t, r_t = model.cond_params(z, t)
        m_pred = jnp.einsum("nij,nj->ni", a_t, m) + b_t
        p_pred = jnp.einsum("nij,njk,nlk->nil", a_t, p, a_t) + q_t
        m, p, ll = _kalman_observe(m_pred, p_pred, h_t, c_t, r_t, y)
        incr = jax.scipy.special.logsumexp(lw + ll)
        lw = lw + ll - incr
        z = jax.tree.map(lambda a: constrain(a)[0], z)
        m, p, lw = constrain(m, p, lw)
        w = jnp.exp(lw)
        return (z, m, p, lw, key), (
            incr, w @ m, w @ zstat(z), ess_from_log_weights(lw),
        )

    t_idx = jnp.arange(1, ys.shape[0])
    (z_f, m_f, p_f, lw_f, _), (incrs, means, zs, esss) = jax.lax.scan(
        step, (z0, m, p, lw, k_scan), (ys[1:], t_idx)
    )
    return RBPFResult(
        (incr0 + jnp.sum(incrs)).astype(dt),
        jnp.concatenate([out0[0][None], means], axis=0),
        jnp.concatenate([out0[1][None], zs], axis=0),
        jnp.concatenate([out0[2][None], esss], axis=0),
        z_f, m_f, p_f, lw_f,
    )


def rbpf_forecast(key, model: RaoBlackwellSSM, z, means, covs,
                  log_weights, t0, horizon, mesh=None):
    """k-step-ahead predictive moments from an RBPF cloud: resample
    (z, m, P) once to equal weights, then per step sample
    z' ~ p(z'|z) and propagate each particle's EXACT Kalman moments
    through its regime's (A, b, Q) — the linear substate stays
    marginalized, so the only Monte Carlo error is over regime paths.
    Feed it the ``final_*`` fields of :class:`RBPFResult` and
    ``t0 = T``.

    Returns ``(state_means (H, D), state_covs (H, D, D),
    z_stats (H, S))`` where the covariance is the full mixture
    covariance (within-particle Kalman cov + between-particle spread
    of means). The single-regime case reproduces
    :func:`mcmcpp_tpu.models.lgss.forecast` exactly
    (tests/test_rbpf.py).

    ``mesh=`` shards the cloud's particle axis (regime paths AND their
    Kalman moments) over the mesh; the mixture-moment reductions are
    cross-device means GSPMD lowers to all-reduces.
    """
    from mcmcpp_tpu.parallel.mesh import particle_constrainer
    from mcmcpp_tpu.smc import systematic_resample

    means = jnp.asarray(means)
    n = means.shape[0]
    constrain = particle_constrainer(mesh, n)
    zstat = model.z_stat_fn or (lambda zz: jnp.concatenate(
        [jnp.asarray(leaf, jnp.float32).reshape(n, -1)
         for leaf in jax.tree.leaves(zz)], axis=1,
    ))
    k_rs, k_scan = jax.random.split(key)
    idx = systematic_resample(k_rs, jnp.asarray(log_weights), n)
    z = jax.tree.map(
        lambda a: constrain(jnp.take(a, idx, axis=0))[0], z
    )
    m, p = constrain(
        jnp.take(means, idx, axis=0), jnp.take(jnp.asarray(covs), idx, axis=0)
    )

    def step(carry, t):
        z, m, p, key = carry
        key, k_z = jax.random.split(key)
        z = model.z_trans_sample(k_z, z, t)
        a_t, b_t, q_t, _, _, _ = model.cond_params(z, t)
        m = jnp.einsum("nij,nj->ni", a_t, m) + b_t
        p = jnp.einsum("nij,njk,nlk->nil", a_t, p, a_t) + q_t
        mbar = jnp.mean(m, axis=0)
        dev = m - mbar
        cov = (jnp.mean(p, axis=0)
               + dev.T @ dev / jnp.asarray(float(n), m.dtype))
        return (z, m, p, key), (mbar, cov, jnp.mean(zstat(z), axis=0))

    t_idx = jnp.arange(t0, t0 + int(horizon))
    _, (ms, cs, zs) = jax.lax.scan(step, (z, m, p, k_scan), t_idx)
    return ms, cs, zs


def switching_model(trans_probs, A, b, Q, H, c, R, m0, P0,
                    init_probs=None):
    """Build the discrete-regime (mixture Kalman) case: z_t ∈ {0..K−1}
    follows a Markov chain with row-stochastic ``trans_probs`` (K, K),
    and every conditional matrix is the z-indexed slice of a stacked
    (K, ...) array — exactly the pieces a switching-SSM Gibbs fit
    (HMMKernel × LGSSKernel) already has.

    z_stats in the filter output are the filtered regime probabilities
    P(z_t = k | y_{1:t}) (weighted one-hots), shape (T, K).
    """
    trans_probs = jnp.asarray(trans_probs)
    k_n = trans_probs.shape[0]
    if trans_probs.shape != (k_n, k_n):
        raise ValueError(f"trans_probs must be (K, K), got "
                         f"{trans_probs.shape}")
    init = (jnp.full((k_n,), 1.0 / k_n) if init_probs is None
            else jnp.asarray(init_probs))
    log_trans = jnp.log(jnp.maximum(trans_probs, 1e-37))
    stacked = [jnp.asarray(x) for x in (A, b, Q, H, c, R)]
    for name, x in zip("AbQHcR", stacked):
        if x.shape[0] != k_n:
            raise ValueError(
                f"{name} must stack K={k_n} regime slices on axis 0, "
                f"got shape {x.shape}"
            )
    a_s, b_s, q_s, h_s, c_s, r_s = stacked

    def z_init_sample(key, n):
        return jax.random.categorical(
            key, jnp.log(jnp.maximum(init, 1e-37)), shape=(n,)
        )

    def z_trans_sample(key, z, t):
        return jax.random.categorical(key, log_trans[z], axis=-1)

    def cond_params(z, t):
        return (a_s[z], b_s[z], q_s[z], h_s[z], c_s[z], r_s[z])

    return RaoBlackwellSSM(
        z_init_sample, z_trans_sample, cond_params,
        jnp.asarray(m0), jnp.asarray(P0),
        z_stat_fn=lambda z: jax.nn.one_hot(z, k_n),
    )
