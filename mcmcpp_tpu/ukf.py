"""Unscented Kalman filter (+ unscented RTS smoother).

Julier & Uhlmann (1997); Wan & van der Merwe (2000): propagate 2D+1
deterministic sigma points through the nonlinear dynamics/observation
maps and moment-match — the derivative-free Gaussian filter that is
exact for linear models and 2nd-order accurate for smooth nonlinear
ones. Completes this framework's Gaussian-filter family:

- exact linear-Gaussian: ``models.lgss.kalman_filter`` (parallel-in-time)
- deterministic nonlinear, small/medium D: THIS module
- ensemble nonlinear, large D: ``enkf.ensemble_kalman_filter`` (EnKF/ETKF)
- full non-Gaussian: ``particle.particle_filter``

Accelerator shape: one ``lax.scan`` over time; each step is a (2D+1, D) batch
through the user's vectorized ``f``/``h`` plus small matmuls/Cholesky —
fixed shapes, no branches, fully differentiable in any parameters
closed over by the maps (the predictive loglik can drive gradient-based
hyperparameter inference exactly like ``lgss.lgss_loglik``).

No reference counterpart (the C++ library has no SSM tooling);
north-star scope.
"""

from typing import Callable, NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp


class UKFModel(NamedTuple):
    """Additive-noise nonlinear SSM spec. ``f``/``h`` are JAX-traceable
    and VECTORIZED over the leading sigma-point axis; ``t`` is the
    (traced) integer time index.

    f(x (S, D), t) -> (S, D)   dynamics mean map
    h(x (S, D), t) -> (S, E)   observation mean map
    Q (D, D), R (E, E)         additive process / observation noise
    m0 (D,), P0 (D, D)         prior on x_0 (filtered at t=0 with y_0)
    """

    f: Callable
    h: Callable
    Q: jnp.ndarray
    R: jnp.ndarray
    m0: jnp.ndarray
    P0: jnp.ndarray


class UKFResult(NamedTuple):
    loglik: jnp.ndarray          # scalar predictive log p(y_{1:T})
    means: jnp.ndarray           # (T, D) filtered E[x_t | y_{1:t}]
    covs: jnp.ndarray            # (T, D, D)
    pred_means: jnp.ndarray      # (T, D) one-step predictive means
    pred_covs: jnp.ndarray       # (T, D, D)


def _sigma_points(m, p_mat, lam, d):
    """(2D+1, D) scaled sigma points around (m, P)."""
    chol = jnp.linalg.cholesky(p_mat)
    scaled = jnp.sqrt(d + lam) * chol  # columns are the offsets
    offsets = jnp.concatenate([scaled.T, -scaled.T], axis=0)  # (2D, D)
    return jnp.concatenate([m[None, :], m[None, :] + offsets], axis=0)


def _weights(lam, d, alpha, beta):
    wm = jnp.full((2 * d + 1,), 0.5 / (d + lam))
    wm = wm.at[0].set(lam / (d + lam))
    wc = wm.at[0].set(lam / (d + lam) + (1.0 - alpha**2 + beta))
    return wm, wc


def unscented_kalman_filter(model: UKFModel, ys, alpha=1.0, beta=2.0,
                            kappa=0.0, joseph_jitter=1e-9):
    """Run the UKF over ``ys`` ((T, E); a (T,) vector is promoted).

    alpha, beta, kappa : standard scaled-unscented parameters
        (λ = α²(D+κ) − D). α=1, κ=0 spreads points at √D — numerically
        robust in f32; the classic tiny-α (1e-3) concentrates points
        and is prone to negative-definite moment matches in single
        precision.
    Returns :class:`UKFResult`. Convention matches the particle filter:
    ``y_0`` observes the PRIOR (m0, P0); the loglik is
    Σ_t log N(y_t; ŷ_t, S_t).
    """
    ys = jnp.asarray(ys)
    if ys.ndim == 1:
        ys = ys[:, None]
    m0 = jnp.asarray(model.m0)
    p0 = jnp.asarray(model.P0)
    q = jnp.asarray(model.Q)
    r = jnp.asarray(model.R)
    d = m0.shape[0]
    e = ys.shape[1]
    lam = alpha * alpha * (d + kappa) - d
    wm, wc = _weights(lam, d, alpha, beta)
    eye = jnp.eye(d, dtype=m0.dtype)
    log2pi = jnp.asarray(np.log(2.0 * np.pi), m0.dtype)

    def observe(m, p_mat, y, t):
        """Measurement update + predictive loglik at time t."""
        sig = _sigma_points(m, p_mat, lam, d)
        ysig = model.h(sig, t)                       # (2D+1, E)
        y_hat = wm @ ysig
        dy = ysig - y_hat[None, :]
        dx = sig - m[None, :]
        s_mat = jnp.einsum("s,si,sj->ij", wc, dy, dy) + r
        c_mat = jnp.einsum("s,si,sj->ij", wc, dx, dy)
        chol_s = jnp.linalg.cholesky(s_mat)
        innov = y - y_hat
        # gain via two triangular solves (never form S^-1)
        k_gain = jax.scipy.linalg.cho_solve((chol_s, True), c_mat.T).T
        m_new = m + k_gain @ innov
        p_new = p_mat - k_gain @ s_mat @ k_gain.T
        p_new = 0.5 * (p_new + p_new.T) + joseph_jitter * eye
        z = jax.scipy.linalg.solve_triangular(chol_s, innov, lower=True)
        ll = (-0.5 * jnp.sum(z * z)
              - jnp.sum(jnp.log(jnp.diagonal(chol_s)))
              - 0.5 * e * log2pi)
        return m_new, p_new, ll

    def predict(m, p_mat, t):
        sig = _sigma_points(m, p_mat, lam, d)
        fsig = model.f(sig, t)                       # (2D+1, D)
        m_pred = wm @ fsig
        dxp = fsig - m_pred[None, :]
        p_pred = jnp.einsum("s,si,sj->ij", wc, dxp, dxp) + q
        p_pred = 0.5 * (p_pred + p_pred.T)
        return m_pred, p_pred

    m_f, p_f, ll0 = observe(m0, p0, ys[0], 0)

    def step(carry, inp):
        m, p_mat = carry
        y, t = inp
        m_pred, p_pred = predict(m, p_mat, t)
        m_new, p_new, ll = observe(m_pred, p_pred, y, t)
        return (m_new, p_new), (ll, m_new, p_new, m_pred, p_pred)

    t_idx = jnp.arange(1, ys.shape[0])
    (_, _), (lls, ms, ps, mps, pps) = jax.lax.scan(
        step, (m_f, p_f), (ys[1:], t_idx)
    )
    return UKFResult(
        loglik=ll0 + jnp.sum(lls),
        means=jnp.concatenate([m_f[None], ms], axis=0),
        covs=jnp.concatenate([p_f[None], ps], axis=0),
        pred_means=jnp.concatenate([m0[None], mps], axis=0),
        pred_covs=jnp.concatenate([p0[None], pps], axis=0),
    )


def unscented_rts_smoother(model: UKFModel, ys=None,
                           filtered: Optional[UKFResult] = None,
                           alpha=1.0, beta=2.0, kappa=0.0):
    """Unscented Rauch–Tung–Striebel smoother (Särkkä 2008): backward
    pass over a :func:`unscented_kalman_filter` result using
    sigma-point cross-covariances. Returns ``(means (T, D),
    covs (T, D, D))`` of p(x_t | y_{1:T})."""
    if filtered is None:
        if ys is None:
            raise ValueError("pass ys= or filtered=")
        filtered = unscented_kalman_filter(
            model, ys, alpha=alpha, beta=beta, kappa=kappa
        )
    m0 = jnp.asarray(model.m0)
    q = jnp.asarray(model.Q)
    d = m0.shape[0]
    lam = alpha * alpha * (d + kappa) - d
    wm, wc = _weights(lam, d, alpha, beta)

    def back(carry, inp):
        m_s, p_s = carry
        m_f, p_f, t = inp                  # filtered at t, smoothing t+1
        sig = _sigma_points(m_f, p_f, lam, d)
        fsig = model.f(sig, t + 1)
        m_pred = wm @ fsig
        dx = sig - m_f[None, :]
        dxp = fsig - m_pred[None, :]
        p_pred = jnp.einsum("s,si,sj->ij", wc, dxp, dxp) + q
        c_mat = jnp.einsum("s,si,sj->ij", wc, dx, dxp)
        gain = jnp.linalg.solve(p_pred.T, c_mat.T).T
        m_new = m_f + gain @ (m_s - m_pred)
        p_new = p_f + gain @ (p_s - p_pred) @ gain.T
        p_new = 0.5 * (p_new + p_new.T)
        return (m_new, p_new), (m_new, p_new)

    t_n = filtered.means.shape[0]
    t_idx = jnp.arange(t_n - 1)
    (_, _), (ms, ps) = jax.lax.scan(
        back,
        (filtered.means[-1], filtered.covs[-1]),
        (filtered.means[:-1], filtered.covs[:-1], t_idx),
        reverse=True,
    )
    means = jnp.concatenate([ms, filtered.means[-1:][0][None]], axis=0)
    covs = jnp.concatenate([ps, filtered.covs[-1:][0][None]], axis=0)
    return means, covs
