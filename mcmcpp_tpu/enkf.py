"""Ensemble Kalman filter (stochastic EnKF with perturbed observations).

Evensen (1994); Burgers, van Leeuwen & Evensen (1998). The
data-assimilation workhorse for HIGH-DIMENSIONAL state tracking: where
the particle filter collapses past a few dozen dimensions (weight
degeneracy) and the exact Kalman filter needs linear dynamics, the EnKF
propagates an ensemble through ANY nonlinear forecast model and applies
a linear (Kalman) analysis update built from ensemble sample
covariances. The cost is bias: the update is exact only for
linear-Gaussian models (where it converges to the Kalman filter as
N → ∞, oracle-tested); for nonlinear models it is the standard
Gaussian-approximation trade every operational DA system makes.

No reference counterpart (jmatta1/MCMCpp has no sequential machinery —
its model surface is the scalar ``calcLogPostProb``,
``MCMCpp/EnsembleSampler.h:80-96``); north-star scope completing the
filtering matrix: exact-linear (lgss) × sampling (particle) ×
marginalized-mixture (rbpf) × ensemble-Gaussian (this module).

Accelerator-native design
-----------------
The analysis step is nothing but matmuls on the (N, D) ensemble block:
anomaly products ``Xaᵀ Ya / (N−1)``, one (E, E) Cholesky, and a rank-N
update — exactly the matrix units' diet, with no per-member control flow. Time
is a single ``lax.scan``; N and D can both be large (the (D, D) state
covariance is NEVER formed — only (D, E) and (E, E) products).
Multiplicative covariance inflation is a scalar multiply on anomalies;
distance-based localization is intentionally out of scope (it needs
model-specific structure; supply inflated ensembles instead).
"""

from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import jax
import jax.numpy as jnp


class EnKFModel(NamedTuple):
    """Forecast/observation spec. Hooks are JAX-traceable, vectorized
    over the leading ensemble axis; ``t`` is the traced time index.

    init_sample(key, n) -> (n, D)      draw the initial ensemble
    trans_sample(key, x, t) -> (n, D)  the (nonlinear) forecast model,
        INCLUDING process noise (deterministic models: return f(x) and
        rely on inflation to keep spread)
    obs_fn(x, t) -> (n, E)             the observation operator H(x)
    obs_cov: (E, E) observation-noise covariance R (additive Gaussian —
        the EnKF's structural assumption)
    """

    init_sample: Callable
    trans_sample: Callable
    obs_fn: Callable
    obs_cov: jnp.ndarray


class EnKFResult(NamedTuple):
    loglik: jnp.ndarray    # scalar Σ_t log N(y_t; ŷ_t, S_t) — Gaussian
    #                        predictive approximation (exact-Kalman limit
    #                        in the linear case; a diagnostic otherwise)
    means: jnp.ndarray     # (T, D) analysis-ensemble means
    spread: jnp.ndarray    # (T, D) analysis-ensemble standard deviations
    ensemble: jnp.ndarray  # (N, D) final analysis ensemble


def ensemble_kalman_filter(key, model: EnKFModel, ys, n_ensemble,
                           inflation=1.0, mesh=None,
                           variant="stochastic"):
    """Stochastic EnKF over ``ys`` ((T, E); (T,) promoted to (T, 1)).

    Per step: forecast every member through ``trans_sample``, then the
    perturbed-observation analysis — Kalman gain from ensemble anomaly
    products, each member updated toward its own noise-perturbed copy of
    y_t (Burgers et al. 1998: the perturbation is what makes the
    analysis ensemble's covariance unbiased for the posterior
    covariance). ``inflation`` multiplies forecast anomalies (standard
    spread-loss compensation; 1.00–1.10 typical).

    ``loglik`` accumulates the Gaussian predictive density
    log N(y_t; mean(H x), S_t) with S_t the ensemble innovation
    covariance — the exact marginal likelihood in the linear-Gaussian
    limit (tests/test_enkf.py oracle) and the standard EnKF model-
    evidence proxy otherwise.

    ``mesh=``: shard the member axis over the mesh — forecasts are
    member-local; the anomaly products ``Xaᵀ Ya`` become mesh
    all-reduces of per-shard matmul partials (GSPMD inserts them;
    CPU-mesh parity tested).

    ``variant="etkf"``: the deterministic ensemble-transform (square-
    root) analysis (Bishop et al. 2001; Hunt et al. 2007): instead of
    perturbing observations, the analysis anomalies are the forecast
    anomalies times the SYMMETRIC square root of
    ``[(N−1)I + Yaᵀ R⁻¹ Ya]⁻¹`` in ensemble space — the analysis
    covariance is matched EXACTLY (no sampling noise from observation
    perturbations), which is why ETKF dominates at small N. Costs one
    (N, N) eigendecomposition per step; prefer it when N ≲ a few
    hundred, the stochastic variant when N is huge.
    """
    ys = jnp.asarray(ys)
    if ys.ndim == 1:
        ys = ys[:, None]
    n = int(n_ensemble)
    if n < 2:
        raise ValueError("EnKF needs n_ensemble >= 2")
    r_cov = jnp.asarray(model.obs_cov)
    if r_cov.ndim == 0:
        r_cov = r_cov[None, None]
    e_dim = r_cov.shape[0]
    if r_cov.shape != (e_dim, e_dim) or ys.shape[1] != e_dim:
        raise ValueError(
            f"obs_cov {r_cov.shape} inconsistent with ys {ys.shape}"
        )
    if variant not in ("stochastic", "etkf"):
        raise ValueError(f"unknown variant {variant!r}")
    r_chol = jnp.linalg.cholesky(r_cov)
    infl = jnp.asarray(inflation, jnp.float32)
    k_init, k_scan = jax.random.split(key)
    from mcmcpp_tpu.parallel.mesh import particle_constrainer

    _constrain = particle_constrainer(mesh, n, name="n_ensemble")
    constrain = lambda x: _constrain(x)[0]

    def analysis(key, x, y, t):
        """Perturbed-observation update; returns (x', step_loglik)."""
        x_mean = jnp.mean(x, axis=0)
        xa = (x - x_mean) * infl
        x = x_mean + xa
        yf = model.obs_fn(x, t)                       # (n, E)
        y_mean = jnp.mean(yf, axis=0)
        ya = yf - y_mean
        pyy = ya.T @ ya / (n - 1.0) + r_cov           # (E, E)
        pxy = xa.T @ ya / (n - 1.0)                   # (D, E)
        chol = jnp.linalg.cholesky(pyy)
        innov = y - y_mean
        v = jax.scipy.linalg.solve_triangular(chol, innov, lower=True)
        step_ll = (
            -0.5 * jnp.sum(v * v)
            - jnp.sum(jnp.log(jnp.diagonal(chol)))
            - 0.5 * e_dim * np.log(2.0 * np.pi)
        )
        if variant == "etkf":
            # ensemble-space transform (Hunt et al. 2007): S = R^{-1/2}Yaᵀ
            s = jax.scipy.linalg.solve_triangular(
                r_chol, ya.T, lower=True
            )                                          # (E, n)
            a_mat = (n - 1.0) * jnp.eye(n, dtype=x.dtype) + s.T @ s
            evals, evecs = jnp.linalg.eigh(a_mat)      # (n,), (n, n)
            evals = jnp.maximum(evals, 1e-8)
            a_inv = (evecs / evals) @ evecs.T
            w_mean = a_inv @ (s.T @ jax.scipy.linalg.solve_triangular(
                r_chol, innov, lower=True
            ))                                         # (n,)
            w_sqrt = (evecs * jnp.sqrt((n - 1.0) / evals)) @ evecs.T
            x_new = x_mean[None, :] + (
                w_mean[None, :] + w_sqrt
            ) @ xa                                     # (n, D)
            return constrain(x_new), step_ll
        # member-wise perturbed innovations: y + eps_i - H(x_i)
        eps = jax.random.normal(key, (n, e_dim), x.dtype) @ r_chol.T
        resid = (y[None, :] + eps) - yf               # (n, E)
        gain_t = jax.scipy.linalg.cho_solve((chol, True), pxy.T)  # (E, D)
        x_new = constrain(x + resid @ gain_t)         # (n, D)
        return x_new, step_ll

    x0 = constrain(model.init_sample(k_init, n))
    k_scan, k0 = jax.random.split(k_scan)
    x0, ll0 = analysis(k0, x0, ys[0], jnp.int32(0))

    def step(carry, inp):
        x, key = carry
        y, t = inp
        key, k_f, k_a = jax.random.split(key, 3)
        x = model.trans_sample(k_f, x, t)
        x, step_ll = analysis(k_a, x, y, t)
        return (x, key), (step_ll, jnp.mean(x, axis=0),
                          jnp.std(x, axis=0))

    t_idx = jnp.arange(1, ys.shape[0])
    (x, _), (lls, means, spreads) = jax.lax.scan(
        step, (x0, k_scan), (ys[1:], t_idx)
    )
    return EnKFResult(
        ll0 + jnp.sum(lls),
        jnp.concatenate([jnp.mean(x0, axis=0)[None], means], axis=0),
        jnp.concatenate([jnp.std(x0, axis=0)[None], spreads], axis=0),
        x,
    )
