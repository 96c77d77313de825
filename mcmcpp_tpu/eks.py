"""Ensemble Kalman inversion (EKI) and the Ensemble Kalman Sampler (EKS).

Gradient-FREE inference for inverse problems ``y = G(θ) + N(0, Γ)`` with
a Gaussian prior ``θ ~ N(m0, C0)``, using only forward evaluations of
``G`` — the derivative-free regime where the ensemble/particle engines
here need a likelihood and the gradient engines need ∇G:

- :func:`ensemble_kalman_inversion` (Iglesias, Law & Stuart 2013):
  iterative ensemble Kalman updates collapse the ensemble onto a
  regularized least-squares solution — the OPTIMIZER. This
  implementation follows the adaptive-stepsize (continuous-time limit)
  form with covariance localization-free preconditioning.
- :func:`ensemble_kalman_sampler` (Garbuno-Iñigo, Hoffmann, Li & Stuart
  2020, "Interacting Langevin diffusions"): ensemble-preconditioned
  Langevin dynamics whose invariant measure is the POSTERIOR — exact in
  the linear-G, J→∞ limit (the oracle the tests pin), a controlled
  approximation otherwise. The prior term is handled by the paper's
  linearly-implicit split-step, so stiff priors don't constrain Δt.

Accelerator shape: the interaction terms are (J, E)/(J, P) matmuls — the whole
update is matmul work with no branches; J (ensemble size) is the shardable
axis (``mesh=``, same contract as SVGD/EnKF). Each call runs its whole
iteration loop in one ``lax.scan`` launch.

No reference counterpart (the C++ library has no forward-model
tooling); north-star scope. Complements ``enkf.py`` (state filtering)
— this module is the PARAMETER-space member of the ensemble-Kalman
family.
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp


class EKIResult(NamedTuple):
    theta: jnp.ndarray        # (P,) ensemble-mean estimate
    ensemble: jnp.ndarray     # (J, P) final ensemble (collapsed for EKI)
    misfit_trace: jnp.ndarray  # (n_iters,) mean data misfit Φ per iter


class EKSResult(NamedTuple):
    ensemble: jnp.ndarray     # (J, P) posterior-approximating ensemble
    mean: jnp.ndarray         # (P,)
    cov: jnp.ndarray          # (P, P) ensemble covariance
    misfit_trace: jnp.ndarray  # (n_iters,)


def _validate(forward, y, gamma, n_ensemble):
    y = jnp.asarray(y)
    if y.ndim != 1:
        raise ValueError("y must be a flat (E,) observation vector")
    gamma = jnp.asarray(gamma)
    if gamma.ndim == 1:
        gamma = jnp.diag(gamma)
    if gamma.shape != (y.shape[0], y.shape[0]):
        raise ValueError("gamma must be (E, E) (or a (E,) diagonal)")
    if int(n_ensemble) < 3:
        raise ValueError("need n_ensemble >= 3")
    return y, gamma


def ensemble_kalman_inversion(key, forward, y, gamma, prior_mean,
                              prior_cov, n_ensemble=128, n_iters=30,
                              dt0=1.0, mesh=None):
    """EKI: derivative-free MAP-style point estimation.

    forward : (J, P) -> (J, E), JAX-traceable, vectorized over the
        ensemble axis (the only thing evaluated — no gradients).
    y, gamma : observation (E,) and noise covariance (E, E) (or (E,)
        diagonal).
    prior_mean, prior_cov : N(m0, C0) initial-ensemble sampler; EKI's
        iterates stay in the span of the initial ensemble (the
        subspace property), so C0 doubles as the regularizer.
    dt0 : base step; the effective step is ``dt0 / (||D||_F + eps)``
        (the standard adaptive normalization — keeps early large-misfit
        steps stable).

    Returns :class:`EKIResult`; ``misfit_trace`` should decrease.
    """
    from mcmcpp_tpu.parallel.mesh import particle_constrainer

    y, gamma = _validate(forward, y, gamma, n_ensemble)
    j_n = int(n_ensemble)
    m0 = jnp.asarray(prior_mean)
    c0 = jnp.asarray(prior_cov)
    if c0.ndim == 1:
        c0 = jnp.diag(c0)
    chol0 = jnp.linalg.cholesky(c0)
    gamma_chol = jnp.linalg.cholesky(gamma)
    constrain = particle_constrainer(mesh, j_n, name="n_ensemble")

    z = jax.random.normal(key, (j_n, m0.shape[0]), m0.dtype)
    (theta0,) = constrain(m0[None, :] + z @ chol0.T)

    def whiten_obs(r):  # Γ^{-1/2} r, batched over rows
        return jax.scipy.linalg.solve_triangular(
            gamma_chol, r.T, lower=True
        ).T

    def step(theta, _):
        g = forward(theta)                          # (J, E)
        g_bar = jnp.mean(g, axis=0)
        t_bar = jnp.mean(theta, axis=0)
        dg_w = whiten_obs(g - g_bar[None, :])       # (J, E) whitened
        resid_w = whiten_obs(g - y[None, :])        # (J, E)
        # D[j, k] = <g_k - ḡ, Γ^{-1}(g_j - y)> / J — the interaction
        d_mat = resid_w @ dg_w.T / j_n              # (J, J)
        dt = dt0 / (jnp.linalg.norm(d_mat) + 1e-8)
        theta = theta - dt * d_mat @ (theta - t_bar[None, :])
        (theta,) = constrain(theta)
        misfit = 0.5 * jnp.mean(jnp.sum(resid_w**2, axis=1))
        return theta, misfit

    theta, misfits = jax.lax.scan(step, theta0, None, length=int(n_iters))
    return EKIResult(jnp.mean(theta, axis=0), theta, misfits)


def ensemble_kalman_sampler(key, forward, y, gamma, prior_mean,
                            prior_cov, n_ensemble=256, n_iters=800,
                            dt0=0.3, mesh=None):
    """EKS: derivative-free POSTERIOR sampling (module docstring).

    Per iteration (Garbuno-Iñigo et al. 2020, eqs. 4.3-4.6): the data
    misfit drifts through the SAME D-matrix interaction as EKI, the
    prior drift is applied by the linearly-implicit solve
    ``(I + Δt C(θ) C0^{-1}) θ* = ...``, and ensemble-preconditioned
    noise ``N(0, 2Δt C(θ))`` makes the dynamics ergodic for the
    posterior, and the Nüsken–Reich finite-ensemble drift correction
    ``+Δt (P+1)/J (θ_j − θ̄)`` (ALDI; Garbuno-Iñigo, Nüsken & Reich
    2020) removes the O(1/J) bias. Linear-G oracle: the final
    ensemble's mean/cov match the conjugate Gaussian posterior
    (tests/test_eks.py).

    Discretization bias is O(Δt) and measured (linear 3-parameter
    oracle, J=2048): posterior-variance ratio 1.8 at dt0=1.0, 1.12 at
    0.3, 1.06 at 0.1 — the 0.3 default trades ~10% variance inflation
    for iteration count; shrink ``dt0`` (and raise ``n_iters``) when
    calibrated spread matters more than wall time.

    Returns :class:`EKSResult`.
    """
    from mcmcpp_tpu.parallel.mesh import particle_constrainer

    y, gamma = _validate(forward, y, gamma, n_ensemble)
    j_n = int(n_ensemble)
    m0 = jnp.asarray(prior_mean)
    p_dim = m0.shape[0]
    c0 = jnp.asarray(prior_cov)
    if c0.ndim == 1:
        c0 = jnp.diag(c0)
    c0_inv = jnp.linalg.inv(c0)
    chol0 = jnp.linalg.cholesky(c0)
    gamma_chol = jnp.linalg.cholesky(gamma)
    constrain = particle_constrainer(mesh, j_n, name="n_ensemble")
    k_init, k_scan = jax.random.split(jnp.asarray(key))

    z = jax.random.normal(k_init, (j_n, p_dim), m0.dtype)
    (theta0,) = constrain(m0[None, :] + z @ chol0.T)
    eye = jnp.eye(p_dim, dtype=m0.dtype)

    def whiten_obs(r):
        return jax.scipy.linalg.solve_triangular(
            gamma_chol, r.T, lower=True
        ).T

    def step(carry, _):
        theta, key = carry
        key, k_noise = jax.random.split(key)
        g = forward(theta)
        g_bar = jnp.mean(g, axis=0)
        t_bar = jnp.mean(theta, axis=0)
        centered = theta - t_bar[None, :]
        c_theta = centered.T @ centered / j_n        # (P, P)
        dg_w = whiten_obs(g - g_bar[None, :])
        resid_w = whiten_obs(g - y[None, :])
        d_mat = resid_w @ dg_w.T / j_n
        dt = dt0 / (jnp.linalg.norm(d_mat) + 1e-8)
        drift = (theta - dt * d_mat @ centered
                 + dt * ((p_dim + 1.0) / j_n) * centered)
        # linearly-implicit prior step: solve (I + dt C(θ) C0^{-1}) θ*
        # = drift + dt C(θ) C0^{-1} m0  — unconditionally stable in the
        # prior stiffness (the paper's split-step)
        a_mat = eye + dt * c_theta @ c0_inv
        rhs = drift + dt * (c_theta @ (c0_inv @ m0))[None, :]
        theta_star = jnp.linalg.solve(a_mat, rhs.T).T
        # ensemble-preconditioned noise: N(0, 2 dt C(θ)) via the
        # ensemble square root — exact covariance, rank J-1 like C(θ)
        xi = jax.random.normal(k_noise, (j_n, j_n), m0.dtype)
        noise = jnp.sqrt(2.0 * dt / j_n) * xi @ centered
        theta_new = theta_star + noise
        (theta_new,) = constrain(theta_new)
        misfit = 0.5 * jnp.mean(jnp.sum(resid_w**2, axis=1))
        return (theta_new, key), misfit

    (theta, _), misfits = jax.lax.scan(
        step, (theta0, k_scan), None, length=int(n_iters)
    )
    mean = jnp.mean(theta, axis=0)
    centered = theta - mean[None, :]
    cov = centered.T @ centered / (j_n - 1)
    return EKSResult(theta, mean, cov, misfits)
