"""Standard target distributions with analytic ground truth.

Each constructor returns a :class:`Target`: a JAX-traceable ``logp``
((P,) -> scalar), the dimension, and whatever moments are known in closed
form (for statistical-oracle tests, SURVEY.md §4 pattern).
"""

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import jax.nn
import jax.numpy as jnp
import jax.scipy.special


@dataclass(frozen=True)
class Target:
    """A target distribution: traceable logp + known truth (may be None)."""

    logp: Callable
    dim: int
    name: str
    mean: Optional[np.ndarray] = None
    cov: Optional[np.ndarray] = None
    extras: dict = field(default_factory=dict)


def skewed_gaussian(eps=0.13):
    """The reference's flagship test target
    (``test/sequential/SkewedGaussian/Common/SkewedGaussian.h:52-57``):
    logp = −½[(x/2 − y)²/eps + (x/2 + y)²]; true covariance
    [[1+eps, (1−eps)/2], [(1−eps)/2, (1+eps)/4]]
    (``.../MH/src/main.cpp:73-74``)."""

    def logp(t):
        a = t[0] / 2.0 - t[1]
        b = t[0] / 2.0 + t[1]
        return -0.5 * (a * a / eps + b * b)

    cov = np.array(
        [[1 + eps, (1 - eps) / 2], [(1 - eps) / 2, (1 + eps) / 4]]
    )
    return Target(logp, 2, "skewed_gaussian", np.zeros(2), cov,
                  {"eps": eps})


def correlated_gaussian(dim=10, rho=0.5, dtype=jnp.float32):
    """AR(1)-correlated standardized Gaussian: Σ_ij = rho^|i−j|.

    The benchmark target (BASELINE.md). Uses the precision Cholesky so the
    hot logp is a single small matmul."""
    idx = np.arange(dim)
    cov = rho ** np.abs(idx[:, None] - idx[None, :])
    prec_chol = jnp.asarray(
        np.linalg.cholesky(np.linalg.inv(cov)), dtype
    )

    def logp(t):
        y = t @ prec_chol
        return -0.5 * jnp.sum(y * y)

    return Target(logp, dim, "correlated_gaussian", np.zeros(dim), cov,
                  {"rho": rho})


def rosenbrock(a=1.0, b=100.0, scale=20.0):
    """2-D Rosenbrock "banana": logp = −[(a−x)² + b(y−x²)²]/scale.

    BASELINE.json config #3 (mover comparison target). The y-integral is
    constant in x, so the x-marginal is exactly N(a, scale/2):
    E[x] = a, Var[x] = scale/2, E[y] = E[x²] = a² + scale/2; also
    E[y − x²] = 0 with Var[y − x²] = scale/(2b)."""

    def logp(t):
        x, y = t[0], t[1]
        return -((a - x) ** 2 + b * (y - x * x) ** 2) / scale

    var_x = scale / 2.0
    mean = np.array([a, a * a + var_x])
    return Target(logp, 2, "rosenbrock", mean, None,
                  {"a": a, "b": b, "scale": scale, "var_x": var_x})


def gaussian_mixture(means, weights=None, scales=None):
    """Isotropic Gaussian mixture (BASELINE.json config #4: multimodal
    target for convergence/ACT analysis).

    means: (K, P); weights: (K,) (default uniform); scales: (K,) std devs
    (default 1). Mixture mean/cov are computed analytically."""
    means = np.atleast_2d(np.asarray(means, np.float64))
    k, p = means.shape
    weights = (np.full(k, 1.0 / k) if weights is None
               else np.asarray(weights, np.float64))
    weights = weights / weights.sum()
    scales = (np.ones(k) if scales is None
              else np.asarray(scales, np.float64))
    mj = jnp.asarray(means, jnp.float32)
    wj = jnp.asarray(np.log(weights), jnp.float32)
    sj = jnp.asarray(scales, jnp.float32)

    def logp(t):
        d = (t[None, :] - mj) / sj[:, None]  # (K, P)
        comp = (
            wj
            - 0.5 * jnp.sum(d * d, axis=1)
            - p * jnp.log(sj)
        )
        return jax.scipy.special.logsumexp(comp)

    mean = weights @ means
    cov = np.zeros((p, p))
    for j in range(k):
        dm = (means[j] - mean)[:, None]
        cov += weights[j] * (scales[j] ** 2 * np.eye(p) + dm @ dm.T)
    return Target(logp, p, "gaussian_mixture", mean, cov,
                  {"weights": weights, "scales": scales,
                   "means": means})


def neal_funnel(dim=10, sigma_v=3.0):
    """Neal's funnel: v ~ N(0, σᵥ²), xᵢ | v ~ N(0, eᵛ). θ = (v, x₁..x_{P−1}).

    Stress target for gradient samplers (strong scale coupling).
    E[θ] = 0; Var[v] = σᵥ², Var[xᵢ] = E[eᵛ] = exp(σᵥ²/2)."""

    def logp(t):
        v, x = t[0], t[1:]
        lp_v = -0.5 * (v / sigma_v) ** 2
        lp_x = -0.5 * jnp.sum(x * x) * jnp.exp(-v) - 0.5 * (dim - 1) * v
        return lp_v + lp_x

    var = np.full(dim, np.exp(sigma_v**2 / 2.0))
    var[0] = sigma_v**2
    return Target(logp, dim, "neal_funnel", np.zeros(dim), np.diag(var),
                  {"sigma_v": sigma_v})


def bayesian_linear_regression(n_data=200, dim=5, noise=0.5, prior_scale=10.0,
                               seed=0, dtype=jnp.float32):
    """Bayesian linear regression with conjugate Gaussian ground truth.

    y = X w + eps, eps ~ N(0, noise^2), prior w ~ N(0, prior_scale^2 I):
    posterior is EXACTLY N(mu_n, Sigma_n) with
    Sigma_n = (X'X/noise^2 + I/prior_scale^2)^-1, mu_n = Sigma_n X'y/noise^2
    — the strongest possible oracle for sampler/VI/Laplace parity tests.
    The logp is one (n, P) matvec per evaluation (matmul-friendly)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_data, dim))
    w_true = rng.normal(size=dim)
    y = x @ w_true + noise * rng.normal(size=n_data)
    prec_n = x.T @ x / noise**2 + np.eye(dim) / prior_scale**2
    cov_n = np.linalg.inv(prec_n)
    mu_n = cov_n @ (x.T @ y) / noise**2
    xj = jnp.asarray(x, dtype)
    yj = jnp.asarray(y, dtype)

    def logp(t):
        r = yj - xj @ t
        return (-0.5 * jnp.sum(r * r) / noise**2
                - 0.5 * jnp.sum(t * t) / prior_scale**2)

    return Target(logp, dim, "bayesian_linear_regression", mu_n, cov_n,
                  {"w_true": w_true, "X": x, "y": y, "noise": noise})


def logistic_regression(n_data=300, dim=4, prior_scale=2.5, seed=0,
                        dtype=jnp.float32):
    """Bayesian logistic regression on synthetic separable-ish data.

    No closed-form posterior; the Laplace approximation around the MAP is
    the reference oracle (accurate to O(1/n) here), enabling cross-engine
    consistency tests (MCMC mean vs Laplace mean). logp is one matvec +
    ``log_sigmoid`` reduction — matmul + elementwise friendly."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_data, dim))
    w_true = rng.normal(size=dim)
    p = 1.0 / (1.0 + np.exp(-(x @ w_true)))
    y = (rng.uniform(size=n_data) < p).astype(np.float64)
    xj = jnp.asarray(x, dtype)
    sj = jnp.asarray(2.0 * y - 1.0, dtype)  # labels in {-1, +1}

    def logp(t):
        logits = sj * (xj @ t)
        return (jnp.sum(jax.nn.log_sigmoid(logits))
                - 0.5 * jnp.sum(t * t) / prior_scale**2)

    return Target(logp, dim, "logistic_regression", None, None,
                  {"w_true": w_true, "X": x, "y": y,
                   "prior_scale": prior_scale})
