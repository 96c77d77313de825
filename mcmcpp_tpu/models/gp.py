"""Gaussian-process kernel library: composable covariance functions.

Building blocks for the latent-GP engines (``EllipticalSliceSampler``,
``BlockedGibbsSampler`` + ``GaussianInterweaveKernel``) and for marginal-
likelihood work (``gp_log_marginal``). Beyond-reference scope (the C++
library has no prior-structure-aware machinery).

Kernels are callables ``k(x1, x2) -> (N1, N2)`` over coordinate arrays of
shape ``(N,)`` or ``(N, D)``; they compose with ``+`` and ``*`` and are
JAX-traceable end to end, so hyperparameters can be live sampler values
(gradients flow through ``gram_cholesky`` into HMC kernels).

    k = RBF(lengthscale=l, variance=a) + WhiteNoise(1e-4)
    L = gram_cholesky(k, xs)            # chol(K + jitter I)
    logml = gp_log_marginal(k, xs, y, noise=0.1)
"""

import math

import numpy as np
import jax
import jax.numpy as jnp


def _sqdist(x1, x2):
    x1 = jnp.atleast_2d(jnp.asarray(x1).T).T  # (N, D)
    x2 = jnp.atleast_2d(jnp.asarray(x2).T).T
    d = x1[:, None, :] - x2[None, :, :]
    return jnp.sum(d * d, axis=-1)


class Kernel:
    """Base: implements ``__call__(x1, x2) -> (N1, N2)`` (CROSS
    covariance — white noise is zero here), ``gram(x)`` (the training
    Gram, where white noise lives on the diagonal) and ``diag(x)``
    (prior variances without materializing an (M, M) matrix). Composes
    with ``+`` (sum) and ``*`` (product)."""

    def __call__(self, x1, x2):
        raise NotImplementedError

    def gram(self, x):
        return self(x, x)

    def diag(self, x):
        x = jnp.atleast_2d(jnp.asarray(x).T).T
        return jnp.broadcast_to(
            jnp.asarray(self.variance, x.dtype), (x.shape[0],)
        )

    def __add__(self, other):
        return _Sum(self, other)

    def __mul__(self, other):
        return _Product(self, other)


class _Sum(Kernel):
    def __init__(self, a, b):
        self.a, self.b = a, b

    def __call__(self, x1, x2):
        return self.a(x1, x2) + self.b(x1, x2)

    def gram(self, x):
        return self.a.gram(x) + self.b.gram(x)

    def diag(self, x):
        return self.a.diag(x) + self.b.diag(x)


class _Product(Kernel):
    def __init__(self, a, b):
        self.a, self.b = a, b

    def __call__(self, x1, x2):
        return self.a(x1, x2) * self.b(x1, x2)

    def gram(self, x):
        return self.a.gram(x) * self.b.gram(x)

    def diag(self, x):
        return self.a.diag(x) * self.b.diag(x)


class RBF(Kernel):
    """Squared-exponential: variance · exp(−r²/(2ℓ²))."""

    def __init__(self, lengthscale=1.0, variance=1.0):
        self.lengthscale, self.variance = lengthscale, variance

    def __call__(self, x1, x2):
        r2 = _sqdist(x1, x2)
        return self.variance * jnp.exp(
            -0.5 * r2 / self.lengthscale**2
        )


class Matern12(Kernel):
    """Exponential (Ornstein-Uhlenbeck): variance · exp(−r/ℓ)."""

    def __init__(self, lengthscale=1.0, variance=1.0):
        self.lengthscale, self.variance = lengthscale, variance

    def __call__(self, x1, x2):
        r = jnp.sqrt(_sqdist(x1, x2) + 1e-36)
        return self.variance * jnp.exp(-r / self.lengthscale)


class Matern32(Kernel):
    """Matérn ν=3/2 (once-differentiable sample paths)."""

    def __init__(self, lengthscale=1.0, variance=1.0):
        self.lengthscale, self.variance = lengthscale, variance

    def __call__(self, x1, x2):
        r = jnp.sqrt(_sqdist(x1, x2) + 1e-36)
        z = math.sqrt(3.0) * r / self.lengthscale
        return self.variance * (1.0 + z) * jnp.exp(-z)


class Matern52(Kernel):
    """Matérn ν=5/2 (twice-differentiable sample paths)."""

    def __init__(self, lengthscale=1.0, variance=1.0):
        self.lengthscale, self.variance = lengthscale, variance

    def __call__(self, x1, x2):
        r = jnp.sqrt(_sqdist(x1, x2) + 1e-36)
        z = math.sqrt(5.0) * r / self.lengthscale
        return self.variance * (1.0 + z + z * z / 3.0) * jnp.exp(-z)


class Periodic(Kernel):
    """Exp-sine-squared: variance · exp(−2 sin²(π r / period) / ℓ²)."""

    def __init__(self, period=1.0, lengthscale=1.0, variance=1.0):
        self.period = period
        self.lengthscale, self.variance = lengthscale, variance

    def __call__(self, x1, x2):
        r = jnp.sqrt(_sqdist(x1, x2) + 1e-36)
        s = jnp.sin(jnp.pi * r / self.period)
        return self.variance * jnp.exp(
            -2.0 * s * s / self.lengthscale**2
        )


class Linear(Kernel):
    """Dot-product kernel: variance · ⟨x1, x2⟩ (Bayesian linear maps)."""

    def __init__(self, variance=1.0):
        self.variance = variance

    def __call__(self, x1, x2):
        x1 = jnp.atleast_2d(jnp.asarray(x1).T).T
        x2 = jnp.atleast_2d(jnp.asarray(x2).T).T
        return self.variance * (x1 @ x2.T)

    def diag(self, x):
        x = jnp.atleast_2d(jnp.asarray(x).T).T
        return self.variance * jnp.sum(x * x, axis=-1)


class WhiteNoise(Kernel):
    """iid noise: variance · I on the GRAM diagonal (same observation),
    ZERO cross-covariance — including between distinct observations that
    share a coordinate (repeated-measurement designs) and between
    training and prediction points. Triggering on coincident coordinates
    instead would make predictions interpolate the noise."""

    def __init__(self, variance=1e-6):
        self.variance = variance

    def __call__(self, x1, x2):
        r2 = _sqdist(x1, x2)
        return jnp.zeros_like(r2)

    def gram(self, x):
        x = jnp.atleast_2d(jnp.asarray(x).T).T
        return self.variance * jnp.eye(x.shape[0])


def gram_cholesky(kernel, xs, jitter=1e-6, max_tries=5):
    """Lower Cholesky of gram(xs) + jitter·I — the ``prior_chol`` input
    for the elliptical-slice / interweave kernels.

    Robustness: an accelerator's blocked f32 Cholesky can NaN on
    ill-conditioned RBF grams that CPU LAPACK survives at the same jitter
    (e.g. a 48-point unit-interval RBF with l≈0.8 at jitter=1e-5 — it is
    the factorization itself, not matmul precision). So the
    factorization retries with 10× jitter while any NaN appears, up to
    ``max_tries`` escalations (the standard GPML safeguard), inside a
    ``lax.while_loop`` so the function stays jittable with
    hyperparameter-dependent grams.

    Differentiability: the escalation PROBE runs on a stop-gradient
    copy (a while_loop is not reverse-differentiable), then ONE
    differentiable factorization runs at the selected jitter — the
    level is a discrete, locally-constant choice, so gradients through
    the returned factor are exact a.e. Cost: one extra forward-only
    Cholesky next to the differentiated one.
    """
    k = kernel.gram(xs)
    n = k.shape[0]
    eye = jnp.eye(n, dtype=k.dtype)
    k_ng = jax.lax.stop_gradient(k)

    def cond(carry):
        i, chol = carry
        return (i < max_tries) & jnp.any(jnp.isnan(chol))

    def body(carry):
        i, _ = carry
        j = jitter * (10.0 ** (i + 1.0))
        return i + 1, jnp.linalg.cholesky(k_ng + j * eye)

    tries, _ = jax.lax.while_loop(
        cond, body,
        (jnp.int32(0), jnp.linalg.cholesky(k_ng + jitter * eye)),
    )
    j = jitter * (10.0 ** tries.astype(k.dtype))
    return jnp.linalg.cholesky(k + j * eye)


def gp_log_marginal(kernel, xs, y, noise, jitter=1e-6):
    """Exact GP log marginal likelihood log N(y; 0, K + noise² I) — the
    hyperparameter objective / oracle (Rasmussen & Williams 2006 eq 2.30).
    """
    y = jnp.asarray(y)
    n = y.shape[0]
    k = kernel.gram(xs) + (noise**2 + jitter) * jnp.eye(n)
    chol = jnp.linalg.cholesky(k)
    w = jax.scipy.linalg.solve_triangular(chol, y, lower=True)
    return (-0.5 * jnp.sum(w * w)
            - jnp.sum(jnp.log(jnp.diagonal(chol)))
            - n / 2 * jnp.log(2.0 * jnp.pi))


def gp_predict(kernel, xs, y, x_new, noise, jitter=1e-6):
    """Exact GP posterior mean and variance at ``x_new`` given
    observations ``(xs, y)`` with iid noise (R&W 2006 eqs 2.25-2.26).
    Cross-covariances use the noise-free ``kernel(xs, x_new)``; prior
    variances at ``x_new`` come from ``kernel.diag`` (O(M), no (M, M)
    temporary)."""
    y = jnp.asarray(y)
    n = y.shape[0]
    k = kernel.gram(xs) + (noise**2 + jitter) * jnp.eye(n)
    chol = jnp.linalg.cholesky(k)
    k_star = kernel(xs, x_new)  # (N, M)
    alpha = jax.scipy.linalg.cho_solve((chol, True), y)
    mean = k_star.T @ alpha
    v = jax.scipy.linalg.solve_triangular(chol, k_star, lower=True)
    var = kernel.diag(x_new) - jnp.sum(v * v, axis=0)
    return mean, jnp.maximum(var, 0.0)
