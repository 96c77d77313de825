"""Covariance / correlation matrices over chain samples.

Rebuild of ``MCMCpp/Analysis/CovarianceMatrix.h``: the reference makes a
single Kahan-compensated pass over step iterators (:233-260) with an
optional slice interval to de-correlate samples (:154-174). Here the sums
are float64 (compensation unnecessary) and the heavy lifting is one
``X.T @ X`` — one matmul when run on device.
"""

import numpy as np
import jax
import jax.numpy as jnp


def covariance_matrix(samples, thin=1, burn_in=0):
    """Covariance over all (step, walker) rows.

    samples: (S, W, P) or (N, P). ``thin``/``burn_in`` subsample steps
    before accumulating (≙ CovarianceMatrix.h:154-174).
    """
    arr = np.asarray(samples)
    if arr.ndim == 3:
        arr = arr[burn_in::thin].reshape(-1, arr.shape[-1])
    elif arr.ndim == 2:
        arr = arr[burn_in::thin]
    else:
        raise ValueError("samples must be (S, W, P) or (N, P)")
    if arr.dtype == np.float64 and not jax.config.jax_enable_x64:
        # keep full precision on host rather than silently truncating
        return np.cov(arr.T, ddof=1).reshape(arr.shape[1], arr.shape[1])
    x = jnp.asarray(arr)
    n = x.shape[0]
    mean = jnp.mean(x, axis=0)
    xc = x - mean[None, :]
    # HIGHEST keeps the f32 matmul in true f32 (the default precision may
    # run as TF32 or bf16 passes — worse than the Kahan sums this replaces)
    cov = jnp.matmul(xc.T, xc, precision=jax.lax.Precision.HIGHEST) / (n - 1)
    return np.asarray(cov, np.float64)


def correlation_matrix(samples, thin=1, burn_in=0):
    """Correlation matrix (≙ CovarianceMatrix.h:177-215 normalization)."""
    cov = covariance_matrix(samples, thin=thin, burn_in=burn_in)
    d = np.sqrt(np.diag(cov))
    return cov / np.outer(d, d)
