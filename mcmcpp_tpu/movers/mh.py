"""Classic Metropolis–Hastings with multivariate-normal proposal.

Rebuild of ``MCMCpp/Movers/MetropolisHastings.h``: the reference validates a
user covariance (symmetry / positive diagonal / diagonal detection,
:218-237), hand-rolls a Cholesky factorization (:244-284), and falls back to
the identity matrix when validation fails (:314-333). Here validation is
NumPy at construction time and the factorization is
``jnp.linalg.cholesky`` / a diagonal fast path; sampling is one
``normals @ L.T`` matmul instead of the reference's reverse-order
triangular loop (:164-198). Symmetric proposal ⇒ Metropolis factor 0.

(The reference's include-guard collision and double-sampling defects,
MetropolisHastings.h:12-13 and :164-167, are intentionally not replicated.)
"""

import numpy as np
import jax
import jax.numpy as jnp

from mcmcpp_tpu.movers.base import Mover


class MetropolisHastingsMove(Mover):
    """MH mover. ``covariance`` may be None (identity), a 1-D array
    (diagonal), or a full (P, P) SPD matrix. Invalid matrices fall back to
    identity with a warning, matching the reference's behavior."""

    def __init__(self, covariance=None, scale=1.0):
        self.scale = float(scale)
        self.covariance = None if covariance is None else np.asarray(covariance)
        self._diag = None  # filled by _validate
        self._full = None
        self.fell_back_to_identity = False
        self._validate()

    def _validate(self):
        cov = self.covariance
        if cov is None:
            return
        if cov.ndim == 1:
            if np.all(cov > 0):
                self._diag = np.sqrt(cov)
            else:
                self._fallback("diagonal covariance has non-positive entries")
            return
        if cov.ndim != 2 or cov.shape[0] != cov.shape[1]:
            self._fallback("covariance must be square")
            return
        if not np.allclose(cov, cov.T, rtol=1e-8, atol=1e-12):
            self._fallback("covariance is not symmetric")
            return
        if np.any(np.diag(cov) <= 0):
            self._fallback("covariance has non-positive diagonal")
            return
        off_diag = cov - np.diag(np.diag(cov))
        if np.count_nonzero(off_diag) == 0:
            self._diag = np.sqrt(np.diag(cov))  # diagonal fast path (:203-211)
            return
        try:
            self._full = np.linalg.cholesky(cov)
        except np.linalg.LinAlgError:
            self._fallback("covariance is not positive definite")

    def _fallback(self, reason):
        import warnings

        warnings.warn(
            f"MetropolisHastingsMove: {reason}; falling back to identity "
            "proposal covariance (cf. MetropolisHastings.h:314-333)"
        )
        self.fell_back_to_identity = True
        self._diag = None
        self._full = None

    def init_state(self, n_params, dtype):
        if self._full is not None:
            if self._full.shape[0] != n_params:
                raise ValueError("covariance dimension != n_params")
            return {"chol": jnp.asarray(self._full, dtype)}
        if self._diag is not None:
            if self._diag.shape[0] != n_params:
                raise ValueError("covariance dimension != n_params")
            return {"diag": jnp.asarray(self._diag, dtype)}
        return {"diag": jnp.ones((n_params,), dtype)}

    def propose(self, key, active, other, state):
        n, p = active.shape
        normals = jax.random.normal(key, (n, p), active.dtype)
        if "chol" in state:
            step = normals @ state["chol"].T  # triangular matmul
        else:
            step = normals * state["diag"][None, :]
        proposal = active + self.scale * step
        return proposal, jnp.zeros((n,), active.dtype)
