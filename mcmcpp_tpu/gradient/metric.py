"""Mass-matrix (metric) abstraction for the gradient kernels.

Every gradient kernel in this package is written against four linear-map
primitives — velocity ``M⁻¹p``, kinetic energy ``½pᵀM⁻¹p``, momentum
sampling ``p ~ N(0, M)`` and the proposal-noise map ``M^{-1/2}z`` — so the
SAME kernel code runs under either metric:

- **diag** (default): ``inv_mass`` is the ``(P,)`` vector of estimated
  posterior variances (``M⁻¹ = diag(var)``); all four primitives are
  elementwise, fuse into the leapfrog, and cost O(P).
- **dense**: ``inv_mass`` is a :class:`DenseMassMatrix` carrying the
  estimated posterior covariance ``Σ = M⁻¹`` with its Cholesky factor
  ``L`` (``Σ = LLᵀ``) and ``L⁻ᵀ`` precomputed once per metric update, so
  the per-step cost is matmuls, no solves in the hot loop.
  A dense metric rotates AND scales: on a correlated Gaussian it turns
  the leapfrog into integration of an isotropic target, collapsing the
  condition number that forces tiny steps under a diagonal metric.

The primitives broadcast over a leading chain axis: ``p`` may be ``(P,)``
(the vmapped per-chain kernels in hmc.py/nuts.py/mala.py) or ``(C, P)``
(the whole-batch ChEES kernel).

The reference library is gradient-free (black-box Calculator contract,
``/root/reference/MCMCpp/Utility/UserOjbectsTest.h:144-151``); metric
choice is north-star scope following Stan's diag_e/dense_e adaptation.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp


class DenseMassMatrix(NamedTuple):
    """Dense metric state. ``cov`` is the inverse mass ``Σ = M⁻¹``;
    ``chol`` its lower Cholesky factor ``L``; ``inv_chol_t = L⁻ᵀ`` (so
    ``L⁻¹ = inv_chol_t.T``) precomputed for momentum sampling and
    whitened quadratic forms."""

    cov: jax.Array  # (P, P)
    chol: jax.Array  # (P, P), lower
    inv_chol_t: jax.Array  # (P, P)


def dense_mass_from_cov(cov):
    """Build the full dense-metric state from a covariance estimate."""
    cov = jnp.asarray(cov)
    cov = 0.5 * (cov + cov.T)  # symmetrize against accumulation drift
    chol = jnp.linalg.cholesky(cov)
    eye = jnp.eye(cov.shape[0], dtype=cov.dtype)
    inv_chol = jax.scipy.linalg.solve_triangular(chol, eye, lower=True)
    return DenseMassMatrix(cov=cov, chol=chol, inv_chol_t=inv_chol.T)


def is_dense(inv_mass) -> bool:
    return isinstance(inv_mass, DenseMassMatrix)


def _apply(mat, x):
    """``mat @ x`` over the last axis of ``x`` ((P,) or (C, P))."""
    return jnp.einsum("ij,...j->...i", mat, x)


def mass_velocity(inv_mass, p):
    """``M⁻¹ p`` — the dq/dt term of the leapfrog."""
    if is_dense(inv_mass):
        return _apply(inv_mass.cov, p)
    return inv_mass * p


def mass_kinetic(inv_mass, p):
    """``½ pᵀ M⁻¹ p``, reduced over the last axis.

    Dense path uses ``½‖Lᵀp‖²`` — one triangular matmul, no solve.
    """
    if is_dense(inv_mass):
        y = jnp.einsum("ji,...j->...i", inv_mass.chol, p)
        return 0.5 * jnp.sum(y * y, axis=-1)
    return 0.5 * jnp.sum(inv_mass * p * p, axis=-1)


def mass_momentum(inv_mass, z):
    """Map ``z ~ N(0, I)`` to ``p ~ N(0, M)`` (``p = L⁻ᵀ z`` dense)."""
    if is_dense(inv_mass):
        return _apply(inv_mass.inv_chol_t, z)
    return z * jax.lax.rsqrt(inv_mass)


def mass_noise(inv_mass, z):
    """Map ``z ~ N(0, I)`` to ``M^{-1/2} z ~ N(0, M⁻¹)`` (``L z`` dense) —
    the MALA proposal-noise map."""
    if is_dense(inv_mass):
        return _apply(inv_mass.chol, z)
    return z * jnp.sqrt(inv_mass)


def mass_noise_t(inv_mass, g):
    """Transpose of :func:`mass_noise`: ``M^{-1/2,T} g`` (``Lᵀ g`` dense).

    Maps a position-space gradient into the whitened coordinates in which
    the proposal noise is iid N(0, I) — the chain-rule factor for kernels
    (Barker) that operate per-coordinate in whitened space.
    """
    if is_dense(inv_mass):
        return jnp.einsum("ji,...j->...i", inv_mass.chol, g)
    return g * jnp.sqrt(inv_mass)


def mass_quad_inv(inv_mass, d):
    """``dᵀ Σ⁻¹ d`` with ``Σ = M⁻¹`` — i.e. ``dᵀ M d``, the whitened
    squared norm in the MALA Hastings correction (``‖L⁻¹d‖²`` dense)."""
    if is_dense(inv_mass):
        y = jnp.einsum("ji,...j->...i", inv_mass.inv_chol_t, d)
        return jnp.sum(y * y, axis=-1)
    return jnp.sum(d * d / inv_mass, axis=-1)
