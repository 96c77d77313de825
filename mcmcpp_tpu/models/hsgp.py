"""Hilbert-space (reduced-rank) Gaussian processes — GP priors as matmuls.

Solin & Särkkä 2020 ("Hilbert space methods for reduced-rank Gaussian
process regression") with the practical recipe of Riutort-Mayol et al.
2023: on a box ``[-L, L]^D`` the stationary covariance operator is
approximated by the Dirichlet-Laplacian eigenbasis,

    k(x, x') ≈ Σ_j S(√λ_j) φ_j(x) φ_j(x'),

so a GP function value is an exact linear map of ``m`` iid-normal
weights: ``f = Φ (√S(θ) ⊙ β)``, ``β ~ N(0, I_m)``.

Why this layer exists (accelerator-first rationale): the exact-GP machinery in
:mod:`mcmcpp_tpu.models.gp` pays an O(N³) Cholesky per hyperparameter
value — a sequential, matmul-hostile factorization. Here the basis ``Φ``
is DATA-ONLY (built once, outside the sampler), and every log-density /
gradient evaluation is one ``(N, m)`` matmul plus elementwise spectral
weights — exactly the shape the matrix units want, with hyperparameter
gradients flowing through ``S(θ)`` for free. GP priors thereby become
usable inside every gradient engine (HMC/NUTS/ChEES/MEADS/SGLD) and the
DSL at scale.

Beyond-reference scope: the C++ reference (jmatta1/MCMCpp) ships no
prior-structure-aware machinery at all; this extends the GP layer the
same way `models/gp.py` does, with the reference's oracle-test pattern
(SURVEY.md §4) applied against the exact-GP closed forms.

DSL usage (the prior is just m iid normals + one deterministic)::

    basis = HSGP(x, m=64, c=1.5, kernel="matern52")
    model.param("ell",   LogNormal(0.0, 0.5))
    model.param("sigma", HalfNormal(1.0))
    model.param("beta",  Normal(0, 1), shape=(basis.num_basis,))
    model.deterministic(
        "f", lambda p: basis(p["ell"], p["sigma"], p["beta"]))
    model.observe("y", lambda p: Normal(p["f"], noise), y)

Kernels: "rbf", "matern12", "matern32", "matern52"; inputs 1-D ``(N,)``
or ARD ``(N, D)`` (tensor-product eigenbasis, per-dim ``m``/``L``).
"""

import math

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "HSGP",
    "hsgp_log_marginal",
    "hsgp_predict",
    "spectral_density",
]

_MATERN_NU = {"matern12": 0.5, "matern32": 1.5, "matern52": 2.5}


def spectral_density(kernel, omega, lengthscale, variance=1.0):
    """Power spectral density S(ω) of a stationary kernel at frequency
    vectors ``omega`` of shape ``(..., D)`` (non-unitary convention:
    ``k(r) = (2π)^{-D} ∫ S(ω) e^{iω·r} dω``).

    ``lengthscale`` is scalar or per-dimension ``(D,)`` (ARD). Closed
    forms from Rasmussen & Williams 2006 eq. 4.15 (Matérn) and the
    Gaussian Fourier pair (RBF), with the ARD change of variables
    pulling out ``∏ℓ_d`` and rescaling ``ω_d → ℓ_d ω_d``.
    """
    omega = jnp.asarray(omega)
    d = omega.shape[-1]
    ell = jnp.broadcast_to(jnp.asarray(lengthscale, omega.dtype), (d,))
    prod_ell = jnp.prod(ell)
    s2 = jnp.sum((ell * omega) ** 2, axis=-1)  # Σ ℓ_d² ω_d²
    if kernel == "rbf":
        return (variance * (2.0 * jnp.pi) ** (d / 2.0) * prod_ell
                * jnp.exp(-0.5 * s2))
    try:
        nu = _MATERN_NU[kernel]
    except KeyError:
        raise ValueError(
            f"unknown kernel {kernel!r}; expected rbf/matern12/"
            f"matern32/matern52"
        ) from None
    coef = (variance * prod_ell
            * 2.0 ** d * jnp.pi ** (d / 2.0)
            * math.gamma(nu + d / 2.0) * (2.0 * nu) ** nu
            / math.gamma(nu))
    return coef * (2.0 * nu + s2) ** (-(nu + d / 2.0))


def _as_2d(x):
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    if x.ndim != 2:
        raise ValueError(f"inputs must be (N,) or (N, D); got {x.shape}")
    return x


class HSGP:
    """Reduced-rank GP basis over fixed inputs.

    Parameters
    ----------
    x : (N,) or (N, D) training inputs (data — the basis is built once
        from them; hyperparameters stay free).
    m : eigenfunctions per input dimension (int or per-dim tuple). The
        total basis size is ``prod(m)``; keep D small (tensor product).
    c : box-expansion factor: ``L_d = c · max|x_d − center_d|``
        (Riutort-Mayol et al. recommend c ∈ [1.2, 4] with m scaled to
        the lengthscale; larger c needs larger m).
    kernel : "rbf" | "matern12" | "matern32" | "matern52".
    L : explicit half-widths (overrides ``c``), scalar or per-dim.

    The object precomputes ``phi`` (N, M) and the eigenvalue roots
    ``sqrt_lam`` (M, D); everything hyperparameter-dependent happens in
    :meth:`spectral` / :meth:`__call__` and is JAX-traceable.
    """

    def __init__(self, x, m=32, c=1.5, kernel="rbf", L=None):
        x2 = _as_2d(x)
        n, d = x2.shape
        if kernel not in ("rbf",) + tuple(_MATERN_NU):
            raise ValueError(f"unknown kernel {kernel!r}")
        self.kernel = kernel
        self.ndim = d
        ms = (m,) * d if np.isscalar(m) else tuple(int(v) for v in m)
        if len(ms) != d:
            raise ValueError(f"m has {len(ms)} entries for D={d} inputs")
        self._m_per_dim = ms
        self.center = 0.5 * (x2.max(axis=0) + x2.min(axis=0))
        if L is None:
            half = np.abs(x2 - self.center).max(axis=0)
            half = np.where(half > 0, half, 1.0)
            self.L = float(c) * half
        else:
            self.L = np.broadcast_to(
                np.asarray(L, np.float64), (d,)
            ).copy()
            if np.any(self.L <= np.abs(x2 - self.center).max(axis=0)):
                raise ValueError(
                    "L must strictly contain the (centered) inputs"
                )
        # multi-index grid over per-dim eigenfunction counts
        grids = np.meshgrid(
            *[np.arange(1, mi + 1) for mi in ms], indexing="ij"
        )
        idx = np.stack([g.reshape(-1) for g in grids], axis=-1)  # (M, D)
        # √λ per dim: j π / (2 L_d)  (Dirichlet Laplacian on [-L, L])
        self.sqrt_lam = jnp.asarray(
            idx * np.pi / (2.0 * self.L), jnp.float32
        )  # (M, D)
        self.num_basis = idx.shape[0]
        self.phi = self.basis_at(x)  # (N, M)

    def basis_at(self, x):
        """Eigenfunction matrix Φ at arbitrary inputs: (N2, M).
        φ_j(x) = ∏_d L_d^{-1/2} sin(√λ_{j,d} (x_d + L_d)) — exactly
        zero outside the box by construction; keep prediction points
        inside ``[center − L, center + L]``."""
        x2 = jnp.atleast_2d(jnp.asarray(x, jnp.float32).T).T  # (N2, D)
        xc = x2 - jnp.asarray(self.center, jnp.float32)
        Ld = jnp.asarray(self.L, jnp.float32)
        # (N2, 1, D) · (1, M, D) → product over D
        args = self.sqrt_lam[None, :, :] * (xc[:, None, :] + Ld)
        vals = jnp.sin(args) / jnp.sqrt(Ld)
        return jnp.prod(vals, axis=-1)

    def spectral(self, lengthscale, variance=1.0):
        """(M,) spectral weights S(√λ_j) for live hyperparameters."""
        return spectral_density(
            self.kernel, self.sqrt_lam, lengthscale, variance
        )

    def __call__(self, lengthscale, variance, beta, x=None):
        """Function values ``f = Φ (√S ⊙ β)`` with ``β ~ N(0, I_m)``
        giving ``f ~ N(0, Φ S Φᵀ) ≈ GP(0, k)``. ``beta`` may carry
        leading batch axes ``(..., M)``; ``x=None`` uses the training
        basis (one (N, M) matmul — the sampler hot path)."""
        phi = self.phi if x is None else self.basis_at(x)
        w = jnp.sqrt(self.spectral(lengthscale, variance)) * beta
        return w @ phi.T

    def gram(self, lengthscale, variance=1.0, x=None):
        """Approximate Gram Φ diag(S) Φᵀ (testing / direct use)."""
        phi = self.phi if x is None else self.basis_at(x)
        return (phi * self.spectral(lengthscale, variance)) @ phi.T


def _weight_space(basis, lengthscale, variance, y, noise, jitter):
    """Shared weight-space algebra: Cholesky of
    A = σ_n² S⁻¹ + ΦᵀΦ (M × M) — the only decomposition either the
    marginal likelihood or the predictive needs. O(N M² + M³)."""
    phi = basis.phi
    s = basis.spectral(lengthscale, variance) + jitter
    sn2 = noise**2 + jitter
    a = sn2 * jnp.diag(1.0 / s) + phi.T @ phi
    chol = jnp.linalg.cholesky(a)
    phi_y = phi.T @ jnp.asarray(y)
    w = jax.scipy.linalg.cho_solve((chol, True), phi_y)  # A⁻¹ Φᵀ y
    return phi, s, sn2, chol, phi_y, w


def hsgp_log_marginal(basis, lengthscale, variance, y, noise,
                      jitter=1e-6):
    """Reduced-rank GP log marginal likelihood
    ``log N(y; 0, Φ S Φᵀ + σ_n² I)`` via the matrix-determinant and
    Woodbury identities in weight space — O(N m² + m³) instead of the
    exact path's O(N³) (mcmcpp_tpu.models.gp.gp_log_marginal), and
    built from matmuls rather than an (N, N) Cholesky.
    """
    y = jnp.asarray(y)
    n = y.shape[0]
    m = basis.num_basis
    phi, s, sn2, chol, phi_y, w = _weight_space(
        basis, lengthscale, variance, y, noise, jitter
    )
    quad = (jnp.sum(y * y) - phi_y @ w) / sn2
    logdet = (2.0 * jnp.sum(jnp.log(jnp.diagonal(chol)))
              + jnp.sum(jnp.log(s))
              + (n - m) * jnp.log(sn2))
    return -0.5 * (quad + logdet + n * jnp.log(2.0 * jnp.pi))


def hsgp_predict(basis, lengthscale, variance, y, noise, x_new,
                 jitter=1e-6):
    """Posterior mean and variance of the latent f at ``x_new`` under
    the reduced-rank prior: weight posterior N(A⁻¹Φᵀy, σ_n² A⁻¹)
    pushed through φ(x*). Matches gp_predict as m → ∞ (for x_new
    inside the expanded box)."""
    phi_new = basis.basis_at(x_new)  # (N2, M)
    _, s, sn2, chol, _, w = _weight_space(
        basis, lengthscale, variance, y, noise, jitter
    )
    mean = phi_new @ w
    half = jax.scipy.linalg.solve_triangular(
        chol, phi_new.T, lower=True
    )
    var = sn2 * jnp.sum(half * half, axis=0)
    return mean, jnp.maximum(var, 0.0)
