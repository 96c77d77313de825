"""DRAM: delayed-rejection adaptive Metropolis (Haario et al. 2006).

Completes the Metropolis–Hastings family the reference ships
(``MCMCpp/Movers/MetropolisHastings.h:138`` ``updateWalker`` is the
single-stage special case): on a stage-1 rejection a SECOND, shrunk
proposal is tried from the same point, accepted with Mira's (2001)
delayed-rejection ratio, which preserves detailed balance exactly.

Accelerator-native design: both stages are computed every step — fixed shapes,
two batched logp evaluations per half-step, branchless three-way select
(Y1 / Y2 / X) — so the scan body stays a single fused program with no
data-dependent control flow (the per-walker "if rejected, retry" of a
CPU implementation would be a divergent branch; here the second stage's
cost is paid uniformly, which on the matrix/vector units is cheaper than any mask
gymnastics).

The "adaptive" half follows the ensemble pattern rather than Haario's
time-averaged covariance: the proposal covariance is estimated from the
COMPLEMENTARY half-ensemble each half-step (``2.38²/P · cov(other) +
eps·I``, the Haario scaling). Because the active half's proposal only
depends on the fixed other half, π^W invariance holds exactly — no
diminishing-adaptation argument needed (same validity argument as the
stretch/walk moves, Goodman & Weare 2010), and the adaptation is free of
host round-trips: one (P, P) covariance + Cholesky per half-step,
negligible next to the batched logp.

References: Haario, Laine, Mira & Saksman, "DRAM: Efficient adaptive
MCMC", Stat. Comput. 16 (2006); Mira, "On Metropolis-Hastings algorithms
with delayed rejection", Metron 59 (2001).
"""

import numpy as np
import jax
import jax.numpy as jnp

from mcmcpp_tpu.movers.base import Mover


def _log1m_exp(a):
    """log(1 - e^a) for a <= 0, branchless; -inf at a == 0."""
    a_safe = jnp.minimum(a, -1e-10)
    return jnp.where(a < -1e-10, jnp.log1p(-jnp.exp(a_safe)), -jnp.inf)


class DRAMMove(Mover):
    """Delayed-rejection (adaptive) Metropolis mover.

    Parameters
    ----------
    covariance : None | (P,) | (P, P)
        Static proposal covariance (identity if None). Ignored when
        ``adapt="ensemble"`` (the default), where the covariance comes
        from the complementary half each half-step.
    scale : float
        Stage-1 step scale multiplying the covariance factor. With
        ensemble adaptation the Haario factor 2.38/sqrt(P) is already
        applied, so ``scale`` is a trim knob around 1.
    gamma : float
        Stage-2 shrink factor (stage-2 covariance = (gamma·scale)²Σ).
        Haario et al. recommend a substantially smaller second stage;
        default 0.35.
    adapt : "ensemble" | None
        "ensemble": Σ = 2.38²/P · cov(other) + eps·I per half-step
        (exactly π-invariant, see module docstring). None: static Σ.
    eps : float
        Covariance regularization floor for the adaptive mode
        (Haario's ε·I_d term).
    """

    def __init__(self, covariance=None, scale=1.0, gamma=0.35,
                 adapt="ensemble", eps=1e-6):
        if adapt not in ("ensemble", None):
            raise ValueError(f"unknown adapt mode {adapt!r}")
        if not 0.0 < float(gamma):
            raise ValueError("gamma must be positive")
        self.scale = float(scale)
        self.gamma = float(gamma)
        self.adapt = adapt
        self.eps = float(eps)
        self.covariance = None if covariance is None else np.asarray(covariance)

    def init_state(self, n_params, dtype):
        if self.adapt == "ensemble":
            return ()
        cov = self.covariance
        if cov is None:
            chol = np.eye(n_params)
        elif cov.ndim == 1:
            if cov.shape[0] != n_params or np.any(cov <= 0):
                raise ValueError("diagonal covariance must be positive, (P,)")
            chol = np.diag(np.sqrt(cov))
        else:
            if cov.shape != (n_params, n_params):
                raise ValueError("covariance must be (P, P)")
            chol = np.linalg.cholesky(cov)  # raises if not SPD
        return {"chol": jnp.asarray(chol, dtype)}

    def _chol(self, other, state, n_params):
        if self.adapt != "ensemble":
            return state["chol"]
        # Haario scaling s_d = 2.38^2/d on the complementary-half
        # covariance + eps floor; one small (P, P) eigen-problem-free
        # factorization per half-step, shared by all walkers.
        centered = other - jnp.mean(other, axis=0, keepdims=True)
        m = other.shape[0]
        cov = centered.T @ centered / jnp.asarray(
            max(m - 1, 1), other.dtype
        )
        sd = 2.38 * 2.38 / n_params
        cov = sd * cov + self.eps * jnp.eye(n_params, dtype=other.dtype)
        return jnp.linalg.cholesky(cov)

    def update_half(self, key, active, active_logp, other, logp_fn, state,
                    beta=1.0):
        n, p = active.shape
        kp1, kp2, ka1, ka2 = jax.random.split(key, 4)
        chol = self._chol(other, state, p)

        # stage 1 (plain Metropolis, symmetric Gaussian proposal)
        xi1 = jax.random.normal(kp1, (n, p), active.dtype)
        y1 = active + self.scale * (xi1 @ chol.T)
        l1 = logp_fn(y1)
        d1 = beta * (l1 - active_logp)
        log_u1 = -jax.random.exponential(ka1, (n,), active.dtype)
        accept1 = log_u1 < d1

        # stage 2 (shrunk proposal from the SAME point)
        xi2 = jax.random.normal(kp2, (n, p), active.dtype)
        y2 = active + (self.gamma * self.scale) * (xi2 @ chol.T)
        l2 = logp_fn(y2)

        # Mira's DR ratio: the q1-density ratio q1(y2→y1)/q1(x→y1) needs
        # the stage-1 Mahalanobis norms; ||L^{-1}(y1−x)||²/scale² is just
        # ||xi1||² by construction, only y1−y2 pays a triangular solve.
        z = jax.scipy.linalg.solve_triangular(
            chol, (y1 - y2).T, lower=True
        ).T / self.scale
        lq_num = -0.5 * jnp.sum(z * z, axis=-1)
        lq_den = -0.5 * jnp.sum(xi1 * xi1, axis=-1)
        a1_fwd = jnp.minimum(d1, 0.0)                 # log α1(x → y1)
        a1_rev = jnp.minimum(beta * (l1 - l2), 0.0)   # log α1(y2 → y1)
        log_num = beta * l2 + lq_num + _log1m_exp(a1_rev)
        log_den = beta * active_logp + lq_den + _log1m_exp(a1_fwd)
        log_u2 = -jax.random.exponential(ka2, (n,), active.dtype)
        # NaN-safe: log_den = -inf only when a1_fwd == 0, where accept1
        # is true a.s. (log_u1 < 0 <= d1) and the stage-2 lane is masked;
        # a NaN difference compares False, so nothing leaks either way.
        accept2 = jnp.logical_and(~accept1, log_u2 < log_num - log_den)

        new_active = jnp.where(
            accept1[:, None], y1, jnp.where(accept2[:, None], y2, active)
        )
        new_logp = jnp.where(accept1, l1, jnp.where(accept2, l2, active_logp))
        return new_active, new_logp, jnp.logical_or(accept1, accept2)
