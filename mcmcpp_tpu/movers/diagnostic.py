"""Diagnostic movers — the framework's statistical/deterministic oracles.

Rebuilds of ``MCMCpp/Movers/Diagnostic/``:

- :class:`AutoRegressiveMove` (AutoRegressiveMove.h:103-131): an AR(1)
  process per parameter, xₜ₊₁ = off + φ·xₜ + σ√(1−φ²)·N(0,1), whose
  integrated autocorrelation time is analytically (1+φ)/(1−φ). Ground truth
  for the ACT estimator tests (test/sequential/AcTime).
- :class:`SequenceMove` (SequenceMove.h:102-122): deterministic fixed-step
  increments; used by the InnerBenchmark harness to time pure framework
  overhead. The reference's find-50th-prime busy-work (SequenceMove.h:135-162)
  simulated an expensive CPU likelihood; the benchmark here instead adds
  synthetic FLOPs via the benchmark's logp, so the mover stays pure.

Both always accept and ignore the complementary half and logp.
"""

import numpy as np
import jax
import jax.numpy as jnp

from mcmcpp_tpu.movers.base import Mover


class AutoRegressiveMove(Mover):
    """AR(1) diagnostic oracle: xₜ₊₁ = off + φxₜ + σ√(1−φ²)·N(0,1) per
    parameter, always accepted; analytic ACT τ = (1+φ)/(1−φ)
    (≙ ``MCMCpp/Movers/Diagnostic/AutoRegressiveMove.h:103-112``)."""

    always_accept = True

    def __init__(self, offsets, phis, variances):
        self.offsets = np.asarray(offsets, dtype=np.float64)
        self.phis = np.asarray(phis, dtype=np.float64)
        self.variances = np.asarray(variances, dtype=np.float64)
        if not (self.offsets.shape == self.phis.shape == self.variances.shape):
            raise ValueError("offsets, phis, variances must have equal shapes")
        if np.any(np.abs(self.phis) >= 1.0):
            raise ValueError("|phi| must be < 1 for stationarity")

    @property
    def true_act(self):
        """Analytic integrated autocorrelation time (1+φ)/(1−φ) per param."""
        return (1.0 + self.phis) / (1.0 - self.phis)

    def init_state(self, n_params, dtype):
        if self.phis.shape[0] != n_params:
            raise ValueError("AR parameter arrays must have length n_params")
        return {
            "off": jnp.asarray(self.offsets, dtype),
            "phi": jnp.asarray(self.phis, dtype),
            "sig": jnp.asarray(
                np.sqrt(self.variances * (1.0 - self.phis**2)), dtype
            ),
        }

    def initial_positions(self, key, n_walkers, dtype=jnp.float32):
        """Draw walkers from the stationary distribution
        (≙ AutoRegressiveMove.h:119-131)."""
        p = self.phis.shape[0]
        mean = jnp.asarray(self.offsets / (1.0 - self.phis), dtype)
        std = jnp.asarray(np.sqrt(self.variances), dtype)
        z = jax.random.normal(key, (n_walkers, p), dtype)
        return mean[None, :] + std[None, :] * z

    def propose(self, key, active, other, state):
        n, p = active.shape
        z = jax.random.normal(key, (n, p), active.dtype)
        nxt = state["off"][None, :] + state["phi"][None, :] * active
        nxt = nxt + state["sig"][None, :] * z
        return nxt, jnp.zeros((n,), active.dtype)


class SequenceMove(Mover):
    """Deterministic diagnostic oracle: adds fixed ``step_sizes`` each
    update, always accepted — the benchmark/determinism harness
    (≙ ``MCMCpp/Movers/Diagnostic/SequenceMove.h:102-122``)."""

    always_accept = True

    def __init__(self, step_sizes):
        self.step_sizes = np.asarray(step_sizes, dtype=np.float64)

    def init_state(self, n_params, dtype):
        if self.step_sizes.shape[0] != n_params:
            raise ValueError("step_sizes must have length n_params")
        return {"steps": jnp.asarray(self.step_sizes, dtype)}

    def initial_positions(self, key, n_walkers, dtype=jnp.float32):
        """Zero-init, matching SequenceMove.h:122."""
        del key
        return jnp.zeros((n_walkers, self.step_sizes.shape[0]), dtype)

    def propose(self, key, active, other, state):
        del key
        n = active.shape[0]
        return active + state["steps"][None, :], jnp.zeros((n,), active.dtype)
