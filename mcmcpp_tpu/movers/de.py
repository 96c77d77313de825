"""Ter Braak differential-evolution (DE-MC) move.

Rebuild of ``MCMCpp/Movers/DifferentialEvolution.h:113-149``:
Y = X + γ·(X₁ − X₂) + U(−b, b)^P with distinct complementary walkers X₁≠X₂,
γ = 2.38/√(2P) by default, b = 1e-4. Symmetric proposal ⇒ factor 0.

The reference's rejection loop for a distinct pair
(DifferentialEvolution.h:116-120) is replaced by the exact shifted-draw
trick: i ~ U[0, m), j ~ U[0, m−1), j += (j ≥ i) — uniform over distinct
ordered pairs with zero rejection, branchless.
"""

import jax
import jax.numpy as jnp

from mcmcpp_tpu.movers.base import Mover
from mcmcpp_tpu.ops.partner import select_partners


class DifferentialEvolutionMove(Mover):
    """``partner_mode``: "roll" (accelerator-fast, two distinct shared shifts) or
    "gather" (iid distinct pair per walker); see ops/partner.py."""

    def __init__(self, gamma=None, jitter=1e-4, partner_mode="roll"):
        self.gamma = None if gamma is None else float(gamma)
        self.jitter = float(jitter)
        self.partner_mode = partner_mode

    def propose(self, key, active, other, state):
        n, p = active.shape
        gamma = self.gamma if self.gamma is not None else 2.38 / jnp.sqrt(2.0 * p)
        kp, ku = jax.random.split(key)
        x1, x2 = select_partners(kp, other, n, 2, self.partner_mode)
        noise = jax.random.uniform(
            ku, (n, p), active.dtype, minval=-self.jitter, maxval=self.jitter
        )
        proposal = active + gamma * (x1 - x2) + noise
        return proposal, jnp.zeros((n,), active.dtype)
