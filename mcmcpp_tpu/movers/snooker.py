"""DE-Snooker move (ter Braak & Vrugt 2008).

The snooker updater companions plain DE-MC (``movers/de.py``, rebuilding
``MCMCpp/Movers/DifferentialEvolution.h``; the reference has no snooker —
this extends the mover family the same way emcee's DESnookerMove does).
For each active walker X pick three distinct complementary walkers
Z, Z1, Z2; move along the line through X and Z:

    e = (X - Z) / ||X - Z||
    Y = X + gamma_s * ((Z1 - Z2) . e) e        gamma_s = 2.38/sqrt(2)

Because the proposal lives on a 1-D line anchored at Z, the move carries a
radial Jacobian: accept with the extra factor
``(P-1) * (log||Y - Z|| - log||X - Z||)`` (ter Braak & Vrugt 2008, eq. 4
— the same ``d-1`` power the stretch move has, ``StretchMove.h:110``).
Snooker moves jump BETWEEN modes a multimodal ensemble already populates,
where plain DE's parallel-displacement proposals mostly stay within one.

All-batch formulation: three distinct shared shifts (or iid gather),
fused dot products over ``(n, P)`` — no per-walker loop.
"""

import math

import jax
import jax.numpy as jnp

from mcmcpp_tpu.movers.base import Mover
from mcmcpp_tpu.ops.partner import select_partners


class DESnookerMove(Mover):
    """``gamma``: line-jump scale (paper default 2.38/sqrt(2) ~ 1.683).
    ``partner_mode``: "roll" (accelerator-fast distinct shared shifts) or "gather"
    (iid distinct triple per walker); see ops/partner.py."""

    # NOTE: defaults must not touch jnp — module import must not initialize
    # the XLA backend (breaks jax.distributed.initialize in multi-process
    # workers; regression-tested by tests/test_multihost.py)
    def __init__(self, gamma=2.38 / math.sqrt(2.0), partner_mode="roll"):
        self.gamma = float(gamma)
        self.partner_mode = partner_mode

    def propose(self, key, active, other, state):
        n, p = active.shape
        z, z1, z2 = select_partners(key, other, n, 3, self.partner_mode)
        d = active - z
        norm2 = jnp.sum(d * d, axis=1)
        # degenerate anchor (X == Z): propose no displacement, factor 0
        safe = norm2 > 0
        inv_norm2 = jnp.where(safe, 1.0 / jnp.where(safe, norm2, 1.0), 0.0)
        proj = jnp.sum((z1 - z2) * d, axis=1) * inv_norm2  # ((Z1-Z2).e)/||d||
        proposal = active + self.gamma * proj[:, None] * d
        ynorm2 = jnp.sum((proposal - z) ** 2, axis=1)
        log_factor = jnp.where(
            safe & (ynorm2 > 0),
            0.5 * (p - 1) * (jnp.log(jnp.where(ynorm2 > 0, ynorm2, 1.0))
                             - jnp.log(jnp.where(safe, norm2, 1.0))),
            0.0,
        )
        return proposal, log_factor
