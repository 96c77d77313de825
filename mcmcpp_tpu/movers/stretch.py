"""Goodman–Weare stretch move, batched over the half-ensemble.

accelerator-native rebuild of ``MCMCpp/Movers/StretchMove.h:100-117``: for every
active walker X, pick a random complementary walker Xk, draw z ~ g(z),
propose Y = Xk + z·(X − Xk), and accept with probability
min(1, z^{P-1}·p(Y)/p(X)). The per-walker loop of the reference becomes a
single gather + fused elementwise expression over ``(n_half, P)`` arrays.
"""

import jax
import jax.numpy as jnp

from mcmcpp_tpu.movers.base import Mover
from mcmcpp_tpu.ops.gw import gw_sample
from mcmcpp_tpu.ops.partner import select_partners


class StretchMove(Mover):
    """Affine-invariant stretch move with scale parameter ``a`` (default 2).

    ``partner_mode``: "roll" (default, accelerator-fast shared-shift pairing) or
    "gather" (reference-faithful iid pick ≙ StretchMove.h:102); see
    ``mcmcpp_tpu/ops/partner.py`` for the validity argument and benchmarks.
    """

    def __init__(self, a=2.0, partner_mode="roll"):
        self.a = float(a)
        self.partner_mode = partner_mode

    def propose(self, key, active, other, state):
        n, p = active.shape
        kj, kz = jax.random.split(key)
        partner = select_partners(kj, other, n, 1, self.partner_mode)[0]
        u = jax.random.uniform(kz, (n,), active.dtype)
        z = gw_sample(u, self.a)
        proposal = partner + z[:, None] * (active - partner)
        # (P-1)·log z term ≙ StretchMove.h:110
        log_factor = (p - 1) * jnp.log(z)
        return proposal, log_factor
