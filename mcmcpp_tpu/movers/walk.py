"""Goodman–Weare walk move.

Rebuild of ``MCMCpp/Movers/WalkMove.h:101-186``: choose S complementary
walkers *without replacement*, then propose
Y = X + Σⱼ Nⱼ·(Xⱼ − X̄_S) with one scalar normal Nⱼ per selected walker.
The proposal is symmetric, so the Metropolis factor is 0.

Partner selection (``partner_mode``):

- "roll" (default): S *distinct shared shifts* — walker i's subset is
  {other[(i+r_j) % m]}, one contiguous roll per shift, no HBM gather
  (see ops/partner.py for validity + benchmarks). The per-walker normal
  draws stay iid, so proposal diversity across walkers is preserved.
- "gather": per-walker uniform S-subset WITHOUT replacement via S
  sequential shifted draws (exact sorted-insertion sampling, O(n·S)
  memory and O(n·S²) scalar work — NOT an (n, m) score matrix), the
  memory-scalable replacement for the reference's per-walker Knuth
  selection sampling (WalkMove.h:130-150). Usable for parity studies
  at any W (per-row HBM gathers cost far more than roll in the hot
  loop — benchmarks/walk_scale.py measures it — so roll stays the
  default).
"""

import jax
import jax.numpy as jnp

from mcmcpp_tpu.movers.base import Mover
from mcmcpp_tpu.ops.partner import rolled_partners, select_partners


class WalkMove(Mover):
    """Walk move drawing ``n_samples`` complementary walkers (default 6,
    matching the reference tests, e.g.
    ``test/sequential/SkewedGaussian/WalkMove/src/main.cpp:35``)."""

    def __init__(self, n_samples=6, partner_mode="roll"):
        if n_samples < 2:
            raise ValueError("WalkMove requires n_samples >= 2")
        self.n_samples = int(n_samples)
        self.partner_mode = partner_mode

    def propose(self, key, active, other, state):
        n, p = active.shape
        m = other.shape[0]
        s = self.n_samples
        if s > m:
            raise ValueError(
                f"WalkMove n_samples={s} exceeds complementary half size {m}"
            )
        kj, kn = jax.random.split(key)
        if self.partner_mode == "roll":
            if n != m:
                raise ValueError(f"roll mode requires equal halves ({n} != {m})")
            xs = jnp.transpose(rolled_partners(kj, other, s), (1, 0, 2))  # (n,s,p)
        else:
            # "gather": exact per-walker uniform S-subset, O(n·s) memory
            # (no (n, m) score matrix — scalable to W=2^21 ensembles);
            # "block": per-128-walker-block iid subsets. Unknown modes
            # must ERROR, not silently fall through to gather.
            xs = jnp.transpose(
                select_partners(kj, other, n, s, self.partner_mode),
                (1, 0, 2),
            )
        center = jnp.mean(xs, axis=1, keepdims=True)  # (n, 1, p)
        # one scalar normal per selected walker ≙ WalkMove.h:155-186
        normals = jax.random.normal(kn, (n, s), active.dtype)
        step = jnp.einsum("ns,nsp->np", normals, xs - center)
        proposal = active + step
        return proposal, jnp.zeros((n,), active.dtype)
