"""Ensemble slice sampling (zeus-style differential slice move).

Karamanis & Beutler 2021 "Ensemble Slice Sampling" (Stat. Comput. 31, 61):
each walker slice-samples along the differential direction
``eta = mu * (X1 - X2)`` built from a distinct pair of COMPLEMENTARY-half
walkers, using Neal (2003) stepping-out + shrinking. Slice sampling has
no accept/reject — every finished walker moves — so this mover overrides
``update_half`` instead of ``propose`` (the reference's Metropolis-only
mover contract, ``MCMCpp/EnsembleSampler.h:49-51``, has no counterpart;
this is north-star scope, API parity with the public ``zeus`` library).

Accelerator shape discipline: the stepping-out and shrinking loops are
data-dependent per walker, so they run as whole-half batched
``lax.while_loop``s with per-walker active masks — every iteration costs
one (or two) batched ``logp`` evaluations for the full ``(n, P)`` half,
finished walkers simply masked. Iteration caps (``max_steps``,
``max_shrink``) bound the trip count; the shrink interval halves in
expectation per draw, so the cap is astronomically unlikely to bind (a
capped walker stays put, the standard practical fallback — zeus caps at
``maxiter`` the same way).

Works under parallel tempering: ``beta`` tempers the slice height and
the inclusion test (slice sampling pi^beta), while stored log-probs stay
RAW, matching the Metropolis movers' convention (movers/base.py).
"""

import jax
import jax.numpy as jnp

from mcmcpp_tpu.movers.base import Mover
from mcmcpp_tpu.ops.partner import select_partners


class EnsembleSliceMove(Mover):
    """Differential-direction ensemble slice sampler.

    ``mu``: direction scale (zeus's tuned parameter; 1.0 is the paper's
    default and remains exactly valid untuned — any fixed ``mu`` gives a
    correct slice sampler, tuning only trades evaluations for step size).
    ``max_steps``: stepping-out cap per side; ``max_shrink``: shrinking
    cap. ``partner_mode``: "roll" (accelerator-fast shared shifts) or "gather"
    (iid per-walker pairs); see ops/partner.py.
    """

    def __init__(self, mu=1.0, max_steps=64, max_shrink=64,
                 partner_mode="roll"):
        self.mu = float(mu)
        self.max_steps = int(max_steps)
        self.max_shrink = int(max_shrink)
        self.partner_mode = partner_mode

    def update_half(self, key, active, active_logp, other, logp_fn, state,
                    beta=1.0):
        n, _ = active.shape
        dt = active.dtype
        k_pair, k_h, k_u, k_shrink = jax.random.split(key, 4)

        x1, x2 = select_partners(k_pair, other, n, 2, self.partner_mode)
        eta = self.mu * (x1 - x2)  # (n, P)

        def offset_logp(t):
            """Raw logp at ``active + t*eta`` for per-walker offsets t."""
            return logp_fn(active + t[:, None] * eta)

        # slice height: y = beta*logp(x) - Exp(1)
        y = beta * active_logp - jax.random.exponential(k_h, (n,), dt)

        # -- stepping out (Neal 2003), both ends, batched ---------------
        u = jax.random.uniform(k_u, (n,), dt)
        L0, R0 = -u, 1.0 - u

        def expand_cond(c):
            _, _, grow_l, grow_r, i = c
            return (i < self.max_steps) & (
                jnp.any(grow_l) | jnp.any(grow_r)
            )

        def expand_body(c):
            L, R, grow_l, grow_r, i = c
            grow_l = grow_l & (beta * offset_logp(L) > y)
            grow_r = grow_r & (beta * offset_logp(R) > y)
            L = jnp.where(grow_l, L - 1.0, L)
            R = jnp.where(grow_r, R + 1.0, R)
            return L, R, grow_l, grow_r, i + 1

        ones = jnp.ones((n,), bool)
        L, R, _, _, _ = jax.lax.while_loop(
            expand_cond, expand_body,
            (L0, R0, ones, ones, jnp.int32(0)),
        )

        # -- shrinking ---------------------------------------------------
        def shrink_cond(c):
            _, _, _, _, done, _, j = c
            return (j < self.max_shrink) & jnp.any(~done)

        def shrink_body(c):
            L, R, z, z_logp, done, k, j = c
            k, kk = jax.random.split(k)
            xi = L + (R - L) * jax.random.uniform(kk, (n,), dt)
            cand_logp = offset_logp(xi)
            ok = beta * cand_logp > y
            take = ~done & ok
            z = jnp.where(take, xi, z)
            z_logp = jnp.where(take, cand_logp, z_logp)
            # failed draws shrink their own side of the interval
            fail = ~done & ~ok
            L = jnp.where(fail & (xi < 0.0), xi, L)
            R = jnp.where(fail & (xi >= 0.0), xi, R)
            return L, R, z, z_logp, done | ok, k, j + 1

        zeros = jnp.zeros((n,), dt)
        _, _, z, z_logp, done, _, _ = jax.lax.while_loop(
            shrink_cond, shrink_body,
            (L, R, zeros, active_logp, jnp.zeros((n,), bool),
             k_shrink, jnp.int32(0)),
        )

        new_active = jnp.where(done[:, None], active + z[:, None] * eta,
                               active)
        new_logp = jnp.where(done, z_logp, active_logp)
        return new_active, new_logp, done
