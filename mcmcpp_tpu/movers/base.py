"""Mover interface: batched propose + Metropolis accept over one half-ensemble.

The reference's mover contract is a per-walker virtual-ish method
``updateWalker(Walker&, Walker* complementarySet, int setSize, bool storePoint)``
checked by SFINAE (``MCMCpp/EnsembleSampler.h:49-51``,
``MCMCpp/Utility/UserOjbectsTest.h:144-151``). Here the contract is a pure
function over the whole half-ensemble at once:

    update_half(key, active, active_logp, other, logp_fn)
        -> (new_active, new_logp, accept_mask)

``active``/``other`` are ``(n_half, P)`` device arrays. Most movers only
implement :meth:`propose`, returning ``(proposal, extra_log_factor)`` where
the Metropolis log acceptance ratio is
``extra_log_factor + logp(Y) - logp(X)`` (symmetric proposals use 0; the
stretch move uses ``(P-1)·log z``, cf. ``MCMCpp/Movers/StretchMove.h:110``).

The accept test draws ``-Exponential`` for log u, matching the reference's
``getNegExponentialReal()`` (``MCMCpp/Utility/MultiSampler.h:86``) and
avoiding log(0). Accept/reject is branchless ``jnp.where`` — the accelerator-native
replacement for ``Walker::jumpToNewPointSwap`` / ``stayAtCurrentPoint``
(``MCMCpp/Walker/Walker.h:105,173``).
"""

import jax
import jax.numpy as jnp


class Mover:
    """Base class: subclasses implement ``propose`` (or override ``update_half``)."""

    #: movers that ignore the Metropolis test (diagnostic oracles) set this
    always_accept = False

    def init_state(self, n_params, dtype):
        """Optional per-mover static state (e.g. MH Cholesky factor). Pytree."""
        return ()

    def propose(self, key, active, other, state):
        """Return ``(proposal, extra_log_factor)`` for the active half.

        active: (n, P); other: (m, P) complementary half; state: pytree from
        init_state. extra_log_factor: (n,) added to the log accept ratio.
        """
        raise NotImplementedError

    def update_half(self, key, active, active_logp, other, logp_fn, state,
                    beta=1.0):
        """One Metropolis update of the active half against the other half.

        ``beta`` tempers the target to π^β (log-probs stay RAW; only the
        acceptance ratio is scaled) — used by parallel tempering.
        """
        kp, ka = jax.random.split(key)
        proposal, log_factor = self.propose(kp, active, other, state)
        prop_logp = logp_fn(proposal)
        if self.always_accept:
            n = active.shape[0]
            return proposal, prop_logp, jnp.ones((n,), dtype=bool)
        log_ratio = log_factor + beta * (prop_logp - active_logp)
        # log u = -Exp(1); accept iff log u < log_ratio (strict, as reference)
        log_u = -jax.random.exponential(ka, active_logp.shape, active_logp.dtype)
        accept = log_u < log_ratio
        new_active = jnp.where(accept[:, None], proposal, active)
        new_logp = jnp.where(accept, prop_logp, active_logp)
        return new_active, new_logp, accept
