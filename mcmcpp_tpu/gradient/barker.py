"""Barker proposal MCMC (Livingstone & Zanella 2022, JRSS-B).

A first-order gradient kernel with the *robustness* of random walk and the
dimension scaling of MALA-family methods: the proposal uses the gradient
only through a per-coordinate Bernoulli sign flip, so the chain cannot be
destabilised by a too-large step size the way MALA's drift term can —
step-size adaptation converges from essentially any initial value, and
heavy-tailed / non-smooth targets that make MALA diverge remain ergodic.

Mechanics (preconditioned via whitened coordinates): draw a whitened
increment ``z ~ N(0, ε²I)``; keep the sign of coordinate ``i`` with
probability ``σ(z_i · (Cᵀg)_i)`` where ``C`` is the noise map
(:func:`~mcmcpp_tpu.gradient.metric.mass_noise`, ``C = diag(√Σ)`` or the
dense Cholesky factor) and ``g = ∇logp(x)`` — so moves aligned with the
gradient are favoured. The increment density for ``w = b·z`` is
``2·N(w; 0, ε²)·σ(w·g_w)``, giving the exact Hastings correction below
(the symmetric Gaussian factors cancel).

Doing Barker *per whitened coordinate* keeps the product-form proposal
density exact under both metrics — under a dense metric the position-space
increments are correlated, but the change of variables is linear so the
Jacobians cancel in the ratio. One gradient per step, all elementwise:
the cheapest member of the family after MALA, and fully fused by XLA.

The reference library is gradient-free (black-box Calculator contract,
``/root/reference/MCMCpp/Utility/UserOjbectsTest.h:144-151``); this kernel
is north-star scope alongside HMC/NUTS/MALA — included because its
robust-adaptation property is exactly what unattended large-batch accelerator runs
need (no hand-tuned step size, no divergence cascade).
"""

import jax
import jax.numpy as jnp

from mcmcpp_tpu.gradient.hmc import GradientSampler
from mcmcpp_tpu.gradient.metric import mass_noise, mass_noise_t


def barker_kernel(logp_fn):
    logp_grad_fn = jax.value_and_grad(logp_fn)

    def kernel(key, position, logp, grad, step_size, inv_mass):
        from mcmcpp_tpu.gradient.hmc import DIVERGENCE_THRESHOLD

        k_z, k_b, k_acc = jax.random.split(key, 3)
        z = step_size * jax.random.normal(k_z, position.shape, position.dtype)
        g_w = mass_noise_t(inv_mass, grad)  # gradient in whitened coords
        # P(keep sign of z_i) = sigmoid(z_i * g_w_i)
        u = jax.random.uniform(k_b, position.shape, position.dtype)
        b = jnp.where(u < jax.nn.sigmoid(z * g_w), 1.0, -1.0)
        w = b * z  # whitened increment
        proposal = position + mass_noise(inv_mass, w)
        lp_new, g_new = logp_grad_fn(proposal)
        g_w_new = mass_noise_t(inv_mass, g_new)
        # log q(x'|x) = Σ[log 2 + log N(w_i) - softplus(-w_i·g_w_i)];
        # reverse uses increment -w and the gradient at x'. Gaussians cancel.
        log_ratio = (
            lp_new
            - logp
            + jnp.sum(
                jax.nn.softplus(-w * g_w) - jax.nn.softplus(w * g_w_new)
            )
        )
        log_ratio = jnp.where(jnp.isnan(log_ratio), -jnp.inf, log_ratio)
        diverging = log_ratio < -DIVERGENCE_THRESHOLD
        # pseudo-Hamiltonian with the whitened increment as momentum (same
        # info contract as mala.py; E-BFMI is only meaningful for HMC)
        energy = 0.5 * jnp.sum((w / step_size) ** 2) - logp
        accept_prob = jnp.minimum(1.0, jnp.exp(log_ratio))
        log_u = -jax.random.exponential(k_acc, (), position.dtype)
        accept = log_u < log_ratio
        position = jnp.where(accept, proposal, position)
        logp = jnp.where(accept, lp_new, logp)
        grad = jnp.where(accept, g_new, grad)
        return (position, logp, grad), (accept_prob, accept, diverging, energy)

    return kernel


class BarkerSampler(GradientSampler):
    """Barker proposal with dual-averaged step size.

    ``target_accept=0.4``: the optimal-scaling analysis for the Barker
    proposal (Vogrinc, Livingstone & Zanella 2022) puts the efficiency
    plateau near 40% acceptance — well below MALA's 0.574 — and the
    plateau is wide, which is the point of the kernel.
    """

    def __init__(self, *args, target_accept=0.4, **kwargs):
        kwargs["target_accept"] = target_accept
        super().__init__(*args, **kwargs)

    def _make_kernel(self):
        return barker_kernel(self.logp_fn)
