"""The Goodman–Weare stretch distribution g(z) ∝ 1/√z on [1/a, a].

accelerator-native equivalent of the reference's inverse-CDF functor
(``MCMCpp/Utility/GwDistribution.h:40-58``): given u ~ U[0,1),

    z = ((√a − 1/√a) · u + 1/√a)²

All ops are elementwise; vmapping over walkers is free.
"""

import jax.numpy as jnp


def gw_sample(u, a=2.0):
    """Map uniform samples ``u`` in [0,1) to z ~ g(z) with scale ``a``.

    Vectorized inverse-CDF transform; works on any array shape/dtype.
    """
    sqrt_a = jnp.sqrt(jnp.asarray(a, dtype=u.dtype))
    lo = 1.0 / sqrt_a
    return jnp.square((sqrt_a - lo) * u + lo)


def gw_logpdf(z, a=2.0):
    """log g(z) (unnormalized up to the [1/a, a] support constant).

    g(z) = 1/(2(√a − 1/√a)) · z^{-1/2} on [1/a, a]; -inf outside.
    """
    z = jnp.asarray(z)
    a = jnp.asarray(a, dtype=z.dtype)
    norm = 2.0 * (jnp.sqrt(a) - 1.0 / jnp.sqrt(a))
    inside = (z >= 1.0 / a) & (z <= a)
    logp = -0.5 * jnp.log(z) - jnp.log(norm)
    return jnp.where(inside, logp, -jnp.inf)
