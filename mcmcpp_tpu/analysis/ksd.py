"""Kernelized Stein discrepancy (KSD) — a sample-quality measure that
detects *bias*, not just autocorrelation (Gorham & Mackey 2017).

ESS/R-hat answer "has the chain mixed?"; they cannot see a stationary
distribution that is simply WRONG — the situation every stochastic-
gradient sampler (:mod:`mcmcpp_tpu.gradient.sgmcmc`) is in, since SGLD's
invariant measure carries an O(ε) step-size bias. The KSD measures the
discrepancy between the empirical measure of the draws and the target
*using only the score* ``∇log p`` (normalizing constant never needed):

    KSD²(q, p) = E_{x,y~q}[ k_0(x, y) ]

with the Stein kernel (for a base kernel k and score s = ∇log p)

    k_0(x,y) = s(x)ᵀs(y) k + s(x)ᵀ∇_y k + s(y)ᵀ∇_x k + tr ∇_x∇_y k .

Base kernel here is the inverse multiquadric (IMQ)
``k(x,y) = (c² + ‖x−y‖²)^β``, β ∈ (−1, 0) — the choice Gorham & Mackey
prove *detects non-convergence* (Gaussian/Matérn kernels can be blind to
it in ≥3 dims).

Accelerator-first shape: everything is pairwise n×n algebra — squared distances,
score inner products, and the trace term assemble from three (n, n)
matmuls plus elementwise maps; the whole estimator is one
fused XLA program, evaluated block-wise over rows so memory stays
O(block · n) at any chain length.

Beyond-reference scope: the C++ reference has no sample-quality layer at
all (its analysis stops at autocorrelation, AutoCorrCalc.h); this is the
modern complement recommended whenever minibatch gradients are in play.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["ksd", "ksd_curve"]


@functools.partial(jax.jit, static_argnames=("beta", "u_statistic"))
def _ksd_sum(x, scores, c2, beta, u_statistic):
    """Σ_{ij} k_0(x_i, x_j) (diagonal dropped for the U-statistic),
    computed in row blocks of the pairwise matrices."""
    n, p = x.shape
    sq = jnp.sum(x * x, axis=1)

    block = 2048 if n > 2048 else n
    n_pad = ((n + block - 1) // block) * block
    xp = jnp.pad(x, ((0, n_pad - n), (0, 0)))
    sp = jnp.pad(scores, ((0, n_pad - n), (0, 0)))
    valid = jnp.pad(jnp.ones((n,), x.dtype), (0, n_pad - n))
    sq_p = jnp.pad(sq, (0, n_pad - n))
    idx = jnp.arange(n_pad)

    def row_block(start):
        xb = jax.lax.dynamic_slice_in_dim(xp, start, block)  # (B, P)
        sb = jax.lax.dynamic_slice_in_dim(sp, start, block)
        vb = jax.lax.dynamic_slice_in_dim(valid, start, block)
        sqb = jax.lax.dynamic_slice_in_dim(sq_p, start, block)
        ib = jax.lax.dynamic_slice_in_dim(idx, start, block)
        # pairwise pieces, all (B, N): r² = ‖x_i−x_j‖², u = c²+r²
        r2 = sqb[:, None] + sq_p[None, :] - 2.0 * (xb @ xp.T)
        r2 = jnp.maximum(r2, 0.0)
        u = c2 + r2
        ub = u**beta
        ub1 = beta * u ** (beta - 1.0)
        ss = sb @ sp.T  # s(x_i)ᵀs(x_j)
        # dᵀ(s_j − s_i) with d = x_i − x_j:
        # x_i·s_j − x_j·s_j − x_i·s_i + x_j·s_i
        xs = xb @ sp.T  # x_i·s_j
        sx = sb @ xp.T  # s_i·x_j
        diag_xs = jnp.sum(xp * sp, axis=1)  # x_j·s_j
        d_ds = xs - diag_xs[None, :] - jnp.sum(xb * sb, axis=1)[:, None] + sx
        trace = -(4.0 * beta * (beta - 1.0)) * u ** (beta - 2.0) * r2 \
            - 2.0 * beta * p * u ** (beta - 1.0)
        k0 = ub * ss + 2.0 * ub1 * d_ds + trace
        mask = vb[:, None] * valid[None, :]
        if u_statistic:
            mask = mask * (ib[:, None] != idx[None, :])
        return jnp.sum(k0 * mask)

    starts = jnp.arange(0, n_pad, block)
    return jnp.sum(jax.lax.map(row_block, starts))


def ksd(samples, score_fn=None, scores=None, c=1.0, beta=-0.5,
        u_statistic=True):
    """KSD between the empirical measure of ``samples`` and the target
    with log-density ``score_fn`` — pass log p itself; its gradient (the
    score ∇log p) is taken and vmapped internally — or pass precomputed
    ``scores`` (an (n, P) array of ∇log p values) directly.

    samples: (n, P) flat draws (thin first — KSD cost is O(n²P), and
    thinned chains lose no detection power for bias). Returns the scalar
    KSD (square root of the V/U-statistic estimate; the U-statistic is
    unbiased and can go slightly negative under the square root — clipped
    at 0). Compare runs at matched n: smaller is closer to the target.
    """
    x = jnp.atleast_2d(jnp.asarray(samples))
    if scores is None:
        if score_fn is None:
            raise ValueError("provide score_fn or scores")
        scores = jax.vmap(jax.grad(score_fn))(x)
    scores = jnp.asarray(scores)
    if scores.shape != x.shape:
        raise ValueError(
            f"scores shape {scores.shape} != samples shape {x.shape}"
        )
    n = x.shape[0]
    total = _ksd_sum(x, scores, jnp.asarray(c * c, x.dtype), float(beta),
                     bool(u_statistic))
    denom = n * (n - 1) if u_statistic else n * n
    return float(np.sqrt(max(float(total) / denom, 0.0)))


def ksd_curve(samples_by_setting, score_fn, n=2048, seed=0, **kw):
    """Convenience for step-size / temperature sweeps: subsample each
    entry of ``{setting: (n_i, P) draws}`` to a common ``n`` and return
    ``{setting: ksd}`` — the standard SGLD step-size selection plot
    (Coullon et al. 2023). Matched n keeps the estimator comparable."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, draws in samples_by_setting.items():
        d = np.asarray(draws)
        d = d.reshape(-1, d.shape[-1])
        if d.shape[0] > n:
            d = d[rng.choice(d.shape[0], size=n, replace=False)]
        out[name] = ksd(d, score_fn=score_fn, **kw)
    return out
