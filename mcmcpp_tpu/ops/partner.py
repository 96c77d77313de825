"""Complementary-walker selection: shared-shift (roll) vs iid gather.

The reference picks each walker's complementary partner(s) with per-walker
uniform draws (``MCMCpp/Movers/StretchMove.h:102``). The literal
translation — ``jnp.take(other, randint(...))`` — lowers to a per-row HBM
gather, which costs far more than the rest of the step at large W
(``benchmarks/partner_scale.py`` measures it).

The default selection is a **shared random shift**: draw r uniform in
[0, m) once per half-step and pair walker i with ``other[(i + r) % m]`` —
one contiguous ``jnp.roll``, no gather. Validity: the pairing is chosen
independently of the chain state, so conditioned on the complement the
update remains a product of valid per-walker Metropolis kernels, and the
step is a uniform mixture over m cyclic pairings — detailed balance holds
exactly as for iid selection (walkers in the active half are conditionally
independent given the complement). Movers needing k distinct partners draw
k *distinct* shifts, guaranteeing per-walker distinctness.

``mode="gather"`` keeps the reference-faithful iid choice for small
ensembles / parity studies.

``mode="block"`` (round-5) is the measured middle ground: walkers are
grouped in blocks of 128 and every block draws its OWN iid uniform shift
(vs one global shift for "roll", vs one iid draw per walker for
"gather"). The pairing is still independent of the chain state and each
walker's marginal partner is still uniform over the complement, so the
detailed-balance argument is unchanged — only the number of independent
pairing draws per half-step changes: 1 (roll) -> m/128 (block) -> m
(gather). Implemented as one global roll + a BLOCK-GRANULAR slab gather
(128x fewer gather indices than per-walker modes — when XLA's row gather
is index-issue-bound, index count, not locality, is what matters). Its
full-step cost against roll and gather is measured by
benchmarks/partner_scale.py (design notes in docs/design.md §10b).
"""

import jax
import jax.numpy as jnp

BLOCK = 128  # walkers per independent-shift group in "block" mode


def distinct_shifts(key, m, k):
    """k distinct uniform shifts in [0, m), k static & small (O(k²) scalar).

    Sorted-insertion sampling: draw d_t in [0, m−t) and bump it past each
    already-chosen value in increasing order — exact uniform sampling
    without replacement, branchless, all scalar ops.
    """
    if k > m:
        raise ValueError(f"need {k} distinct shifts from only {m} values")
    chosen = []
    for t in range(k):
        d = jax.random.randint(jax.random.fold_in(key, t), (), 0, m - t)
        if chosen:
            prev = jnp.sort(jnp.stack(chosen))
            for idx in range(t):
                d = d + (d >= prev[idx]).astype(d.dtype)
        chosen.append(d)
    return jnp.stack(chosen)


def rolled_partners(key, other, k):
    """(k, m, P) stack: row j is ``other`` rolled so that walker i sees
    partner (i + r_j) mod m, with r_1..r_k distinct."""
    m = other.shape[0]
    shifts = distinct_shifts(key, m, k)
    return jnp.stack([jnp.roll(other, -shifts[j], axis=0) for j in range(k)])


def _distinct_batch(key, n_rows, bound, k):
    """(n_rows, k) uniform draws WITHOUT replacement per row (vectorized
    sorted-insertion sampling, the batched form of :func:`distinct_shifts`)."""
    if k > bound:
        raise ValueError(f"need {k} distinct draws from only {bound} values")
    cols = []
    for t in range(k):
        d = jax.random.randint(
            jax.random.fold_in(key, t), (n_rows,), 0, bound - t
        )
        if cols:
            prev = jnp.sort(jnp.stack(cols, axis=-1), axis=-1)
            for s in range(t):
                d = d + (d >= prev[:, s]).astype(d.dtype)
        cols.append(d)
    return jnp.stack(cols, axis=-1)


def block_partners(key, other, n, k, block=None):
    """(k, n, P) partners with one iid uniform shift per 128-walker block.

    Walker i (block g = i // block) gets partner
    ``other[(i + r + block·q[g, j]) % m]`` with ONE global uniform shift
    r in [0, m) (shared across blocks and j — it makes every walker's
    marginal partner uniform over the whole complement) plus a per-block
    block-granular offset q[g, j] drawn uniformly WITHOUT replacement
    over [0, m/block) — distinct q's make the k partners of any single
    walker distinct, like the other modes.

    WHY this decomposition: where XLA's row gather is INDEX-ISSUE-bound,
    not HBM-transaction-bound (benchmarks/partner_scale.py measures it;
    a piecewise-contiguous per-walker index stream is then exactly as slow
    as a random one), index count is the cost. So the fast path
    gathers at BLOCK granularity: one roll (contiguous copy) + a coarse
    gather of n/block indices, each fetching a (block·P)-float row —
    128x fewer gather indices than per-walker modes.

    Fast path requires the red/black layout (n == m, m % block == 0);
    anything else falls back to the per-walker modulo-index gather
    (correct, but gather-speed — the small-ensemble case where it
    doesn't matter).
    """
    m, p = other.shape
    block = BLOCK if block is None else int(block)
    k_r, k_q = jax.random.split(key)
    # fast path needs at least k distinct BLOCK offsets; tiny ensembles
    # (m/block < k) route to the per-walker fallback, which draws the k
    # distinct shifts at walker granularity
    if n == m and m % block == 0 and m // block >= k:
        nb = m // block
        r = jax.random.randint(k_r, (), 0, m)
        q = _distinct_batch(k_q, nb, nb, k)            # (nb, k)
        rolled = jnp.roll(other, -r, axis=0)
        # leading-axis split only — a (nb, block*p) 2-D view can force
        # a materialized relayout of the (m, P) layout (docs/design.md
        # §10b); splitting the MAJOR axis
        # keeps the layout and the gather still moves (block, P) slabs
        # per index.
        stacked = rolled.reshape(nb, block, p)
        base = jnp.arange(nb, dtype=jnp.int32)
        out = [
            jnp.take(stacked, (base + q[:, j]) % nb, axis=0).reshape(n, p)
            for j in range(k)
        ]
        return jnp.stack(out)
    # fallback: arbitrary n / partial trailing block, per-walker indices
    n_blocks = -(-n // block)
    s = _distinct_batch(k_q, n_blocks, m, k)           # (n_blocks, k)
    idx_base = jnp.arange(n, dtype=jnp.int32)
    out = []
    for j in range(k):
        per_walker = jnp.repeat(s[:, j], block, total_repeat_length=n)
        out.append(jnp.take(other, (idx_base + per_walker) % m, axis=0))
    return jnp.stack(out)


def gather_partners(key, other, n, k):
    """(k, n, P) iid uniform partners (reference-faithful; HBM gather).

    For k ≥ 2 the draws are made distinct per walker via shifted draws
    (uniform over distinct k-tuples, no rejection loop) — replaces the
    reference's rejection loop (``DifferentialEvolution.h:116-120``).
    """
    m = other.shape[0]
    out = []
    prev_idx = []
    for t in range(k):
        kt = jax.random.fold_in(key, t)
        j = jax.random.randint(kt, (n,), 0, m - t)
        if prev_idx:
            prev = jnp.sort(jnp.stack(prev_idx, axis=-1), axis=-1)  # (n, t)
            for s in range(t):
                j = j + (j >= prev[:, s]).astype(j.dtype)
        prev_idx.append(j)
        out.append(jnp.take(other, j, axis=0))
    return jnp.stack(out)


def select_partners(key, other, n, k, mode):
    """Dispatch: (k, n, P) partners for n active walkers.

    mode="roll": shared-shift (requires n == m, the red/black layout).
    mode="block": one iid shift per 128-walker block (see module doc).
    mode="gather": iid per-walker uniform draws.
    """
    if mode == "roll":
        parts = rolled_partners(key, other, k)
        if parts.shape[1] != n:
            raise ValueError(
                f"roll mode requires equal halves (n={n}, m={parts.shape[1]})"
            )
        return parts
    if mode == "block":
        return block_partners(key, other, n, k)
    if mode == "gather":
        return gather_partners(key, other, n, k)
    raise ValueError(f"unknown partner mode {mode!r}")
