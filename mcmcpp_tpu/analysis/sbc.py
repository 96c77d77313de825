"""Simulation-based calibration (Talts et al. 2018, arXiv:1804.06788).

Workflow-validation subsystem, beyond the reference (jmatta1/MCMCpp has
no calibration tooling; SURVEY.md §2). SBC checks the WHOLE inference
pipeline — model + sampler + tuning — at once: draw θ* from the prior,
simulate data y* | θ*, fit the posterior, and rank θ* among L posterior
draws. If the pipeline is calibrated, ranks are uniform on {0, …, L};
systematic ∪-shapes (overconfident posteriors), ∩-shapes (diffuse), or
skews (bias) each have a distinct signature.

Accelerator-first: the simulate-and-rank pipeline is a pure function of the key,
so the replication axis is one ``vmap`` (``vectorized=True``) when the
fit itself is jittable (analytic posteriors, ADVI, Laplace, a functional
HMC kernel); driver-class fits (EnsembleSampler, NUTSSampler) run in a
host loop with per-replication folded keys.
"""

import numpy as np
import jax
import jax.numpy as jnp


def sbc_ranks(prior_sample, simulate, fit, n_sims, seed=0,
              vectorized=False):
    """Rank statistics for ``n_sims`` SBC replications.

    prior_sample: (key) -> θ* pytree-free (Q,) array of the scalar
        quantities being calibrated (transform inside if the model has
        structure).
    simulate: (key, θ*) -> y* (any pytree) — one synthetic dataset.
    fit: (key, y*) -> (L, Q) posterior draws for that dataset. Draws
        should be approximately independent (thin by the integrated
        autocorrelation time first — Talts et al. §5.1; correlated draws
        skew ranks toward the extremes).
    vectorized: vmap the whole pipeline over replications (fit must be
        traceable); otherwise a host loop.

    Returns ``ranks`` (n_sims, Q) int32 in [0, L]: the number of
    posterior draws strictly below θ* per quantity.
    """
    key = jax.random.key(seed)

    def one(k):
        kp, ks, kf = jax.random.split(k, 3)
        theta = prior_sample(kp)
        y = simulate(ks, theta)
        draws = fit(kf, y)
        return jnp.sum(
            jnp.asarray(draws) < jnp.asarray(theta)[None, :], axis=0
        ).astype(jnp.int32)

    keys = jax.random.split(key, int(n_sims))
    if vectorized:
        return np.asarray(jax.jit(jax.vmap(one))(keys))
    return np.stack([np.asarray(one(k)) for k in keys])


def sbc_uniformity(ranks, n_posterior_draws, n_bins=None):
    """χ² uniformity test per quantity over binned ranks.

    Returns (stat (Q,), p_value (Q,)): Pearson χ² against the uniform
    histogram with ``n_bins`` bins (default: Talts et al.'s L+1 capped
    at 20 so expected counts stay ≥ ~5) and its survival-function
    p-value via the regularized incomplete gamma. Small p ⇒ the
    pipeline is miscalibrated for that quantity.
    """
    ranks = np.asarray(ranks)
    n_sims, n_q = ranks.shape
    levels = int(n_posterior_draws) + 1  # ranks live on {0..L}
    n_bins = int(min(levels, 20, max(2, n_sims // 5))
                 if n_bins is None else n_bins)
    n_bins = max(2, min(n_bins, levels))
    # bins need not divide the level count (levels is often prime, e.g.
    # L=100 → 101): integer edges give each bin a KNOWN number of rank
    # values, and the per-bin expectation follows from that — the null
    # stays exact for any levels/n_bins combination
    edges = np.round(np.linspace(0, levels, n_bins + 1)).astype(int)
    per_bin = np.diff(edges)  # integers per bin (differ by at most 1)
    expected = n_sims * per_bin / levels
    stats = np.empty(n_q)
    for q in range(n_q):
        counts, _ = np.histogram(ranks[:, q], bins=edges)
        stats[q] = np.sum((counts - expected) ** 2 / expected)
    df = n_bins - 1
    from jax.scipy.special import gammaincc

    p = np.asarray(gammaincc(df / 2.0, jnp.asarray(stats) / 2.0))
    return stats, p


def sbc_model(build_model, fit, n_sims, seed=0):
    """SBC for a declarative :class:`~mcmcpp_tpu.dsl.Model`.

    ``build_model(sim_data)`` returns the Model; called with ``None`` it
    must return the model on its ORIGINAL data (the template whose priors
    and observe sites define the simulator), and with a dict
    ``{site: array}`` it must attach that simulated data instead.
    ``fit(key, logp, dim) -> (L, dim)`` returns approximately independent
    UNCONSTRAINED posterior draws for the rebuilt model (ranks are
    computed per unconstrained coordinate — elementwise-monotone
    transforms preserve per-coordinate ranks, and any measurable function
    of θ is a valid SBC quantity regardless).

    Returns ``(ranks (n_sims, dim), L)`` ready for
    :func:`sbc_uniformity` / :func:`sbc_summary`.
    """
    template = build_model(None)
    _, _, dim, _, prior_sample = template.build_split()
    key = jax.random.key(seed)
    ranks = []
    n_draws = None
    for i in range(int(n_sims)):
        kp, ks, kf = jax.random.split(jax.random.fold_in(key, i), 3)
        theta = prior_sample(kp, 1)  # (1, dim) unconstrained
        sim = template.posterior_predictive(ks, theta)
        m = build_model({k: v[0] for k, v in sim.items()})
        logp, dim2, _ = m.build()
        if dim2 != dim:
            raise ValueError(
                f"rebuilt model changed dimension ({dim2} != {dim})"
            )
        draws = np.asarray(fit(kf, logp, dim))
        if n_draws is None:
            n_draws = draws.shape[0]
        elif draws.shape[0] != n_draws:
            raise ValueError("fit returned varying draw counts")
        ranks.append(
            np.sum(draws < np.asarray(theta)[0][None, :], axis=0)
        )
    return np.stack(ranks).astype(np.int32), n_draws


def sbc_ecdf_band(ranks, n_posterior_draws, alpha=0.05, n_sim=4000,
                  seed=0):
    """Simultaneous rank-ECDF confidence band (Säilynoja, Bürkner &
    Vehtari 2022 style, calibrated by Monte Carlo under the exact
    discrete-uniform null).

    The χ² test (``sbc_uniformity``) bins ranks; the ECDF band uses every
    rank level, so it detects smaller and more localized miscalibration.
    Under the null the ECDF of n_sims uniform ranks stays inside the band
    with probability 1-α SIMULTANEOUSLY over all levels.

    Returns a dict with ``levels`` (L+1,) the rank values, ``expected``
    the null CDF at each level, ``band`` the simultaneous half-width,
    ``ecdf`` (Q, L+1) the observed ECDFs, and ``reject`` (Q,) booleans.
    """
    ranks = np.asarray(ranks)
    n_sims, n_q = ranks.shape
    levels = int(n_posterior_draws) + 1
    ks = np.arange(levels)
    expected = (ks + 1.0) / levels
    # null distribution of the sup-deviation, exact by simulation
    rng = np.random.default_rng(seed)
    sims = rng.integers(0, levels, size=(int(n_sim), n_sims))
    # ECDF at every level via counting: (n_sim, levels)
    counts = np.apply_along_axis(
        lambda row: np.bincount(row, minlength=levels), 1, sims
    )
    null_ecdf = np.cumsum(counts, axis=1) / n_sims
    sup = np.max(np.abs(null_ecdf - expected[None, :]), axis=1)
    band = float(np.quantile(sup, 1.0 - alpha))
    ecdf = np.empty((n_q, levels))
    for q in range(n_q):
        c = np.bincount(ranks[:, q], minlength=levels)
        ecdf[q] = np.cumsum(c) / n_sims
    dev = np.max(np.abs(ecdf - expected[None, :]), axis=1)
    return {
        "levels": ks,
        "expected": expected,
        "band": band,
        "ecdf": ecdf,
        "max_deviation": dev,
        "reject": dev > band,
    }


def sbc_summary(ranks, n_posterior_draws, names=None):
    """Human-readable calibration report: per-quantity χ², p-value, and a
    shape diagnosis (uniform / overconfident / diffuse / biased)."""
    ranks = np.asarray(ranks)
    stats, p = sbc_uniformity(ranks, n_posterior_draws)
    lines = []
    l_half = n_posterior_draws / 2.0
    for q in range(ranks.shape[1]):
        name = names[q] if names is not None else f"q{q}"
        r = ranks[:, q]
        # tail mass vs center mass flags the failure shape
        lo, hi = np.quantile(r, [0.25, 0.75])
        spread = (hi - lo) / n_posterior_draws  # uniform → 0.5
        shift = (np.mean(r) - l_half) / n_posterior_draws
        if p[q] >= 0.05:
            shape = "uniform (calibrated)"
        elif abs(shift) > 0.1:
            shape = ("biased high (posterior underestimates)"
                     if shift > 0 else
                     "biased low (posterior overestimates)")
        elif spread > 0.55:
            shape = "∪-shaped (overconfident / too narrow)"
        else:
            shape = "∩-shaped (diffuse / too wide)"
        lines.append(
            f"{name}: chi2={stats[q]:.1f} p={p[q]:.3f} — {shape}"
        )
    return "\n".join(lines)
