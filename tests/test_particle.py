"""Particle filter / PMMH / PGAS oracles.

Strategy (SURVEY.md §4 pattern): a linear-Gaussian SSM gives EXACT truths
via the Kalman machinery in models/lgss — the PF likelihood estimate is
unbiased against the exact evidence, filtered means match the Kalman
means, PMMH's posterior matches a grid integration of the exact collapsed
likelihood, and PGAS trajectory draws match the RTS smoother moments.
A nonlinear stochastic-volatility smoke test covers the non-Gaussian
path the exact tools can't reach. Fixed seeds, generous MC tolerances.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mcmcpp_tpu import (
    BlockedGibbsSampler,
    ExactGibbsKernel,
    ParticleGibbsKernel,
    PMMHSampler,
    StateSpaceModel,
    particle_filter,
)
from mcmcpp_tpu.models.lgss import kalman_filter, lgss_loglik, lgss_params, rts_smoother


# -- a local-level model, exact truths from the Kalman path -------------------

SIG_Q, SIG_R, M0, P0 = 0.35, 0.6, 1.0, 2.0


def _local_level_ssm(sig_r=None):
    """theta = (log sig_r,) if sig_r is None else fixed scalar noise."""

    def init_sample(key, n, theta):
        return M0 + jnp.sqrt(P0) * jax.random.normal(key, (n, 1))

    def trans_sample(key, x, t, theta):
        return x + SIG_Q * jax.random.normal(key, x.shape)

    def obs_logpdf(y, x, t, theta):
        s = jnp.exp(theta[0]) if sig_r is None else sig_r
        z = (y[0] - x[:, 0]) / s
        return -0.5 * z * z - jnp.log(s) - 0.5 * np.log(2 * np.pi)

    def trans_logpdf(x_next, x, t, theta):
        z = (x_next[:, 0] - x[:, 0]) / SIG_Q
        return -0.5 * z * z - np.log(SIG_Q) - 0.5 * np.log(2 * np.pi)

    return StateSpaceModel(init_sample, trans_sample, obs_logpdf,
                           trans_logpdf)


def _data(t_n, seed=0):
    rng = np.random.default_rng(seed)
    x = np.empty(t_n)
    x[0] = M0 + np.sqrt(P0) * rng.standard_normal()
    for t in range(1, t_n):
        x[t] = x[t - 1] + SIG_Q * rng.standard_normal()
    ys = x + SIG_R * rng.standard_normal(t_n)
    return x, ys.astype(np.float32)


def _lgss(sig_r=SIG_R):
    return lgss_params(A=1.0, b=0.0, Q=SIG_Q**2, H=1.0, c=0.0,
                       R=sig_r**2, m0=M0, P0=P0)


def test_pf_loglik_unbiased_vs_kalman():
    """E[exp(loglik_hat)] = p(y) exactly (Del Moral 2004 Prop 7.4.1):
    the rep-averaged likelihood RATIO must be 1 within MC error, and the
    log-estimate mean must sit at-or-below the truth (Jensen)."""
    _, ys = _data(30)
    exact = float(lgss_loglik(_lgss(), ys))
    ssm = _local_level_ssm(sig_r=SIG_R)
    reps = 128

    def one(key):
        return particle_filter(key, ssm, None, ys, 256).loglik

    lls = np.asarray(
        jax.vmap(one)(jax.random.split(jax.random.key(42), reps)),
        np.float64,
    )
    assert np.isfinite(lls).all()
    ratio = np.exp(lls - exact)
    se = ratio.std(ddof=1) / np.sqrt(reps)
    assert abs(ratio.mean() - 1.0) < max(4.0 * se, 0.05), (
        ratio.mean(), se, exact, lls.mean(),
    )
    assert lls.mean() < exact + 0.1  # Jensen: E[log Z_hat] <= log Z


def test_pf_filtered_means_match_kalman():
    _, ys = _data(40, seed=3)
    f = kalman_filter(_lgss(), ys)
    res = particle_filter(
        jax.random.key(7), _local_level_ssm(SIG_R), None, ys, 8192
    )
    sd = np.sqrt(np.asarray(f.covs)[:, 0, 0])
    err = np.abs(np.asarray(res.filter_means)[:, 0] - np.asarray(f.means)[:, 0])
    # self-normalized IS error ~ sd/sqrt(ESS); use a generous 8-sigma band
    assert (err < 8.0 * sd / np.sqrt(np.asarray(res.ess)) + 0.02).all(), (
        err.max()
    )


def test_pf_ess_bounds_and_no_resample_mode():
    _, ys = _data(25, seed=5)
    ssm = _local_level_ssm(SIG_R)
    res = particle_filter(jax.random.key(0), ssm, None, ys, 128,
                          ess_frac=0.5)
    ess = np.asarray(res.ess)
    assert (ess >= 1.0 - 1e-3).all() and (ess <= 128.0 + 1e-3).all()
    # never-resample mode still yields a finite (higher-variance) estimate
    res0 = particle_filter(jax.random.key(0), ssm, None, ys, 128,
                           ess_frac=0.0)
    assert np.isfinite(float(res0.loglik))
    # degeneracy without resampling: final ESS must be lower
    assert np.asarray(res0.ess)[-1] <= ess[-1] + 1e-3


@pytest.mark.slow
def test_pmmh_matches_exact_grid_posterior():
    """1-D theta = log sig_r, N(0,1) prior: PMMH's posterior moments vs a
    dense grid integration of the EXACT (Kalman) collapsed likelihood —
    the pseudo-marginal chain must target the same posterior despite the
    noisy PF likelihood."""
    _, ys = _data(40, seed=11)

    # exact grid posterior over theta
    grid = np.linspace(-2.5, 1.5, 401)

    def exact_ll(th):
        return lgss_loglik(_lgss(sig_r=jnp.exp(th)), ys)

    ll = np.asarray(jax.vmap(exact_ll)(jnp.asarray(grid, jnp.float32)),
                    np.float64)
    logpost = ll - 0.5 * grid**2
    w = np.exp(logpost - logpost.max())
    w /= w.sum()
    mean_true = float(w @ grid)
    sd_true = float(np.sqrt(w @ (grid - mean_true) ** 2))

    s = PMMHSampler(
        _local_level_ssm(sig_r=None), ys,
        log_prior=lambda th: -0.5 * th[0] * th[0],
        n_params=1, n_particles=192, proposal_scale=0.35,
        n_chains=16, seed=1,
    )
    s.init(np.full((16, 1), 0.0, np.float32))
    s.run(500)
    acc = s.acceptance_fraction
    assert 0.05 < acc.mean() < 0.9, acc
    draws = np.asarray(s.get_samples(burn_in=150, flat=True))[:, 0]
    ess_proxy = draws.size / 20.0  # crude IACT guess for the tolerance
    tol = 4.0 * sd_true / np.sqrt(ess_proxy) + 0.05
    assert abs(draws.mean() - mean_true) < tol, (
        draws.mean(), mean_true, tol,
    )
    assert 0.5 * sd_true < draws.std() < 1.8 * sd_true, (
        draws.std(), sd_true,
    )


@pytest.mark.slow
def test_pgas_trajectories_match_smoother():
    """Known-parameter local level: PGAS draws from p(x_{1:T} | y), so
    pooled trajectory moments must match the RTS smoother."""
    t_n = 25
    _, ys = _data(t_n, seed=17)
    means, covs = rts_smoother(_lgss(), ys)
    means = np.asarray(means)[:, 0]
    sds = np.sqrt(np.asarray(covs)[:, 0, 0])

    gb = BlockedGibbsSampler(
        [("x", t_n, ParticleGibbsKernel(
            _local_level_ssm(SIG_R), ys, n_particles=48, theta_fn=None,
        ))],
        n_chains=8, seed=2,
    )
    gb.init({"x": np.zeros(t_n, np.float32)})
    gb.run(350)
    xs = np.asarray(gb.get_block("x"))[60:]          # (S, C, T)
    pooled = xs.reshape(-1, t_n).astype(np.float64)
    n_eff = pooled.shape[0] / 5.0                     # generous IACT guess
    tol = 5.0 * sds / np.sqrt(n_eff) + 0.02
    assert (np.abs(pooled.mean(0) - means) < tol).all(), (
        np.abs(pooled.mean(0) - means).max(), tol.max(),
    )
    np.testing.assert_allclose(pooled.std(0), sds, rtol=0.35, atol=0.03)


@pytest.mark.slow
def test_pgas_with_conjugate_hyper_block():
    """PGAS latent block + exact conjugate IG block for the observation
    variance, wired through theta_fn — the full particle-Gibbs loop."""
    t_n = 40
    x_true, ys = _data(t_n, seed=23)
    a0, b0 = 2.0, 1.0

    ssm = _local_level_ssm(sig_r=None)   # theta = (log sig_r,)

    def theta_fn(others):
        return 0.5 * jnp.log(others["s2r"])

    def sample_s2r(key, others):
        resid = jnp.asarray(ys) - others["x"]
        a_n = a0 + 0.5 * t_n
        b_n = b0 + 0.5 * jnp.sum(resid * resid)
        return (b_n / jax.random.gamma(key, a_n))[None]

    gb = BlockedGibbsSampler(
        [
            ("x", t_n, ParticleGibbsKernel(ssm, ys, n_particles=48,
                                           theta_fn=theta_fn)),
            ("s2r", 1, ExactGibbsKernel(sample_s2r)),
        ],
        n_chains=8, seed=0,
    )
    gb.init({"x": np.zeros(t_n, np.float32),
             "s2r": np.ones(1, np.float32)})
    gb.run(300)
    s2r = np.asarray(gb.get_block("s2r"))[80:].reshape(-1)
    xs = np.asarray(gb.get_block("x"))[80:]
    assert 0.1 < s2r.mean() < 1.2, s2r.mean()
    rmse = np.sqrt(((xs.mean((0, 1)) - x_true) ** 2).mean())
    assert rmse < SIG_R, rmse


def test_pgas_reference_slot_and_shapes():
    """Kernel contract: jittable, right shape/dtype, and with a single
    free particle budget the sampler still moves (invariance holds for
    any N >= 2)."""
    t_n = 12
    _, ys = _data(t_n, seed=31)
    kern = ParticleGibbsKernel(_local_level_ssm(SIG_R), ys, n_particles=2)
    x0 = jnp.zeros(t_n, jnp.float32)
    out = jax.jit(lambda k, x: kern.step(k, x, {}))(jax.random.key(3), x0)
    assert out.shape == (t_n,)
    assert out.dtype == jnp.float32
    assert np.isfinite(np.asarray(out)).all()
    with pytest.raises(ValueError, match="n_particles"):
        ParticleGibbsKernel(_local_level_ssm(SIG_R), ys, n_particles=1)
    no_trans = StateSpaceModel(
        _local_level_ssm(SIG_R).init_sample,
        _local_level_ssm(SIG_R).trans_sample,
        _local_level_ssm(SIG_R).obs_logpdf,
    )
    with pytest.raises(ValueError, match="trans_logpdf"):
        ParticleGibbsKernel(no_trans, ys)
    # plain CSMC fallback (no ancestor sampling) still runs
    kern2 = ParticleGibbsKernel(no_trans, ys, n_particles=8,
                                ancestor_sampling=False)
    out2 = kern2.step(jax.random.key(4), x0, {})
    assert np.isfinite(np.asarray(out2)).all()


@pytest.mark.slow
def test_pmmh_tune_fixes_bad_proposal():
    """Start with a hopeless proposal scale (5.0 → near-zero acceptance);
    tune() must bring post-tune acceptance into a healthy band and the
    tuned chain must still hit the exact grid posterior (adaptation is
    frozen before the kept samples, so exactness is preserved)."""
    _, ys = _data(40, seed=11)
    grid = np.linspace(-2.5, 1.5, 401)

    def exact_ll(th):
        return lgss_loglik(_lgss(sig_r=jnp.exp(th)), ys)

    ll = np.asarray(jax.vmap(exact_ll)(jnp.asarray(grid, jnp.float32)),
                    np.float64)
    logpost = ll - 0.5 * grid**2
    w = np.exp(logpost - logpost.max())
    w /= w.sum()
    mean_true = float(w @ grid)
    sd_true = float(np.sqrt(w @ (grid - mean_true) ** 2))

    s = PMMHSampler(
        _local_level_ssm(sig_r=None), ys,
        log_prior=lambda th: -0.5 * th[0] * th[0],
        n_params=1, n_particles=192, proposal_scale=5.0,
        n_chains=16, seed=3,
    )
    s.init(np.full((16, 1), 0.0, np.float32))
    s.tune(300, window=50)
    scale = float(np.asarray(s._prop_chol)[0, 0])
    assert scale < 3.0, scale  # shrunk from the hopeless 5.0
    s.run(400)
    acc = s.acceptance_fraction.mean()
    assert 0.08 < acc < 0.6, acc
    draws = np.asarray(s.get_samples(burn_in=100, flat=True))[:, 0]
    tol = 4.0 * sd_true / np.sqrt(draws.size / 20.0) + 0.05
    assert abs(draws.mean() - mean_true) < tol, (
        draws.mean(), mean_true, tol,
    )


def test_pmmh_tune_zero_spread_window_does_not_collapse_proposal():
    """Identical inits + a rejected window give zero cross-chain
    covariance; tune() must NOT adopt it (the proposal would collapse to
    the jitter floor and the adaptation would stall)."""
    _, ys = _data(20, seed=2)
    s = PMMHSampler(
        _local_level_ssm(sig_r=None), ys,
        log_prior=lambda th: -0.5 * th[0] * th[0],
        n_params=1, n_particles=32, proposal_scale=1e4,  # rejects all
        n_chains=8, seed=0,
    )
    s.init(np.zeros((8, 1), np.float32))
    s.tune(50, window=50)
    scale = float(np.asarray(s._prop_chol)[0, 0])
    assert scale > 1.0, scale  # shrunk by RM only, not collapsed to ~1e-3


def test_pmmh_mesh_sharded_bitwise():
    """Chain-axis sharding over the 8-device mesh must not change a bit
    (same keys, same arithmetic — the engine-wide determinism contract)."""
    from mcmcpp_tpu.parallel.mesh import make_walker_mesh

    _, ys = _data(20, seed=41)

    def build(mesh):
        s = PMMHSampler(
            _local_level_ssm(sig_r=None), ys,
            log_prior=lambda th: -0.5 * th[0] * th[0],
            n_params=1, n_particles=64, proposal_scale=0.4,
            n_chains=16, seed=5, mesh=mesh,
        )
        s.init(np.zeros((16, 1), np.float32))
        assert s.run(30)
        return np.asarray(s.get_samples())

    a = build(None)
    b = build(make_walker_mesh())
    np.testing.assert_array_equal(a, b)


def test_stochastic_volatility_smoke():
    """Nonlinear/non-Gaussian: SV model x_t = mu + phi(x-mu) + sig eta,
    y_t ~ N(0, exp(x_t)). The PF must produce a finite evidence estimate
    and filtered log-vol tracking the realized volatility regimes."""
    rng = np.random.default_rng(9)
    t_n, mu, phi, sig = 120, -1.0, 0.95, 0.3
    x = np.empty(t_n)
    x[0] = mu + sig / np.sqrt(1 - phi**2) * rng.standard_normal()
    for t in range(1, t_n):
        x[t] = mu + phi * (x[t - 1] - mu) + sig * rng.standard_normal()
    ys = (np.exp(x / 2) * rng.standard_normal(t_n)).astype(np.float32)

    def init_sample(key, n, theta):
        return mu + sig / np.sqrt(1 - phi**2) * jax.random.normal(
            key, (n, 1)
        )

    def trans_sample(key, xp, t, theta):
        return mu + phi * (xp - mu) + sig * jax.random.normal(
            key, xp.shape
        )

    def obs_logpdf(y, xp, t, theta):
        return -0.5 * (xp[:, 0] + y[0] ** 2 * jnp.exp(-xp[:, 0])
                       + np.log(2 * np.pi))

    ssm = StateSpaceModel(init_sample, trans_sample, obs_logpdf)
    res = particle_filter(jax.random.key(1), ssm, None, ys, 1024)
    assert np.isfinite(float(res.loglik))
    est = np.asarray(res.filter_means)[:, 0]
    # filtered log-vol correlates with the latent truth
    c = np.corrcoef(est, x)[0, 1]
    assert c > 0.5, c


def _local_level_data(t_n, sig_q, sig_r, seed):
    rng = np.random.default_rng(seed)
    x = np.empty(t_n)
    x[0] = M0 + np.sqrt(P0) * rng.standard_normal()
    for t in range(1, t_n):
        x[t] = x[t - 1] + sig_q * rng.standard_normal()
    return (x + sig_r * rng.standard_normal(t_n)).astype(np.float32)


def test_apf_point_lookahead_unbiased():
    """Auxiliary PF (Pitt & Shephard 1999), point lookahead, in its
    favorable regime (tight transition, diffuse likelihood): the
    evidence estimate must stay unbiased against the exact Kalman
    value. (The variance ORDERING vs bootstrap is regime-dependent —
    Johansen & Doucet 2008 — so only unbiasedness is asserted here; the
    dramatic, stable variance win is the fully-adapted test below.)"""
    sig_q, sig_r = 0.15, 0.5
    ys = _local_level_data(30, sig_q, sig_r, seed=4)
    exact = float(lgss_loglik(lgss_params(
        A=1.0, b=0.0, Q=sig_q**2, H=1.0, c=0.0, R=sig_r**2,
        m0=M0, P0=P0,
    ), ys))

    def trans_sample(key, xp, t, th):
        return xp + sig_q * jax.random.normal(key, xp.shape)

    def obs_logpdf(y, xp, t, th):
        z = (y[0] - xp[:, 0]) / sig_r
        return -0.5 * z * z - np.log(sig_r) - 0.5 * np.log(2 * np.pi)

    ssm = StateSpaceModel(
        _local_level_ssm(sig_r).init_sample, trans_sample, obs_logpdf,
        trans_mean=lambda xp, t, th: xp,
    )
    reps = 96
    keys = jax.random.split(jax.random.key(11), reps)
    ll_apf = np.asarray(jax.vmap(
        lambda k: particle_filter(k, ssm, None, ys, 128, auxiliary=True)
        .loglik
    )(keys), np.float64)
    ratio = np.exp(ll_apf - exact)
    se = ratio.std(ddof=1) / np.sqrt(reps)
    assert abs(ratio.mean() - 1.0) < max(4.0 * se, 0.05), (
        ratio.mean(), se,
    )


def test_fully_adapted_apf_collapses_variance():
    """Guided filter with the locally-optimal proposal
    p(x_t | x_{t-1}, y_t) + exact predictive lookahead
    p(y_t | x_{t-1}) = the FULLY-ADAPTED auxiliary filter: for the
    linear-Gaussian model its weight increments are deterministic given
    the ancestors, so the loglik-estimator variance must collapse
    relative to bootstrap (and stay unbiased)."""
    sig_q, sig_r = SIG_Q, 0.3
    q, r = sig_q**2, sig_r**2
    ys = _local_level_data(40, sig_q, sig_r, seed=8)
    exact = float(lgss_loglik(lgss_params(
        A=1.0, b=0.0, Q=q, H=1.0, c=0.0, R=r, m0=M0, P0=P0,
    ), ys))

    base = _local_level_ssm(sig_r)
    prec = 1.0 / q + 1.0 / r
    post_sd = np.sqrt(1.0 / prec)
    pred_sd = np.sqrt(q + r)

    def prop_sample(key, xp, y, t, th):
        mean = (xp / q + y[0] / r) / prec
        return mean + post_sd * jax.random.normal(key, xp.shape)

    def prop_logpdf(xn, xp, y, t, th):
        mean = (xp[:, 0] / q + y[0] / r) / prec
        z = (xn[:, 0] - mean) / post_sd
        return -0.5 * z * z - np.log(post_sd) - 0.5 * np.log(2 * np.pi)

    def lookahead_logpdf(y, xp, t, th):
        z = (y[0] - xp[:, 0]) / pred_sd
        return -0.5 * z * z - np.log(pred_sd) - 0.5 * np.log(2 * np.pi)

    ssm = base._replace(
        prop_sample=prop_sample, prop_logpdf=prop_logpdf,
        lookahead_logpdf=lookahead_logpdf,
    )
    reps = 64
    keys = jax.random.split(jax.random.key(3), reps)
    ll_fa = np.asarray(jax.vmap(
        lambda k: particle_filter(k, ssm, None, ys, 128, auxiliary=True)
        .loglik
    )(keys), np.float64)
    ll_boot = np.asarray(jax.vmap(
        lambda k: particle_filter(k, base, None, ys, 128).loglik
    )(keys), np.float64)
    # measured ~4-5x collapse on the CPU; 0.3 leaves margin for
    # backend-dependent resampling branches at this rep count
    assert ll_fa.var(ddof=1) < 0.3 * ll_boot.var(ddof=1), (
        ll_fa.var(ddof=1), ll_boot.var(ddof=1),
    )
    ratio = np.exp(ll_fa - exact)
    se = max(ratio.std(ddof=1) / np.sqrt(reps), 1e-6)
    assert abs(ratio.mean() - 1.0) < max(4.0 * se, 0.02), (
        ratio.mean(), se,
    )
    # guided WITHOUT the aux stage is also valid and low-variance
    ll_g = np.asarray(jax.vmap(
        lambda k: particle_filter(
            k, ssm._replace(lookahead_logpdf=None, trans_mean=None),
            None, ys, 128,
        ).loglik
    )(keys), np.float64)
    assert ll_g.var(ddof=1) < 0.5 * ll_boot.var(ddof=1), (
        ll_g.var(ddof=1), ll_boot.var(ddof=1),
    )


def test_filter_hook_validation():
    _, ys = _data(10)
    with pytest.raises(ValueError, match="trans_mean"):
        particle_filter(jax.random.key(0), _local_level_ssm(SIG_R), None,
                        ys, 32, auxiliary=True)
    bad = _local_level_ssm(SIG_R)._replace(
        prop_sample=lambda key, xp, y, t, th: xp
    )
    with pytest.raises(ValueError, match="prop_logpdf"):
        particle_filter(jax.random.key(0), bad, None, ys, 32)


def test_particle_smoother_matches_rts():
    """FFBS backward-simulation draws on the linear-Gaussian local level
    must reproduce the exact RTS marginal smoothing moments, and beat
    the FILTERED means on mid-sequence states (smoothing uses future
    data; filtering cannot)."""
    t_n = 25
    _, ys = _data(t_n, seed=29)
    means, covs = rts_smoother(_lgss(), ys)
    means = np.asarray(means)[:, 0]
    sds = np.sqrt(np.asarray(covs)[:, 0, 0])

    from mcmcpp_tpu import particle_smoother

    res = particle_smoother(
        jax.random.key(5), _local_level_ssm(SIG_R), None, ys,
        n_particles=2048, n_draws=512,
    )
    traj = np.asarray(res.trajectories)[:, :, 0]     # (J, T)
    assert traj.shape == (512, t_n)
    # backward draws share forward-cloud support: effective independent
    # draws < J, so use a conservative n_eff for the tolerance
    n_eff = 64.0
    tol = 5.0 * sds / np.sqrt(n_eff) + 0.02
    assert (np.abs(traj.mean(0) - means) < tol).all(), (
        np.abs(traj.mean(0) - means).max(), tol.max(),
    )
    np.testing.assert_allclose(traj.std(0), sds, rtol=0.4, atol=0.03)
    # the smoother must beat the filter's RMSE against the exact
    # smoothing means on interior states
    filt = particle_filter(
        jax.random.key(5), _local_level_ssm(SIG_R), None, ys, 2048
    )
    rmse_s = np.sqrt(((res.smoothed_means[:, 0] - means) ** 2).mean())
    rmse_f = np.sqrt(
        ((np.asarray(filt.filter_means)[:-1, 0] - means[:-1]) ** 2).mean()
    )
    assert rmse_s < rmse_f, (rmse_s, rmse_f)


def test_particle_smoother_requires_trans_logpdf():
    _, ys = _data(8)
    from mcmcpp_tpu import particle_smoother

    ssm = StateSpaceModel(
        _local_level_ssm(SIG_R).init_sample,
        _local_level_ssm(SIG_R).trans_sample,
        _local_level_ssm(SIG_R).obs_logpdf,
    )
    with pytest.raises(ValueError, match="trans_logpdf"):
        particle_smoother(jax.random.key(0), ssm, None, ys, 32, 8)


def test_particle_filter_mesh_sharded_parity():
    """Sharding ONE filter's particle axis over the 8-device mesh must
    agree with single-device to float-reduction tolerance (huge-N
    single-filter regime; the vmapped-filters path stays device-local)."""
    from mcmcpp_tpu.parallel.mesh import make_walker_mesh

    _, ys = _data(25, seed=5)
    ssm = _local_level_ssm(SIG_R)
    a = particle_filter(jax.random.key(0), ssm, None, ys, 128)
    b = particle_filter(jax.random.key(0), ssm, None, ys, 128,
                        mesh=make_walker_mesh())
    assert float(a.loglik) == pytest.approx(float(b.loglik), abs=1e-3)
    np.testing.assert_allclose(np.asarray(a.filter_means),
                               np.asarray(b.filter_means), atol=1e-4)
    with pytest.raises(ValueError, match="divisible"):
        particle_filter(jax.random.key(0), ssm, None, ys, 127,
                        mesh=make_walker_mesh())


def test_particle_forecast_matches_exact_predictive():
    """Local-level model: the particle predictive k steps ahead must
    match the exact Kalman forecast moments (mean + variance growing by
    Q per step), and the observation draws add R on top."""
    from mcmcpp_tpu import particle_forecast
    from mcmcpp_tpu.models.lgss import forecast as lgss_forecast

    t_n, h = 30, 5
    _, ys = _data(t_n, seed=19)
    ssm = _local_level_ssm(SIG_R)
    res = particle_filter(jax.random.key(0), ssm, None, ys, 4096,
                          return_particles=True)
    xs, yd = particle_forecast(
        jax.random.key(1), ssm, None, res.particles[-1],
        res.log_weights[-1], t_n, h,
        obs_sample=lambda k, x, t, th: x + SIG_R * jax.random.normal(
            k, x.shape
        ),
    )
    f_mean, f_cov, _, y_cov = lgss_forecast(_lgss(), ys, horizon=h)
    f_mean = np.asarray(f_mean)[:, 0]
    f_sd = np.sqrt(np.asarray(f_cov)[:, 0, 0])
    y_sd = np.sqrt(np.asarray(y_cov)[:, 0, 0])
    xs = np.asarray(xs)[:, :, 0]
    assert xs.shape == (h, 4096)
    err = np.abs(xs.mean(axis=1) - f_mean)
    assert (err < 6.0 * f_sd / np.sqrt(1024.0) + 0.02).all(), err
    np.testing.assert_allclose(xs.std(axis=1), f_sd, rtol=0.1)
    np.testing.assert_allclose(
        np.asarray(yd)[:, :, 0].std(axis=1), y_sd, rtol=0.1
    )
