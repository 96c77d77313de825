"""Log-prob DSL: transforms, priors, conjugate posterior recovery."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mcmcpp_tpu import EnsembleSampler, NUTSSampler, SMCSampler
from mcmcpp_tpu.dsl import (
    Beta, Exp, Exponential, Gamma, HalfNormal, LogNormal, Model, Normal,
    Sigmoid, Uniform,
)


def test_transform_round_trips():
    u = jnp.linspace(-3, 3, 11)
    for t in [Exp(), Sigmoid(-2.0, 5.0)]:
        np.testing.assert_allclose(t.inverse(t.forward(u)), u, atol=1e-5)


def test_transform_jacobian_matches_autodiff():
    for t in [Exp(), Sigmoid(0.0, 1.0)]:
        for u in [-1.2, 0.3, 2.0]:
            grad = jax.grad(lambda v: t.forward(v))(jnp.float32(u))
            np.testing.assert_allclose(
                float(t.log_det(jnp.float32(u))), float(jnp.log(grad)),
                atol=1e-5,
            )


@pytest.mark.parametrize("dist,mean,var", [
    (Normal(2.0, 3.0), 2.0, 9.0),
    (HalfNormal(1.0), np.sqrt(2 / np.pi), 1 - 2 / np.pi),
    (Exponential(2.0), 0.5, 0.25),
    (Gamma(3.0, 2.0), 1.5, 0.75),
    (Beta(2.0, 5.0), 2 / 7, 2 * 5 / (49 * 8)),
    (Uniform(-1.0, 3.0), 1.0, 16 / 12),
    (LogNormal(0.0, 0.5), np.exp(0.125), (np.exp(0.25) - 1) * np.exp(0.25)),
])
def test_distribution_samples_match_moments(dist, mean, var):
    x = np.asarray(dist.sample(jax.random.key(0), (200_000,)))
    assert x.mean() == pytest.approx(mean, abs=4 * np.sqrt(var / 2e5) + 1e-3)
    assert x.var() == pytest.approx(var, rel=0.05)


@pytest.mark.slow
def test_prior_only_model_sampling():
    """Sampling a prior-only model must recover the prior (transform
    Jacobians correct)."""
    model = Model().param("s", HalfNormal(2.0)).param("p", Beta(2.0, 2.0))
    logp, dim, constrain = model.build()
    assert dim == 2
    s = NUTSSampler(logp, n_chains=32, n_params=dim, seed=0, max_depth=6)
    s.init_ball(np.zeros(dim), scale=0.5, seed=1)
    s.warmup(300)
    s.run(1500)
    draws = constrain(s.get_samples(burn_in=100, flat=True))
    assert draws["s"].min() > 0
    assert 0 < draws["p"].min() and draws["p"].max() < 1
    assert draws["s"].mean() == pytest.approx(2.0 * np.sqrt(2 / np.pi),
                                              rel=0.1)
    assert draws["p"].mean() == pytest.approx(0.5, abs=0.03)


def test_conjugate_normal_posterior():
    """Known-posterior check: N(mu, 1) likelihood, N(0, 10²) prior."""
    rng = np.random.default_rng(0)
    data = jnp.asarray(rng.normal(3.0, 1.0, 50).astype(np.float32))
    model = (
        Model()
        .param("mu", Normal(0.0, 10.0))
        .likelihood(lambda p: jnp.sum(Normal(p["mu"], 1.0).logpdf(data)))
    )
    logp, dim, constrain = model.build()
    # analytic posterior
    prec = 1 / 100 + 50
    post_mean = float(jnp.sum(data)) / prec
    s = EnsembleSampler(logp, n_walkers=64, n_params=dim, seed=2)
    s.init_ball(np.zeros(dim), scale=1.0, seed=3)
    s.run_mcmc(300, store=False)
    s.run_mcmc(3000)
    mu = constrain(s.get_samples(flat=True))["mu"]
    assert mu.mean() == pytest.approx(post_mean, abs=0.05)
    assert mu.var() == pytest.approx(1 / prec, rel=0.2)


def test_vector_params_and_smc_integration():
    model = (
        Model()
        .param("w", Normal(0.0, 1.0), shape=(3,))
        .param("noise", HalfNormal(1.0))
    )
    logp, dim, constrain = model.build()
    assert dim == 4
    u = model.prior_sample(jax.random.key(0), 256)
    assert u.shape == (256, 4)
    smc = SMCSampler(
        log_prior_fn=logp,
        log_like_fn=lambda t: 0.0,
        prior_sample_fn=model.prior_sample,
        n_particles=256, n_params=dim, seed=1,
    )
    smc.run()
    draws = constrain(smc.particles)
    assert draws["w"].shape == (256, 3)
    assert draws["noise"].min() > 0


def test_duplicate_param_rejected():
    with pytest.raises(ValueError):
        Model().param("a", Normal()).param("a", Normal())


# -- deterministics / plates / observe / posterior predictive ----------------


@pytest.mark.slow
def test_deterministic_in_likelihood_and_constrain():
    data = np.array([2.0, 2.2, 1.8, 2.1])
    model = (
        Model()
        .param("log_mu", Normal(0.0, 10.0))
        .deterministic("mu", lambda p: jnp.exp(p["log_mu"]))
        .likelihood(lambda p: jnp.sum(Normal(p["mu"], 0.1).logpdf(data)))
    )
    logp, dim, constrain = model.build()
    assert dim == 1
    s = NUTSSampler(logp, n_chains=8, n_params=1, seed=0)
    s.init_ball(np.zeros(1), scale=0.1)
    s.warmup(200)
    s.run(500)
    draws = constrain(s.get_samples(flat=True))
    # deterministic comes back alongside the raw param
    assert set(draws) == {"log_mu", "mu"}
    np.testing.assert_allclose(draws["mu"], np.exp(draws["log_mu"]), rtol=1e-5)
    assert draws["mu"].mean() == pytest.approx(data.mean(), abs=0.1)


def test_plate_sugar_resolves_shapes():
    model = (
        Model()
        .plate("schools", 8)
        .param("mu", Normal(0.0, 5.0))
        .param("theta", Normal(0.0, 1.0), plate="schools")
    )
    _, dim, constrain = model.build()
    assert dim == 9
    draws = constrain(np.zeros((3, 9)))
    assert draws["theta"].shape == (3, 8)
    with pytest.raises(ValueError, match="unknown plate"):
        Model().param("x", Normal(), plate="nope")
    with pytest.raises(ValueError, match="not both"):
        Model().plate("p", 2).param("x", Normal(), shape=(2,), plate="p")
    with pytest.raises(ValueError, match="redeclared"):
        Model().plate("p", 2).plate("p", 3)


def test_observe_matches_manual_likelihood():
    data = np.array([0.3, -0.5, 1.2])

    def make(manual):
        m = Model().param("mu", Normal(0.0, 2.0))
        if manual:
            m.likelihood(lambda p: jnp.sum(Normal(p["mu"], 1.0).logpdf(data)))
        else:
            m.observe("y", lambda p: Normal(p["mu"], 1.0), data)
        return m.build()[0]

    theta = jnp.array([0.7])
    assert float(make(True)(theta)) == pytest.approx(
        float(make(False)(theta)), rel=1e-6
    )


def test_posterior_predictive_moments():
    """Conjugate check: with flat-ish prior, y_rep ~ N(mu_post, sigma^2 +
    posterior var of mu); mean of replicates ~ data mean."""
    rng = np.random.default_rng(0)
    data = rng.normal(3.0, 1.0, size=50)
    model = (
        Model()
        .param("mu", Normal(0.0, 100.0))
        .observe("y", lambda p: Normal(p["mu"], 1.0), data)
    )
    logp, dim, _ = model.build()
    s = NUTSSampler(logp, n_chains=8, n_params=1, seed=1)
    s.init_ball(np.zeros(1), scale=1.0)
    s.warmup(200)
    s.run(400)
    draws = s.get_samples(flat=True)
    rep = model.posterior_predictive(jax.random.key(2), draws)
    assert set(rep) == {"y"}
    assert rep["y"].shape == (draws.shape[0], 50)
    assert rep["y"].mean() == pytest.approx(data.mean(), abs=0.1)
    with pytest.raises(ValueError, match="unknown observe"):
        model.posterior_predictive(jax.random.key(0), draws, names=["z"])
    with pytest.raises(ValueError, match="no observe"):
        Model().param("a", Normal()).posterior_predictive(
            jax.random.key(0), draws
        )


def test_name_collision_across_kinds_rejected():
    with pytest.raises(ValueError, match="duplicate"):
        Model().param("a", Normal()).deterministic("a", lambda p: p["a"])
    with pytest.raises(ValueError, match="duplicate"):
        Model().param("a", Normal()).observe(
            "a", lambda p: Normal(p["a"], 1.0), np.zeros(2)
        )


# -- multivariate distributions ----------------------------------------------


class TestStickBreaking:
    def test_roundtrip_and_simplex(self):
        from mcmcpp_tpu.dsl import StickBreaking

        t = StickBreaking(5)
        u = jax.random.normal(jax.random.key(0), (4,))
        x = t.forward(u)
        assert x.shape == (5,)
        assert np.all(np.asarray(x) > 0)
        assert float(jnp.sum(x)) == pytest.approx(1.0, abs=1e-6)
        np.testing.assert_allclose(np.asarray(t.inverse(x)), np.asarray(u),
                                   atol=1e-5)
        # u = 0 -> uniform center
        c = t.forward(jnp.zeros(4))
        np.testing.assert_allclose(np.asarray(c), 0.2, atol=1e-6)

    def test_log_det_matches_autodiff(self):
        from mcmcpp_tpu.dsl import StickBreaking

        t = StickBreaking(4)
        u = jnp.asarray([0.3, -0.7, 1.1])
        jac = jax.jacfwd(lambda v: t.forward(v)[:-1])(u)  # intrinsic coords
        _, ref = jnp.linalg.slogdet(jac)
        assert float(t.log_det(u)) == pytest.approx(float(ref), abs=1e-5)


def test_dirichlet_conjugate_posterior():
    """Dir(alpha) prior + multinomial counts n -> posterior Dir(alpha+n):
    NUTS on the stick-broken space must recover the analytic mean."""
    from mcmcpp_tpu.dsl import Dirichlet

    alpha = np.array([2.0, 3.0, 1.5, 4.0])
    counts = np.array([10.0, 4.0, 7.0, 20.0])
    model = (
        Model()
        .param("p", Dirichlet(alpha), shape=(4,))
        .likelihood(lambda v: jnp.sum(counts * jnp.log(v["p"])))
    )
    logp, dim, constrain = model.build()
    assert dim == 3  # K-1 unconstrained dims
    s = NUTSSampler(logp, n_chains=16, n_params=dim, seed=0)
    s.init_ball(np.zeros(dim), scale=0.3)
    s.warmup(300)
    s.run(800)
    p = constrain(s.get_samples(flat=True))["p"]
    post = alpha + counts
    np.testing.assert_allclose(
        p.mean(axis=0), post / post.sum(), atol=0.02
    )
    # prior_sample round-trips through the transform
    u = model.prior_sample(jax.random.key(1), 512)
    assert u.shape == (512, 3)
    x = constrain(u)["p"]
    np.testing.assert_allclose(
        x.mean(axis=0), alpha / alpha.sum(), atol=0.07
    )


def test_mvnormal_prior_recovery():
    from mcmcpp_tpu.dsl import MvNormal

    mu = np.array([1.0, -1.0, 0.5])
    a = np.array([[1.0, 0.0, 0.0], [0.6, 0.8, 0.0], [-0.3, 0.2, 0.7]])
    cov = a @ a.T
    model = Model().param("w", MvNormal(mu, cov=cov), shape=(3,))
    logp, dim, constrain = model.build()
    s = NUTSSampler(logp, n_chains=16, n_params=dim, seed=2)
    s.init_ball(mu, scale=0.5)
    s.warmup(300)
    s.run(1000)
    w = constrain(s.get_samples(flat=True))["w"]
    np.testing.assert_allclose(w.mean(axis=0), mu, atol=0.1)
    np.testing.assert_allclose(np.cov(w.T), cov, atol=0.25)
    with pytest.raises(ValueError, match="exactly one"):
        MvNormal(mu, cov=cov, chol=a)


class TestLKJ:
    def test_corr_cholesky_roundtrip_and_validity(self):
        from mcmcpp_tpu.dsl import CorrCholesky

        t = CorrCholesky(4)
        u = jax.random.normal(jax.random.key(0), (6,)) * 0.8
        L = t.forward(u)
        # valid correlation Cholesky: unit row norms, positive diagonal,
        # upper triangle zero
        np.testing.assert_allclose(
            np.sum(np.asarray(L) ** 2, axis=1), 1.0, atol=1e-6
        )
        assert np.all(np.diagonal(L) > 0)
        assert np.allclose(np.triu(np.asarray(L), 1), 0.0)
        r = np.asarray(L @ L.T)
        np.testing.assert_allclose(np.diagonal(r), 1.0, atol=1e-6)
        np.testing.assert_allclose(np.asarray(t.inverse(L)), np.asarray(u),
                                   atol=1e-5)

    def test_log_det_matches_autodiff(self):
        from mcmcpp_tpu.dsl import CorrCholesky

        t = CorrCholesky(3)
        u = jnp.asarray([0.4, -0.9, 0.2])
        # intrinsic coords = strict lower triangle entries of L
        tril = jnp.tril_indices(3, -1)
        jac = jax.jacfwd(lambda v: t.forward(v)[tril])(u)
        _, ref = jnp.linalg.slogdet(jac)
        assert float(t.log_det(u)) == pytest.approx(float(ref), abs=1e-5)

    def test_eta1_k2_uniform_correlation(self):
        """K=2, eta=1: the correlation r is uniform on (-1, 1) — both in
        direct sampling and in NUTS draws from the prior density."""
        from mcmcpp_tpu.dsl import LKJCholesky

        d = LKJCholesky(2, eta=1.0)
        Ls = d.sample(jax.random.key(1), (4000, 2, 2))
        r = np.asarray(Ls[:, 1, 0])
        assert abs(r.mean()) < 0.06
        assert abs((r**2).mean() - 1.0 / 3.0) < 0.04  # Var uniform = 1/3

        model = Model().param("L", d, shape=(2, 2))
        logp, dim, constrain = model.build()
        assert dim == 1
        s = NUTSSampler(logp, n_chains=16, n_params=dim, seed=3)
        s.init_ball(np.zeros(dim), scale=0.5)
        s.warmup(300)
        s.run(1500)
        L = constrain(s.get_samples(flat=True))["L"]
        r2 = L[:, 1, 0]
        assert abs(r2.mean()) < 0.08
        assert abs((r2**2).mean() - 1.0 / 3.0) < 0.05

    def test_large_k_vectorized(self):
        """K=25 (300 coords): the vectorized cumprod construction must
        trace in O(1) ops — the round-1 unrolled loops choked here — and
        stay exactly consistent (roundtrip, unit rows, autodiff log_det)."""
        from mcmcpp_tpu.dsl import CorrCholesky

        k = 25
        t = CorrCholesky(k)
        m = k * (k - 1) // 2
        u = jax.random.normal(jax.random.key(5), (3, m)) * 0.4
        L = jax.jit(t.forward)(u)
        assert L.shape == (3, k, k)
        np.testing.assert_allclose(
            np.sum(np.asarray(L) ** 2, axis=-1), 1.0, atol=1e-5
        )
        assert np.all(np.asarray(jnp.diagonal(L, axis1=-2, axis2=-1)) > 0)
        # float32 roundtrip: masses multiply up to 24 (1-z²) factors, so
        # arctanh near the tails loses a few bits — 1e-3 is the honest bar
        np.testing.assert_allclose(np.asarray(t.inverse(L)), np.asarray(u),
                                   atol=1e-3)
        ld = jax.jit(t.log_det)(u)
        assert ld.shape == (3,)

        # autodiff check at a size jacfwd can afford
        t6 = CorrCholesky(6)
        u6 = jax.random.normal(jax.random.key(6), (15,)) * 0.7
        tril = jnp.tril_indices(6, -1)
        jac = jax.jacfwd(lambda v: t6.forward(v)[tril])(u6)
        _, ref = jnp.linalg.slogdet(jac)
        assert float(t6.log_det(u6)) == pytest.approx(float(ref), abs=1e-4)

    def test_eta_large_concentrates_identity(self):
        from mcmcpp_tpu.dsl import LKJCholesky

        d = LKJCholesky(3, eta=50.0)
        Ls = d.sample(jax.random.key(2), (2000, 3, 3))
        off = np.asarray(Ls)[:, 1, 0]
        assert np.abs(off).mean() < 0.15  # tight around 0


def test_lkj_prior_sample_batched():
    """prior_sample with an LKJ param: CorrCholesky.inverse must handle the
    (n, K, K) batch (review regression)."""
    from mcmcpp_tpu.dsl import LKJCholesky

    model = (
        Model()
        .param("mu", Normal(0.0, 1.0))
        .param("L", LKJCholesky(3, eta=2.0), shape=(3, 3))
    )
    u = model.prior_sample(jax.random.key(0), 17)
    assert u.shape == (17, 1 + 3)
    _, _, constrain = model.build()
    L = constrain(u)["L"]
    assert L.shape == (17, 3, 3)
    np.testing.assert_allclose(np.sum(L**2, axis=-1), 1.0, atol=1e-5)


class TestDiscreteObservations:
    def test_gamma_poisson_conjugate(self):
        """rate ~ Gamma(a, b), y_i ~ Poisson(rate): posterior is exactly
        Gamma(a + sum y, b + n)."""
        from mcmcpp_tpu.dsl import Poisson

        rng = np.random.default_rng(0)
        y = rng.poisson(4.0, size=40).astype(np.float64)
        a, b = 2.0, 0.5
        model = (
            Model()
            .param("rate", Gamma(a, b))
            .observe("y", lambda p: Poisson(p["rate"]), y)
        )
        logp, dim, constrain = model.build()
        s = NUTSSampler(logp, n_chains=16, n_params=dim, seed=1)
        s.init_ball(np.ones(dim), scale=0.2)
        s.warmup(300)
        s.run(800)
        rate = constrain(s.get_samples(flat=True))["rate"]
        a_n, b_n = a + y.sum(), b + len(y)
        assert rate.mean() == pytest.approx(a_n / b_n, rel=0.03)
        assert rate.std() == pytest.approx(np.sqrt(a_n) / b_n, rel=0.15)
        # posterior predictive: counts with the right mean
        rep = model.posterior_predictive(
            jax.random.key(2), s.get_samples(flat=True)[:500]
        )["y"]
        assert rep.shape == (500, 40)
        assert rep.mean() == pytest.approx(a_n / b_n, rel=0.1)

    def test_bernoulli_beta_conjugate(self):
        from mcmcpp_tpu.dsl import Bernoulli

        y = np.array([1, 1, 0, 1, 0, 1, 1, 1, 0, 1], np.float64)
        model = (
            Model()
            .param("p", Beta(1.0, 1.0))
            .observe("y", lambda v: Bernoulli(probs=v["p"]), y)
        )
        logp, dim, constrain = model.build()
        s = NUTSSampler(logp, n_chains=16, n_params=dim, seed=3)
        s.init_ball(np.zeros(dim), scale=0.5)
        s.warmup(200)
        s.run(600)
        p = constrain(s.get_samples(flat=True))["p"]
        a_n, b_n = 1 + y.sum(), 1 + (len(y) - y.sum())
        assert p.mean() == pytest.approx(a_n / (a_n + b_n), abs=0.02)

    def test_binomial_matches_scipy(self):
        from scipy import stats as sstats

        from mcmcpp_tpu.dsl import Binomial

        d = Binomial(20, probs=0.3)
        for k in (0.0, 5.0, 20.0):
            assert float(d.logpdf(k)) == pytest.approx(
                sstats.binom.logpmf(k, 20, 0.3), rel=1e-5
            )
        x = np.asarray(d.sample(jax.random.key(0), (4000,)))
        assert x.mean() == pytest.approx(6.0, rel=0.05)
        with pytest.raises(ValueError, match="exactly one"):
            Binomial(10)


class TestTruncated:
    """Truncated supports (ref has none — rebuild extension; VERDICT
    round-1 item 7)."""

    def test_logpdf_normalizes_and_respects_bounds(self):
        from scipy import stats as sstats

        from mcmcpp_tpu.dsl import Truncated

        d = Truncated(Normal(1.0, 2.0), low=-1.0, high=4.0)
        ref = sstats.truncnorm((-1 - 1) / 2, (4 - 1) / 2, loc=1.0, scale=2.0)
        for x in (-0.5, 1.0, 3.9):
            assert float(d.logpdf(x)) == pytest.approx(
                ref.logpdf(x), rel=1e-4
            )
        assert float(d.logpdf(-1.5)) == -np.inf
        assert float(d.logpdf(4.5)) == -np.inf
        assert float(d.cdf(-1.0)) == pytest.approx(0.0, abs=1e-6)
        assert float(d.cdf(4.0)) == pytest.approx(1.0, abs=1e-6)

    @pytest.mark.parametrize("lo,hi", [(-1.0, 2.0), (0.5, None), (None, 0.0)])
    def test_sample_matches_truncnorm_moments(self, lo, hi):
        from scipy import stats as sstats

        from mcmcpp_tpu.dsl import Truncated

        a = -np.inf if lo is None else lo
        b = np.inf if hi is None else hi
        ref = sstats.truncnorm(a, b)
        x = np.asarray(
            Truncated(Normal(), low=lo, high=hi).sample(
                jax.random.key(0), (100_000,)
            )
        )
        if lo is not None:
            assert x.min() >= lo
        if hi is not None:
            assert x.max() <= hi
        assert x.mean() == pytest.approx(ref.mean(), abs=0.01)
        assert x.std() == pytest.approx(ref.std(), rel=0.03)

    def test_truncated_exponential_sample(self):
        from mcmcpp_tpu.dsl import Truncated

        d = Truncated(Exponential(1.0), low=0.5, high=2.0)
        x = np.asarray(d.sample(jax.random.key(1), (100_000,)))
        assert 0.5 <= x.min() and x.max() <= 2.0
        # E[X | 0.5<X<2] for Exp(1) = 1 + (0.5 e^-0.5 - 2 e^-2)/(e^-0.5 - e^-2)
        num = 0.5 * np.exp(-0.5) - 2 * np.exp(-2.0)
        den = np.exp(-0.5) - np.exp(-2.0)
        assert x.mean() == pytest.approx(1.0 + num / den, abs=0.01)

    def test_validation(self):
        from mcmcpp_tpu.dsl import Bernoulli, Truncated

        with pytest.raises(ValueError, match="at least one"):
            Truncated(Normal())
        with pytest.raises(ValueError, match="low < high"):
            Truncated(Normal(), low=2.0, high=1.0)
        with pytest.raises(ValueError, match="truncation needs"):
            Truncated(Bernoulli(probs=0.5), low=0.0, high=1.0)

    @pytest.mark.slow
    def test_truncated_prior_nuts_jacobian(self):
        """Prior-only model with a truncated-Normal prior: NUTS on the
        unconstrained coordinate must recover the truncated prior exactly
        (transform Jacobian correct) — VERDICT item 7 acceptance test."""
        from scipy import stats as sstats

        from mcmcpp_tpu.dsl import Truncated

        model = Model().param("x", Truncated(Normal(0.0, 1.0),
                                             low=-0.5, high=2.0))
        logp, dim, constrain = model.build()
        s = NUTSSampler(logp, n_chains=32, n_params=dim, seed=0)
        s.init_ball(np.zeros(dim), scale=0.3, seed=1)
        s.warmup(300)
        s.run(1200)
        x = constrain(s.get_samples(burn_in=100, flat=True))["x"]
        ref = sstats.truncnorm(-0.5, 2.0)
        assert x.min() >= -0.5 and x.max() <= 2.0
        assert x.mean() == pytest.approx(ref.mean(), abs=0.02)
        assert x.std() == pytest.approx(ref.std(), rel=0.05)


class TestMaskedObserve:
    def test_masked_regression_recovers_params(self):
        """Linear regression with 30% of y missing (NaN): masked entries
        must not contribute and must not poison gradients (double-where) —
        VERDICT item 7 acceptance test."""
        rng = np.random.default_rng(0)
        n = 120
        x = np.linspace(-2, 2, n)
        y = 1.5 * x - 0.7 + rng.normal(0, 0.3, n)
        mask = rng.uniform(size=n) > 0.3
        y_nan = np.where(mask, y, np.nan)
        model = (
            Model()
            .param("a", Normal(0.0, 10.0))
            .param("b", Normal(0.0, 10.0))
            .observe(
                "y",
                lambda p: Normal(p["b"] * x, 0.3),
                y_nan - 0.0,
                mask=mask,
            )
        )
        # closed-form check vs observed-only least squares on the slope
        logp, dim, constrain = model.build()
        g = jax.grad(logp)(jnp.zeros(dim))
        assert np.all(np.isfinite(np.asarray(g)))
        s = NUTSSampler(logp, n_chains=16, n_params=dim, seed=0)
        s.init_ball(np.zeros(dim), scale=0.5)
        s.warmup(300)
        s.run(800)
        b = constrain(s.get_samples(flat=True))["b"]
        xo, yo = x[mask], y[mask]
        b_hat = (xo * yo).sum() / (xo * xo).sum()
        assert b.mean() == pytest.approx(b_hat, abs=0.05)

    def test_mask_excludes_entries_from_density(self):
        data = np.array([0.0, 100.0, 0.0])
        mask = np.array([True, False, True])
        m1 = (Model().param("mu", Normal(0.0, 5.0))
              .observe("y", lambda p: Normal(p["mu"], 1.0), data, mask=mask))
        m2 = (Model().param("mu", Normal(0.0, 5.0))
              .observe("y", lambda p: Normal(p["mu"], 1.0),
                       np.array([0.0, 0.0])))
        lp1, _, _ = m1.build()
        lp2, _, _ = m2.build()
        for u in (0.0, 1.3, -2.0):
            assert float(lp1(jnp.array([u]))) == pytest.approx(
                float(lp2(jnp.array([u]))), rel=1e-6
            )

    def test_masked_nan_data_gradient_finite(self):
        model = (
            Model()
            .param("mu", Normal(0.0, 1.0))
            .observe("y", lambda p: Normal(p["mu"], 1.0),
                     np.array([1.0, np.nan, 2.0]),
                     mask=np.array([True, False, True]))
        )
        logp, dim, _ = model.build()
        g = float(jax.grad(logp)(jnp.array([0.5])).squeeze())
        assert np.isfinite(g)


def test_binomial_large_n_sample_moments():
    """n > 256 uses the O(|shape|) bisection path (no (n, *shape) uniform
    temporary — VERDICT round-1 weak-item 7)."""
    from mcmcpp_tpu.dsl import Binomial

    n, p = 10_000, 0.3
    x = np.asarray(Binomial(n, probs=p).sample(jax.random.key(0), (20_000,)))
    assert x.min() >= 0 and x.max() <= n
    assert np.all(x == np.floor(x))
    assert x.mean() == pytest.approx(n * p, rel=0.005)
    assert x.var() == pytest.approx(n * p * (1 - p), rel=0.05)


class TestHalfCauchy:
    def test_logpdf_is_doubled_cauchy(self):
        from mcmcpp_tpu.dsl import Cauchy, HalfCauchy

        x = np.linspace(0.1, 30.0, 50).astype(np.float32)
        np.testing.assert_allclose(
            HalfCauchy(2.0).logpdf(x),
            np.log(2.0) + np.asarray(Cauchy(0.0, 2.0).logpdf(x)),
            rtol=1e-6,
        )

    def test_sample_median_is_scale(self):
        from mcmcpp_tpu.dsl import HalfCauchy

        x = np.asarray(HalfCauchy(3.0).sample(jax.random.key(0), (40_000,)))
        assert x.min() > 0
        # median of |Cauchy(0, s)| is exactly s (moments don't exist)
        assert np.median(x) == pytest.approx(3.0, rel=0.05)

    @pytest.mark.slow
    def test_scale_prior_recovers_sigma(self):
        from mcmcpp_tpu.dsl import HalfCauchy

        rng = np.random.default_rng(3)
        y = (2.5 * rng.standard_normal(200)).astype(np.float64)
        model = (
            Model()
            .param("sigma", HalfCauchy(5.0))
            .observe("y", lambda p: Normal(0.0, p["sigma"]), y)
        )
        logp, dim, constrain = model.build()
        s = NUTSSampler(logp, n_chains=16, n_params=dim, seed=1)
        s.init_ball(np.zeros(dim), scale=0.3)
        s.warmup(300)
        s.run(600)
        sigma = constrain(s.get_samples(flat=True))["sigma"]
        assert sigma.mean() == pytest.approx(y.std(), rel=0.1)


class TestCategorical:
    def test_logpdf_matches_log_probs(self):
        from mcmcpp_tpu.dsl import Categorical

        probs = np.array([0.2, 0.5, 0.3], np.float32)
        d = Categorical(probs=probs)
        x = np.array([0.0, 1.0, 2.0, 1.0])
        np.testing.assert_allclose(
            d.logpdf(x), np.log(probs)[x.astype(int)], rtol=1e-5
        )

    def test_logits_probs_exclusive(self):
        from mcmcpp_tpu.dsl import Categorical

        with pytest.raises(ValueError, match="exactly one"):
            Categorical()
        with pytest.raises(ValueError, match="exactly one"):
            Categorical(probs=[0.5, 0.5], logits=[0.0, 0.0])

    def test_sample_frequencies(self):
        from mcmcpp_tpu.dsl import Categorical

        probs = np.array([0.1, 0.6, 0.3], np.float32)
        x = np.asarray(
            Categorical(probs=probs).sample(jax.random.key(0), (50_000,))
        )
        freq = np.bincount(x.astype(int), minlength=3) / x.size
        np.testing.assert_allclose(freq, probs, atol=0.01)

    @pytest.mark.slow
    def test_dirichlet_categorical_conjugate(self):
        from mcmcpp_tpu.dsl import Categorical, Dirichlet

        rng = np.random.default_rng(0)
        true_p = np.array([0.2, 0.5, 0.3])
        y = rng.choice(3, size=300, p=true_p).astype(np.float64)
        alpha = np.ones(3)
        model = (
            Model()
            .param("p", Dirichlet(alpha), shape=(3,))
            .observe("y", lambda par: Categorical(probs=par["p"]), y)
        )
        logp, dim, constrain = model.build()
        s = NUTSSampler(logp, n_chains=16, n_params=dim, seed=1)
        s.init_ball(np.zeros(dim), scale=0.3)
        s.warmup(300)
        s.run(600)
        p = constrain(s.get_samples(flat=True))["p"]
        counts = np.bincount(y.astype(int), minlength=3)
        post_mean = (alpha + counts) / (alpha.sum() + len(y))
        np.testing.assert_allclose(p.mean(axis=0), post_mean, atol=0.02)


class TestNegativeBinomial:
    def test_logpdf_matches_scipy(self):
        from scipy import stats as sps

        from mcmcpp_tpu.dsl import NegativeBinomial

        r, p = 5.0, 0.4
        x = np.arange(0, 40, dtype=np.float32)
        np.testing.assert_allclose(
            NegativeBinomial(r, probs=p).logpdf(x),
            sps.nbinom.logpmf(x.astype(int), r, p),
            rtol=1e-4,
        )

    def test_sample_moments(self):
        from mcmcpp_tpu.dsl import NegativeBinomial

        r, p = 6.0, 0.3
        x = np.asarray(
            NegativeBinomial(r, probs=p).sample(jax.random.key(0), (40_000,))
        )
        assert x.min() >= 0 and np.all(x == np.floor(x))
        assert x.mean() == pytest.approx(r * (1 - p) / p, rel=0.02)
        assert x.var() == pytest.approx(r * (1 - p) / p**2, rel=0.05)


class TestOrderedTransform:
    def test_round_trip_and_monotone(self):
        from mcmcpp_tpu.dsl import Ordered

        t = Ordered()
        u = np.array([[0.5, -1.0, 2.0], [-3.0, 0.0, 0.1]], np.float32)
        x = np.asarray(t.forward(u))
        assert np.all(np.diff(x, axis=-1) > 0)
        np.testing.assert_allclose(np.asarray(t.inverse(x)), u, atol=1e-5)

    def test_log_det_matches_autodiff(self):
        from mcmcpp_tpu.dsl import Ordered

        t = Ordered()
        u = jnp.asarray([0.3, -0.7, 1.2])
        jac = jax.jacfwd(t.forward)(u)
        _, want = np.linalg.slogdet(np.asarray(jac))
        got = float(jnp.sum(t.log_det(u)))
        assert got == pytest.approx(float(want), rel=1e-5)

    def test_prior_sample_exact_order_statistics(self):
        """Round-2 advisor (medium): ordered() prior draws were NaN
        (inverse of unsorted iid draws). inverse_sample sorts first —
        the order statistics ARE exact restricted-prior draws."""
        from scipy import stats as sps

        from mcmcpp_tpu.dsl import ordered

        model = Model().param("locs", ordered(Normal(0.0, 1.0)), shape=(3,))
        _, _, _, constrain, prior_sample = model.build_split()
        u = np.asarray(prior_sample(jax.random.key(0), 4000))
        assert np.all(np.isfinite(u))
        x = constrain(u)["locs"]
        assert np.all(np.diff(x, axis=-1) > 0)
        # max of 3 iid N(0,1) has CDF Phi(x)^3
        ks = sps.kstest(x[:, -1], lambda v: sps.norm.cdf(v) ** 3)
        assert ks.pvalue > 1e-3
        # Model.prior_sample (the standalone method) uses the same hook
        u2 = np.asarray(model.prior_sample(jax.random.key(1), 256))
        assert np.all(np.isfinite(u2))

    def test_logprior_is_normalized(self):
        """The restricted ordered prior carries its log K! normalizer
        (without it every evidence engine is biased by -log K!):
        numerically integrate exp(logprior) over u-space for K=2."""
        from mcmcpp_tpu.dsl import ordered

        model = Model().param("locs", ordered(Normal(0.0, 1.0)), shape=(2,))
        logprior, _, dim, _, _ = model.build_split()
        assert dim == 2
        u1 = np.linspace(-7.0, 7.0, 281)
        u2 = np.linspace(-14.0, 3.0, 341)
        g1, g2 = np.meshgrid(u1, u2, indexing="ij")
        pts = jnp.asarray(np.stack([g1.ravel(), g2.ravel()], axis=1))
        vals = np.asarray(jax.vmap(logprior)(pts)).reshape(g1.shape)
        total = np.trapezoid(
            np.trapezoid(np.exp(vals), u2, axis=1), u1
        )
        assert total == pytest.approx(1.0, abs=5e-3)

    @pytest.mark.slow
    def test_mixture_locations_identifiable(self):
        """2-component Gaussian mixture with ordered locs: NUTS recovers
        the sorted component means without label switching."""
        from mcmcpp_tpu.dsl import Mixture, ordered

        rng = np.random.default_rng(0)
        y = np.concatenate([
            rng.normal(-2.0, 0.5, 150), rng.normal(3.0, 0.5, 150)
        ]).astype(np.float64)
        model = (
            Model()
            .param("locs", ordered(Normal(0.0, 5.0)), shape=(2,))
            .observe(
                "y",
                lambda p: Mixture(
                    [Normal(p["locs"][0], 0.5), Normal(p["locs"][1], 0.5)],
                    weights=[0.5, 0.5],
                ),
                y,
            )
        )
        logp, dim, constrain = model.build()
        s = NUTSSampler(logp, n_chains=16, n_params=dim, seed=1, max_depth=8)
        s.init_ball(np.zeros(dim), scale=0.5)
        s.warmup(400)
        s.run(600)
        locs = constrain(s.get_samples(burn_in=100, flat=True))["locs"]
        assert np.all(np.diff(locs, axis=-1) > 0)  # constraint held
        np.testing.assert_allclose(
            locs.mean(axis=0), [-2.0, 3.0], atol=0.15
        )


class TestMixture:
    def test_logpdf_matches_manual(self):
        from mcmcpp_tpu.dsl import Mixture

        m = Mixture([Normal(-1.0, 1.0), Normal(2.0, 0.5)],
                    weights=[0.3, 0.7])
        x = np.linspace(-4, 4, 30).astype(np.float32)
        from scipy import stats as sps

        want = np.log(0.3 * sps.norm.pdf(x, -1.0, 1.0)
                      + 0.7 * sps.norm.pdf(x, 2.0, 0.5))
        np.testing.assert_allclose(m.logpdf(x), want, rtol=1e-4)

    def test_sample_moments(self):
        from mcmcpp_tpu.dsl import Mixture

        m = Mixture([Normal(-1.0, 1.0), Normal(2.0, 0.5)],
                    weights=[0.3, 0.7])
        x = np.asarray(m.sample(jax.random.key(0), (60_000,)))
        mean = 0.3 * -1.0 + 0.7 * 2.0
        var = (0.3 * (1.0 + 1.0) + 0.7 * (0.25 + 4.0)) - mean**2
        assert x.mean() == pytest.approx(mean, abs=0.03)
        assert x.var() == pytest.approx(var, rel=0.03)

    def test_validation(self):
        from mcmcpp_tpu.dsl import Mixture

        with pytest.raises(ValueError, match=">= 2"):
            Mixture([Normal(0, 1)], weights=[1.0])
        with pytest.raises(ValueError, match="exactly one"):
            Mixture([Normal(0, 1), Normal(1, 1)])


class TestRound2Distributions:
    """InverseGamma / Weibull / Gumbel / Pareto / Geometric / BetaBinomial
    / Multinomial / ZeroInflatedPoisson: scipy logpdf oracles + sample
    moments + transform support."""

    def test_logpdfs_match_scipy(self):
        from scipy import stats as sps
        from mcmcpp_tpu.dsl import (
            BetaBinomial, Geometric, Gumbel, InverseGamma, Multinomial,
            Pareto, Weibull, ZeroInflatedPoisson,
        )

        xc = np.linspace(0.1, 8.0, 23).astype(np.float32)
        np.testing.assert_allclose(
            InverseGamma(3.0, 2.0).logpdf(xc),
            sps.invgamma.logpdf(xc, 3.0, scale=2.0), rtol=2e-4)
        np.testing.assert_allclose(
            Weibull(1.7, 2.5).logpdf(xc),
            sps.weibull_min.logpdf(xc, 1.7, scale=2.5), rtol=2e-4)
        xr = np.linspace(-5, 8, 23).astype(np.float32)
        np.testing.assert_allclose(
            Gumbel(0.5, 1.3).logpdf(xr),
            sps.gumbel_r.logpdf(xr, 0.5, 1.3), rtol=2e-4)
        xp = np.linspace(1.6, 20.0, 23).astype(np.float32)
        np.testing.assert_allclose(
            Pareto(1.5, 2.5).logpdf(xp),
            sps.pareto.logpdf(xp, 2.5, scale=1.5), rtol=2e-4)
        k = np.arange(0, 12).astype(np.float32)
        np.testing.assert_allclose(
            Geometric(probs=0.3).logpdf(k),
            sps.geom.logpmf(k + 1, 0.3), rtol=2e-4)
        np.testing.assert_allclose(
            BetaBinomial(10, 2.0, 3.0).logpdf(k[k <= 10]),
            sps.betabinom.logpmf(k[k <= 10].astype(int), 10, 2.0, 3.0),
            rtol=2e-4)
        counts = np.array([[3, 5, 2], [0, 10, 0], [4, 4, 2]], np.float32)
        p = np.array([0.2, 0.5, 0.3])
        np.testing.assert_allclose(
            Multinomial(10, probs=p).logpdf(counts),
            sps.multinomial.logpmf(counts, 10, p), rtol=2e-4)
        zlam, zgate = 3.0, 0.25
        zp = ZeroInflatedPoisson(zgate, zlam)
        want0 = np.log(zgate + (1 - zgate) * np.exp(-zlam))
        assert float(zp.logpdf(0.0)) == pytest.approx(want0, rel=1e-5)
        np.testing.assert_allclose(
            zp.logpdf(k[1:]),
            np.log(1 - zgate) + sps.poisson.logpmf(k[1:].astype(int), zlam),
            rtol=2e-4)

    def test_cdfs_match_scipy(self):
        from scipy import stats as sps
        from mcmcpp_tpu.dsl import Gumbel, InverseGamma, Pareto, Weibull

        xc = np.linspace(0.2, 9.0, 17).astype(np.float32)
        np.testing.assert_allclose(
            InverseGamma(3.0, 2.0).cdf(xc),
            sps.invgamma.cdf(xc, 3.0, scale=2.0), atol=2e-5)
        np.testing.assert_allclose(
            Weibull(1.7, 2.5).cdf(xc),
            sps.weibull_min.cdf(xc, 1.7, scale=2.5), atol=2e-5)
        np.testing.assert_allclose(
            Gumbel(0.5, 1.3).cdf(xc),
            sps.gumbel_r.cdf(xc, 0.5, 1.3), atol=2e-5)
        np.testing.assert_allclose(
            Pareto(1.5, 2.5).cdf(xc),
            sps.pareto.cdf(xc, 2.5, scale=1.5), atol=2e-5)

    def test_sample_moments(self):
        from mcmcpp_tpu.dsl import (
            BetaBinomial, Geometric, Gumbel, InverseGamma, Multinomial,
            Pareto, Weibull, ZeroInflatedPoisson,
        )
        import math

        n = 60_000
        key = jax.random.key(0)
        x = np.asarray(InverseGamma(4.0, 3.0).sample(key, (n,)))
        assert x.mean() == pytest.approx(3.0 / 3.0, rel=0.05)
        assert x.min() > 0
        x = np.asarray(Weibull(2.0, 3.0).sample(key, (n,)))
        assert x.mean() == pytest.approx(3.0 * math.gamma(1.5), rel=0.03)
        x = np.asarray(Gumbel(1.0, 2.0).sample(key, (n,)))
        assert x.mean() == pytest.approx(1.0 + 2.0 * 0.5772157, rel=0.05)
        x = np.asarray(Pareto(2.0, 3.0).sample(key, (n,)))
        assert x.mean() == pytest.approx(3.0 * 2.0 / 2.0, rel=0.05)
        assert x.min() >= 2.0
        x = np.asarray(Geometric(probs=0.25).sample(key, (n,)))
        assert x.mean() == pytest.approx(0.75 / 0.25, rel=0.05)
        assert x.min() >= 0
        x = np.asarray(BetaBinomial(10, 2.0, 3.0).sample(key, (n,)))
        assert x.mean() == pytest.approx(10 * 2.0 / 5.0, rel=0.05)
        # betabinomial variance exceeds binomial(n, a/(a+b)) variance
        var_bin = 10 * 0.4 * 0.6
        assert x.var() > 1.3 * var_bin
        x = np.asarray(Multinomial(20, probs=[0.2, 0.5, 0.3]).sample(
            key, (n, 3)))
        assert x.shape == (n, 3)
        np.testing.assert_allclose(x.sum(-1), 20.0)
        np.testing.assert_allclose(x.mean(0), [4.0, 10.0, 6.0], rtol=0.05)
        x = np.asarray(ZeroInflatedPoisson(0.3, 4.0).sample(key, (n,)))
        assert x.mean() == pytest.approx(0.7 * 4.0, rel=0.05)
        assert (x == 0).mean() == pytest.approx(
            0.3 + 0.7 * np.exp(-4.0), abs=0.01)

    def test_positive_supports_sampleable_by_nuts(self):
        """InverseGamma variance prior recovered through the Exp transform
        (conjugate oracle: posterior of sigma^2 is InverseGamma)."""
        from mcmcpp_tpu import NUTSSampler
        from mcmcpp_tpu.dsl import InverseGamma, Model, Normal

        rng = np.random.default_rng(0)
        data = rng.normal(0.0, 1.5, size=40).astype(np.float32)
        a0, b0 = 3.0, 2.0
        model = (Model()
                 .param("var", InverseGamma(a0, b0))
                 .likelihood(lambda p: jnp.sum(
                     Normal(0.0, jnp.sqrt(p["var"])).logpdf(data))))
        logp, dim, constrain = model.build()
        s = NUTSSampler(logp, n_chains=16, n_params=dim, seed=0)
        s.init_ball(np.zeros(dim), scale=0.3)
        s.warmup(300)
        s.run(400)
        var_draws = constrain(s.get_samples(flat=True))["var"]
        a_post = a0 + data.size / 2
        b_post = b0 + 0.5 * float(np.sum(data**2))
        assert var_draws.mean() == pytest.approx(
            b_post / (a_post - 1), rel=0.1)
        assert var_draws.min() > 0

    def test_truncated_weibull_uses_cdf(self):
        from scipy import stats as sps
        from mcmcpp_tpu.dsl import Truncated, Weibull

        t = Truncated(Weibull(1.5, 2.0), low=1.0, high=4.0)
        x = np.asarray(t.sample(jax.random.key(1), (40_000,)))
        assert x.min() >= 1.0 and x.max() <= 4.0
        lo, hi = sps.weibull_min.cdf([1.0, 4.0], 1.5, scale=2.0)
        want_mean = sps.weibull_min.expect(
            lambda v: v, args=(1.5,), scale=2.0, lb=1.0, ub=4.0
        ) / (hi - lo)
        assert x.mean() == pytest.approx(want_mean, rel=0.02)

    def test_validation(self):
        from mcmcpp_tpu.dsl import Geometric, Multinomial

        with pytest.raises(ValueError, match="exactly one"):
            Geometric()
        with pytest.raises(ValueError, match="exactly one"):
            Multinomial(5, probs=[0.5, 0.5], logits=[0.0, 0.0])


class TestBuildSplit:
    """build_split: evidence decomposition consistent with build()."""

    def _model(self):
        from mcmcpp_tpu.dsl import HalfNormal, Model, Normal

        data = np.array([0.4, 1.2, 0.8, 1.9, 0.1], np.float32)
        return (
            Model()
            .param("mu", Normal(0.0, 2.0))
            .param("sigma", HalfNormal(1.5))
            .observe("y", lambda p: Normal(p["mu"], p["sigma"]), data)
        )

    def test_sum_matches_build(self):
        m = self._model()
        logp, dim, _ = m.build()
        logprior, loglike, dim2, _, _ = m.build_split()
        assert dim2 == dim
        rng = np.random.default_rng(0)
        for _ in range(5):
            t = jnp.asarray(rng.normal(size=dim).astype(np.float32))
            total = float(logprior(t)) + float(loglike(t))
            assert total == pytest.approx(float(logp(t)), rel=1e-5)

    def test_prior_sample_moments_and_jacobian(self):
        m = self._model()
        logprior, _, dim, constrain, prior_sample = m.build_split()
        u = prior_sample(jax.random.key(0), 50_000)
        assert u.shape == (50_000, dim)
        vals = constrain(u)
        assert vals["mu"].mean() == pytest.approx(0.0, abs=0.03)
        assert vals["mu"].std() == pytest.approx(2.0, rel=0.03)
        # sigma is HalfNormal(1.5): mean = 1.5·sqrt(2/pi)
        assert vals["sigma"].mean() == pytest.approx(
            1.5 * np.sqrt(2 / np.pi), rel=0.03)
        assert (vals["sigma"] > 0).all()
        # logprior is a PROPER density on R^dim: MC check of normalization
        # via importance sampling against N(0, 3 I)
        z = 3.0 * np.random.default_rng(1).normal(size=(200_000, dim))
        z = jnp.asarray(z.astype(np.float32))
        lp = jax.vmap(logprior)(z)
        lq = jnp.sum(
            -0.5 * (z / 3.0) ** 2 - np.log(3.0 * np.sqrt(2 * np.pi)), -1
        )
        est = jax.scipy.special.logsumexp(lp - lq) - np.log(z.shape[0])
        assert float(est) == pytest.approx(0.0, abs=0.05)

    def test_dsl_model_evidence_via_all_engines(self):
        """Conjugate normal-mean model declared in the DSL, evidence from
        SMC and nested sampling vs the analytic marginal likelihood."""
        from mcmcpp_tpu import NestedSampler, SMCSampler
        from mcmcpp_tpu.dsl import Model, Normal

        data = np.array([1.1, 0.3, 0.9, 1.7, 0.6, 1.2], np.float32)
        tau = 2.0
        m = (Model()
             .param("mu", Normal(0.0, tau))
             .observe("y", lambda p: Normal(p["mu"], 1.0), data))
        logprior, loglike, dim, _, prior_sample = m.build_split()
        # analytic: y ~ N(0, tau^2 11^T + I)
        n = data.size
        cov = tau**2 * np.ones((n, n)) + np.eye(n)
        sign, logdet = np.linalg.slogdet(cov)
        logz_true = float(
            -0.5 * data @ np.linalg.solve(cov, data)
            - 0.5 * logdet - n / 2 * np.log(2 * np.pi)
        )
        smc = SMCSampler(logprior, loglike, prior_sample,
                         n_particles=2048, n_params=dim, n_mcmc=5, seed=0)
        smc.run()
        assert smc.log_evidence == pytest.approx(logz_true, abs=0.15)
        ns = NestedSampler(logprior, loglike, prior_sample, n_params=dim,
                           n_live=400, n_mcmc=25, seed=0)
        r = ns.run()
        assert r.logz == pytest.approx(
            logz_true, abs=max(3 * r.logz_err, 0.2))

    def test_shape_changing_transform_prior_sample(self):
        from mcmcpp_tpu.dsl import Dirichlet, Model

        m = Model().param("w", Dirichlet(np.array([2.0, 3.0, 4.0])),
                          shape=(3,))
        _, _, dim, constrain, prior_sample = m.build_split()
        assert dim == 2  # K-1 unconstrained dims
        u = prior_sample(jax.random.key(2), 30_000)
        w = constrain(u)["w"]
        np.testing.assert_allclose(w.sum(-1), 1.0, atol=1e-5)
        np.testing.assert_allclose(
            w.mean(0), np.array([2, 3, 4]) / 9.0, atol=0.01)


class TestVonMisesCircular:
    def test_logpdf_matches_scipy(self):
        from scipy import stats as sps
        from mcmcpp_tpu.dsl import VonMises

        x = np.linspace(-np.pi, np.pi, 25).astype(np.float32)
        for loc, kappa in [(0.0, 0.5), (1.2, 2.0), (-2.5, 8.0)]:
            np.testing.assert_allclose(
                VonMises(loc, kappa).logpdf(x),
                sps.vonmises.logpdf(x, kappa, loc=loc),
                rtol=5e-4, atol=5e-5)

    def test_sample_circular_moments(self):
        from scipy import special as ssp
        from mcmcpp_tpu.dsl import VonMises

        loc, kappa = 0.8, 2.5
        x = np.asarray(VonMises(loc, kappa).sample(
            jax.random.key(0), (50_000,)))
        assert x.min() >= -np.pi and x.max() <= np.pi
        c = np.exp(1j * x).mean()
        assert np.angle(c) == pytest.approx(loc, abs=0.02)
        r_true = ssp.i1(kappa) / ssp.i0(kappa)
        assert np.abs(c) == pytest.approx(r_true, abs=0.01)

    def test_circular_transform_marginal_exact(self):
        """NUTS on a VonMises prior alone: the unit-vector embedding's
        marginal over the angle must be EXACTLY the declared VonMises
        (validates the auxiliary radial log_det)."""
        from scipy import special as ssp
        from mcmcpp_tpu import NUTSSampler
        from mcmcpp_tpu.dsl import Model, VonMises

        loc, kappa = 2.9, 4.0  # mean near the ±π cut on purpose
        m = Model().param("phi", VonMises(loc, kappa))
        logp, dim, constrain = m.build()
        assert dim == 2  # unit-vector embedding
        s = NUTSSampler(logp, n_chains=32, n_params=dim, seed=0)
        s.init_ball(np.zeros(dim), scale=0.5)
        s.warmup(300)
        s.run(600)
        phi = constrain(s.get_samples(flat=True))["phi"]
        c = np.exp(1j * phi).mean()
        # no boundary pathology: resultant direction at loc, length I1/I0
        assert np.angle(c) == pytest.approx(loc, abs=0.05)
        assert np.abs(c) == pytest.approx(
            ssp.i1(kappa) / ssp.i0(kappa), abs=0.03)

    def test_circular_prior_sample_is_exact_for_evidence(self):
        """build_split's prior_sample must draw the auxiliary radius from
        its implied Rayleigh law (inverse_sample hook) so u-space draws
        follow the unconstrained prior density — checked by importance
        sampling the normalizer, and by SMC evidence on a circular model."""
        from mcmcpp_tpu.dsl import Model, Normal, VonMises
        from mcmcpp_tpu.smc import SMCSampler

        loc, kappa = 0.5, 2.0
        obs = np.array([0.7, 0.4, 0.9, 0.2], np.float32)
        m = (Model()
             .param("phi", VonMises(loc, kappa))
             .observe("y", lambda p: Normal(p["phi"], 0.5), obs))
        logprior, loglike, dim, constrain, prior_sample = m.build_split()
        u = prior_sample(jax.random.key(0), 40_000)
        assert u.shape == (40_000, 2)
        # radius^2 ~ chi2_2: mean 2
        r2 = np.sum(np.asarray(u) ** 2, axis=1)
        assert r2.mean() == pytest.approx(2.0, rel=0.03)
        # angle marginal is the declared VonMises
        phi = constrain(u)["phi"]
        c = np.exp(1j * phi).mean()
        assert np.angle(c) == pytest.approx(loc, abs=0.03)
        # quadrature truth for the evidence (treating Normal likelihood
        # of the angle as a function on (-pi, pi])
        from scipy import special as ssp

        g = np.linspace(-np.pi, np.pi, 200001)
        lp = (kappa * np.cos(g - loc) - np.log(2 * np.pi * ssp.i0(kappa))
              + np.sum(-0.5 * (obs[:, None] - g[None, :]) ** 2 / 0.25
                       - 0.5 * np.log(2 * np.pi * 0.25), axis=0))
        mx = lp.max()
        logz_true = mx + np.log(np.trapezoid(np.exp(lp - mx), g))
        smc = SMCSampler(logprior, loglike, prior_sample,
                         n_particles=4096, n_params=dim, n_mcmc=5, seed=0)
        smc.run()
        assert smc.log_evidence == pytest.approx(logz_true, abs=0.15)


def test_prior_predictive():
    """Prior predictive must match the analytic marginal of the data:
    y ~ N(0, tau^2 + 1) for theta ~ N(0, tau^2), y|theta ~ N(theta, 1)."""
    from mcmcpp_tpu.dsl import Model, Normal

    tau = 2.0
    m = (Model()
         .param("theta", Normal(0.0, tau))
         .observe("y", lambda p: Normal(p["theta"], 1.0),
                  np.zeros(6, np.float32)))
    sims, u = m.prior_predictive(jax.random.key(0), 20_000)
    y = sims["y"]
    assert y.shape == (20_000, 6)
    assert u.shape == (20_000, 1)
    assert y.mean() == pytest.approx(0.0, abs=0.05)
    assert y.std() == pytest.approx(np.sqrt(tau**2 + 1.0), rel=0.02)
    # within-draw correlation: shared theta induces cov = tau^2
    c = np.cov(y[:, 0], y[:, 1])[0, 1]
    assert c == pytest.approx(tau**2, rel=0.05)
    _, _, _, constrain, _ = m.build_split()
    th = constrain(u)["theta"]
    assert th.std() == pytest.approx(tau, rel=0.02)


def test_support_guards_round2_review():
    """Code-review regressions: support indicators on the new positive
    distributions; Mixture rejects same-type transforms with different
    bounds; VonMises.sample takes array parameters."""
    from mcmcpp_tpu.dsl import (
        InverseGamma, Mixture, Pareto, VonMises, Weibull,
    )

    assert float(Pareto(2.0, 3.0).logpdf(1.5)) == -np.inf
    assert np.isfinite(float(Pareto(2.0, 3.0).logpdf(2.5)))
    assert float(Weibull(1.5, 2.0).logpdf(-0.5)) == -np.inf
    assert float(InverseGamma(2.0, 1.0).logpdf(-1.0)) == -np.inf
    with pytest.raises(ValueError, match="share support"):
        Mixture([Pareto(1.0, 2.0), Pareto(2.0, 2.0)], weights=[0.5, 0.5])
    x = VonMises(
        loc=jnp.array([0.0, 1.0, -1.0]),
        concentration=jnp.array([1.0, 2.0, 4.0]),
    ).sample(jax.random.key(0), (2000, 3))
    assert x.shape == (2000, 3)
    c = np.exp(1j * np.asarray(x)).mean(0)
    np.testing.assert_allclose(np.angle(c), [0.0, 1.0, -1.0], atol=0.1)
    # higher concentration -> longer resultant
    assert np.abs(c[2]) > np.abs(c[1]) > np.abs(c[0])


class TestCensored:
    def test_exponential_censoring_conjugate_oracle(self):
        """Exponential survival with right censoring: the rate posterior
        is EXACTLY Gamma(a0 + n_events, b0 + total_exposure) — censored
        rows contribute exposure only."""
        from mcmcpp_tpu import NUTSSampler
        from mcmcpp_tpu.dsl import Censored, Exponential, Gamma, Model

        rng = np.random.default_rng(0)
        true_rate = 0.7
        t_event = rng.exponential(1.0 / true_rate, 60)
        c_time = rng.uniform(0.5, 3.0, 60)
        observed = np.minimum(t_event, c_time).astype(np.float32)
        censored = (t_event > c_time)
        a0, b0 = 2.0, 1.0
        m = (Model()
             .param("rate", Gamma(a0, b0))
             .observe("t", lambda p: Censored(
                 Exponential(p["rate"]), right=censored), observed))
        logp, dim, constrain = m.build()
        s = NUTSSampler(logp, n_chains=16, n_params=dim, seed=0)
        s.init_ball(np.zeros(dim), scale=0.3)
        s.warmup(300)
        s.run(600)
        rate = constrain(s.get_samples(flat=True))["rate"]
        a_post = a0 + float((~censored).sum())
        b_post = b0 + float(observed.sum())
        assert rate.mean() == pytest.approx(a_post / b_post, rel=0.03)
        assert rate.std() == pytest.approx(
            np.sqrt(a_post) / b_post, rel=0.1)

    def test_weibull_exact_log_sf_and_left_censoring(self):
        from scipy import stats as sps
        from mcmcpp_tpu.dsl import Censored, Normal, Weibull

        w = Weibull(1.7, 2.5)
        x = np.linspace(0.2, 9.0, 11).astype(np.float32)
        np.testing.assert_allclose(
            w.log_sf(x), sps.weibull_min.logsf(x, 1.7, scale=2.5),
            rtol=1e-5)
        # right-censored entry scores log S, uncensored scores logpdf
        mask = np.array([True, False])
        c = Censored(w, right=mask)
        vals = np.array([2.0, 2.0], np.float32)
        got = np.asarray(c.logpdf(vals))
        assert got[0] == pytest.approx(float(w.log_sf(2.0)), rel=1e-5)
        assert got[1] == pytest.approx(float(w.logpdf(2.0)), rel=1e-5)
        # left censoring via the generic cdf path (Normal base)
        n = Normal(1.0, 2.0)
        cl = Censored(n, left=np.array([True, False]))
        got = np.asarray(cl.logpdf(vals))
        assert got[0] == pytest.approx(
            float(jnp.log(n.cdf(2.0))), rel=1e-5)
        assert got[1] == pytest.approx(float(n.logpdf(2.0)), rel=1e-5)

    def test_validation(self):
        from mcmcpp_tpu.dsl import Censored, Exponential, Poisson

        with pytest.raises(ValueError, match="right= and/or left="):
            Censored(Exponential(1.0))
        with pytest.raises(ValueError, match="cannot right-censor"):
            Censored(Poisson(2.0), right=np.array([True]))


def test_logistic_skewnormal_halfstudentt():
    from scipy import stats as sps
    from mcmcpp_tpu.dsl import HalfStudentT, Logistic, SkewNormal

    x = np.linspace(-6, 6, 25).astype(np.float32)
    np.testing.assert_allclose(
        Logistic(0.5, 1.3).logpdf(x),
        sps.logistic.logpdf(x, 0.5, 1.3), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        Logistic(0.5, 1.3).cdf(x),
        sps.logistic.cdf(x, 0.5, 1.3), atol=1e-6)
    np.testing.assert_allclose(
        SkewNormal(0.2, 1.1, 3.0).logpdf(x),
        sps.skewnorm.logpdf(x, 3.0, 0.2, 1.1), rtol=1e-3, atol=2e-3)
    xp = np.linspace(0.1, 8, 17).astype(np.float32)
    np.testing.assert_allclose(
        HalfStudentT(4.0, 1.5).logpdf(xp),
        np.log(2) + sps.t.logpdf(xp, 4.0, 0.0, 1.5), rtol=1e-4)
    # sample moments
    key = jax.random.key(0)
    n = 60_000
    s = np.asarray(Logistic(0.5, 1.3).sample(key, (n,)))
    assert s.mean() == pytest.approx(0.5, abs=0.03)
    assert s.var() == pytest.approx(1.3**2 * np.pi**2 / 3, rel=0.03)
    s = np.asarray(SkewNormal(0.0, 1.0, 3.0).sample(key, (n,)))
    delta = 3.0 / np.sqrt(10.0)
    assert s.mean() == pytest.approx(delta * np.sqrt(2 / np.pi), abs=0.01)
    assert sps.skew(s) == pytest.approx(
        sps.skewnorm.stats(3.0, moments="s"), abs=0.05)
    s = np.asarray(HalfStudentT(4.0, 1.5).sample(key, (n,)))
    assert s.min() > 0
    # E|T| for t_4: scale * 2*sqrt(df)/((df-1)*Beta(df/2,1/2))
    from scipy.special import beta as beta_fn
    want = 1.5 * 2 * np.sqrt(4) / (3 * beta_fn(2.0, 0.5))
    assert s.mean() == pytest.approx(want, rel=0.02)


def test_circular_mixture_composes():
    """Mixture of VonMises components (same Circular support) composes:
    correct density vs manual logaddexp, NUTS samples both modes through
    the unit-vector embedding."""
    from scipy import stats as sps
    from mcmcpp_tpu import NUTSSampler
    from mcmcpp_tpu.dsl import Mixture, Model, VonMises

    m = Mixture([VonMises(-1.5, 6.0), VonMises(1.5, 6.0)],
                weights=[0.4, 0.6])
    x = np.linspace(-np.pi, np.pi, 21).astype(np.float32)
    want = np.logaddexp(
        np.log(0.4) + sps.vonmises.logpdf(x, 6.0, loc=-1.5),
        np.log(0.6) + sps.vonmises.logpdf(x, 6.0, loc=1.5),
    )
    np.testing.assert_allclose(m.logpdf(x), want, rtol=1e-3, atol=1e-4)

    model = Model().param("phi", m)
    logp, dim, constrain = model.build()
    s = NUTSSampler(logp, n_chains=32, n_params=dim, seed=0)
    s.init_ball(np.zeros(dim), scale=1.0)
    s.warmup(300)
    s.run(600)
    phi = constrain(s.get_samples(flat=True))["phi"]
    frac_pos = float((phi > 0).mean())
    assert 0.45 < frac_pos < 0.75, f"mode weights off: {frac_pos:.3f}"


def test_censored_exact_tails():
    """Review regression: Normal/Logistic censoring uses exact
    log_sf/log_cdf — no float32 cdf saturation in the tail."""
    from scipy import stats as sps
    from mcmcpp_tpu.dsl import Censored, Logistic, Normal

    c = Censored(Normal(0.0, 1.0), right=np.array([True]))
    got = float(c.logpdf(np.array([6.0], np.float32))[0])
    assert got == pytest.approx(sps.norm.logsf(6.0), rel=1e-3)  # ~-20.74
    cl = Censored(Normal(0.0, 1.0), left=np.array([True]))
    got = float(cl.logpdf(np.array([-6.0], np.float32))[0])
    assert got == pytest.approx(sps.norm.logcdf(-6.0), rel=1e-3)
    c2 = Censored(Logistic(0.0, 1.0), right=np.array([True]))
    got = float(c2.logpdf(np.array([20.0], np.float32))[0])
    assert got == pytest.approx(sps.logistic.logsf(20.0), rel=1e-4)


class TestGEM:
    def test_logpdf_matches_stick_change_of_variables(self):
        # K=3: p(w) = Beta(v1;1,a) Beta(v2;1,a) / (1-w1), v1=w1,
        # v2 = w2/(1-w1) — the direct change of variables
        from scipy.stats import beta as sp_beta

        from mcmcpp_tpu.dsl import GEM

        a = 1.7
        d = GEM(a, 3)
        rng = np.random.default_rng(0)
        for _ in range(20):
            raw = rng.dirichlet(np.ones(3))
            w = jnp.asarray(raw)
            v1 = raw[0]
            v2 = raw[1] / (1 - raw[0])
            want = (np.log(sp_beta.pdf(v1, 1, a))
                    + np.log(sp_beta.pdf(v2, 1, a))
                    - np.log1p(-raw[0]))
            assert float(d.logpdf(w)) == pytest.approx(want, rel=1e-5)

    def test_logpdf_normalizes_on_simplex(self):
        # grid integration over the K=3 simplex in (w1, w2)
        from mcmcpp_tpu.dsl import GEM

        d = GEM(2.5, 3)
        n = 400
        h = 1.0 / n
        w1, w2 = np.meshgrid(
            (np.arange(n) + 0.5) * h, (np.arange(n) + 0.5) * h,
            indexing="ij",
        )
        mask = w1 + w2 < 1.0
        w = np.stack([w1, w2, 1.0 - w1 - w2], axis=-1)[mask]
        total = np.exp(np.asarray(
            d.logpdf(jnp.asarray(w, jnp.float32))
        )).sum() * h * h
        assert total == pytest.approx(1.0, abs=2e-3)

    def test_sample_moments(self):
        # alpha=1 -> E[w_i] = 2^-i, E[w_K] = 2^-(K-1)
        from mcmcpp_tpu.dsl import GEM

        d = GEM(1.0, 5)
        w = np.asarray(d.sample(jax.random.key(0), (200_000, 5)))
        np.testing.assert_allclose(w.sum(axis=-1), 1.0, atol=1e-5)
        want = [0.5, 0.25, 0.125, 0.0625, 0.0625]
        np.testing.assert_allclose(w.mean(axis=0), want, atol=0.003)

    def test_gem_prior_in_model_roundtrip(self):
        from mcmcpp_tpu.dsl import GEM

        model = (
            Model()
            .param("alpha", Gamma(2.0, 2.0))
            .param("w", GEM(1.5, 4), shape=(4,))
            .likelihood(lambda v: 0.0 * v["w"][0])
        )
        logp, dim, constrain = model.build()
        assert dim == 1 + 3
        draws = model.prior_sample(jax.random.key(2), 256)
        w = constrain(draws)["w"]
        assert w.shape == (256, 4)
        np.testing.assert_allclose(np.asarray(w).sum(axis=-1), 1.0,
                                   atol=1e-5)
        assert np.all(np.isfinite(np.asarray(
            jax.vmap(logp)(draws)
        )))

    def test_gem_validates(self):
        from mcmcpp_tpu.dsl import GEM

        with pytest.raises(ValueError):
            GEM(1.0, 1)
        with pytest.raises(ValueError):
            GEM(1.0, 3).sample(jax.random.key(0), (10, 4))
