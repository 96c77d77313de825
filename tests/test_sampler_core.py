"""End-to-end sampler tests against analytic posterior moments.

Mirrors the reference's statistical test strategy (SURVEY.md §4): sample the
2-D skewed Gaussian from test/sequential/SkewedGaussian and check acceptance
fraction and posterior covariance against the analytic values.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mcmcpp_tpu import EnsembleSampler, StretchMove
from tests.targets import skewed_gaussian_logp, skewed_gaussian_cov


def run_skewed(mover, n_walkers=100, n_steps=3000, burn=500, seed=3, **kw):
    s = EnsembleSampler(
        skewed_gaussian_logp, n_walkers, 2, mover=mover, seed=seed, **kw
    )
    s.init_ball(np.zeros(2), scale=0.5)
    s.run_mcmc(burn, store=False)
    assert s.run_mcmc(n_steps)
    return s


class TestStretchSkewedGaussian:
    def test_moments(self):
        s = run_skewed(StretchMove(), n_steps=4000)
        flat = s.get_samples(flat=True)
        cov = np.cov(flat.T)
        true = skewed_gaussian_cov()
        assert np.allclose(cov, true, atol=0.12), f"cov={cov}\ntrue={true}"
        assert np.allclose(flat.mean(axis=0), 0.0, atol=0.15)

    def test_acceptance_fraction_reasonable(self):
        s = run_skewed(StretchMove(), n_steps=1000)
        # stretch move on a 2-D Gaussian accepts well over half the time
        assert 0.3 < s.acceptance_fraction < 0.95
        assert s.total_steps == 1500 * 100

    def test_logp_stored_matches_positions(self):
        s = run_skewed(StretchMove(), n_steps=50)
        pos = s.get_samples()
        lp = s.get_log_probs()
        expect = jax.vmap(jax.vmap(skewed_gaussian_logp))(jnp.asarray(pos))
        assert np.allclose(np.asarray(expect), lp, rtol=1e-4, atol=1e-4)

    def test_determinism(self):
        a = run_skewed(StretchMove(), n_steps=100, seed=7)
        b = run_skewed(StretchMove(), n_steps=100, seed=7)
        assert np.array_equal(a.get_samples(), b.get_samples())

    def test_seed_changes_chain(self):
        a = run_skewed(StretchMove(), n_steps=50, seed=1)
        b = run_skewed(StretchMove(), n_steps=50, seed=2)
        assert not np.array_equal(a.get_samples(), b.get_samples())


class TestSamplerMechanics:
    def test_thinning(self):
        s = run_skewed(StretchMove(), n_steps=100)
        s2 = EnsembleSampler(skewed_gaussian_logp, 100, 2, seed=3)
        s2.init_ball(np.zeros(2), scale=0.5)
        s2.run_mcmc(500, store=False)
        s2.run_mcmc(100, thin=10)
        assert s2.stored_steps == 10

    def test_chain_capacity_endofchain(self):
        row = 100 * 3 * 4  # W*(P+1)*itemsize
        s = EnsembleSampler(
            skewed_gaussian_logp, 100, 2, seed=0, max_chain_bytes=row * 7
        )
        s.init_ball(np.zeros(2), scale=0.5)
        ok = s.run_mcmc(20)
        assert not ok  # ≙ IncrementStatus::EndOfChain
        assert s.stored_steps == 7

    def test_slice_and_burn(self):
        s = run_skewed(StretchMove(), n_steps=100)
        n0 = s.stored_steps
        s.slice_and_burn_chain(thin=5, burn_in=20)
        assert s.stored_steps == len(range(20, n0, 5))

    def test_reset_keeps_position(self):
        s = run_skewed(StretchMove(), n_steps=20)
        pos_before = np.asarray(s.current_positions)
        s.reset()
        assert s.stored_steps == 0
        assert s.total_steps == 0
        assert np.array_equal(np.asarray(s.current_positions), pos_before)
        assert s.run_mcmc(5)
        assert s.stored_steps == 5

    def test_store_current_positions(self):
        s = run_skewed(StretchMove(), n_steps=5)
        n0 = s.stored_steps
        s.store_current_walker_positions()
        assert s.stored_steps == n0 + 1
        assert np.array_equal(
            s.get_samples()[-1], np.asarray(s.current_positions)
        )

    def test_bad_logp_rejected(self):
        with pytest.raises(TypeError):
            EnsembleSampler(lambda th: th, 10, 2)  # returns vector, not scalar

    def test_odd_walkers_rejected(self):
        with pytest.raises(ValueError):
            EnsembleSampler(skewed_gaussian_logp, 7, 2)


def test_public_utility_exports():
    """The small public utilities stay importable and behave: sample_ball
    (emcee-style init), EnsembleState (the public state type),
    ConvergenceReport (run_until_converged's return type), and to_arviz's
    actionable error when arviz is absent."""
    import jax
    from mcmcpp_tpu import (
        ConvergenceReport,
        EnsembleSampler,
        EnsembleState,
        sample_ball,
        to_arviz,
    )

    ball = np.asarray(sample_ball(
        jax.random.key(0), np.array([1.0, -2.0]), 0.1, 64))
    assert ball.shape == (64, 2)
    np.testing.assert_allclose(ball.mean(0), [1.0, -2.0], atol=0.06)
    np.testing.assert_allclose(ball.std(0), 0.1, atol=0.03)

    s = EnsembleSampler(skewed_gaussian_logp, n_walkers=16, n_params=2,
                        seed=0)
    s.init_ball(np.zeros(2), scale=0.3)
    assert isinstance(s.state, EnsembleState)

    rep = ConvergenceReport(True, 10, 5, np.ones(2), np.ones(2), 1, "ok")
    assert rep.converged and rep.reason == "ok"

    try:
        import arviz  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="to_inference_dict"):
            to_arviz(s)


def test_rbg_prng_impl():
    s = EnsembleSampler(
        skewed_gaussian_logp, n_walkers=64, n_params=2, seed=0,
        prng_impl="rbg",
    )
    s.init_ball(np.zeros(2), scale=0.5, seed=1)
    s.run_mcmc(500)
    assert 0.3 < s.acceptance_fraction < 0.95
    # deterministic for a fixed impl+seed
    s2 = EnsembleSampler(
        skewed_gaussian_logp, n_walkers=64, n_params=2, seed=0,
        prng_impl="rbg",
    )
    s2.init_ball(np.zeros(2), scale=0.5, seed=1)
    s2.run_mcmc(500)
    np.testing.assert_array_equal(s.get_samples(), s2.get_samples())
