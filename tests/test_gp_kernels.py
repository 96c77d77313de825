"""GP kernel library: scipy/sklearn-free oracles (closed forms, PSD,
marginal-likelihood parity with direct multivariate-normal algebra)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mcmcpp_tpu.models.gp import (
    RBF, Linear, Matern12, Matern32, Matern52, Periodic, WhiteNoise,
    gp_log_marginal, gp_predict, gram_cholesky,
)

XS = jnp.linspace(0.0, 3.0, 16)


@pytest.mark.parametrize("kernel", [
    RBF(0.7, 1.3), Matern12(0.7, 1.3), Matern32(0.7, 1.3),
    Matern52(0.7, 1.3), Periodic(1.5, 0.8, 1.3), Linear(0.5),
    RBF(0.7) + WhiteNoise(0.1), RBF(0.7) * Matern32(1.2),
], ids=["rbf", "m12", "m32", "m52", "per", "lin", "sum", "prod"])
def test_psd_and_symmetry(kernel):
    k = np.asarray(kernel(XS, XS))
    np.testing.assert_allclose(k, k.T, atol=1e-6)
    evals = np.linalg.eigvalsh(k + 1e-6 * np.eye(k.shape[0]))
    assert evals.min() > 0
    # cholesky path works and round-trips against the GRAM (where white
    # noise lives; __call__ is the noise-free cross covariance)
    chol = np.asarray(gram_cholesky(kernel, XS))
    g = np.asarray(kernel.gram(XS))
    np.testing.assert_allclose(chol @ chol.T, g + 1e-6 * np.eye(16),
                               atol=1e-5)


def test_closed_forms():
    r = 0.9
    x = jnp.array([0.0, r])
    assert float(RBF(0.7, 1.3)(x, x)[0, 1]) == pytest.approx(
        1.3 * np.exp(-0.5 * r**2 / 0.49), rel=1e-5)
    assert float(Matern32(0.7, 1.0)(x, x)[0, 1]) == pytest.approx(
        (1 + np.sqrt(3) * r / 0.7) * np.exp(-np.sqrt(3) * r / 0.7),
        rel=1e-4)
    w = WhiteNoise(0.5).gram(x)
    np.testing.assert_allclose(w, 0.5 * np.eye(2), atol=1e-6)
    assert float(np.abs(np.asarray(WhiteNoise(0.5)(x, x))).max()) == 0.0


def test_log_marginal_matches_mvn_algebra():
    rng = np.random.default_rng(0)
    y = jnp.asarray(rng.standard_normal(16).astype(np.float32))
    k = RBF(0.8, 1.5)
    noise = 0.3
    got = float(gp_log_marginal(k, XS, y, noise))
    cov = np.asarray(k(XS, XS), np.float64) + (noise**2 + 1e-6) * np.eye(16)
    sign, logdet = np.linalg.slogdet(cov)
    want = (-0.5 * np.asarray(y, np.float64) @ np.linalg.solve(
        cov, np.asarray(y, np.float64))
        - 0.5 * logdet - 8 * np.log(2 * np.pi))
    assert got == pytest.approx(want, rel=1e-4)


def test_predict_interpolates_and_reverts_to_prior():
    k = RBF(0.5, 1.0)
    y = jnp.sin(XS)
    mean, var = gp_predict(k, XS, y, XS, noise=1e-3)
    np.testing.assert_allclose(mean, y, atol=0.01)  # interpolates
    assert float(var.max()) < 0.01
    far = jnp.array([30.0])
    mean_f, var_f = gp_predict(k, XS, y, far, noise=1e-3)
    assert float(mean_f[0]) == pytest.approx(0.0, abs=0.01)  # prior mean
    assert float(var_f[0]) == pytest.approx(1.0, abs=0.01)  # prior var


def test_hyperparameter_gradients_flow():
    y = jnp.sin(XS)

    def obj(log_l):
        return gp_log_marginal(RBF(jnp.exp(log_l)), XS, y, noise=0.1)

    g = jax.grad(obj)(jnp.asarray(0.0))
    assert np.isfinite(float(g)) and float(g) != 0.0


def test_multidim_inputs():
    rng = np.random.default_rng(1)
    x2 = jnp.asarray(rng.standard_normal((10, 3)).astype(np.float32))
    k = np.asarray(Matern52(1.2, 0.9)(x2, x2))
    assert k.shape == (10, 10)
    np.testing.assert_allclose(np.diag(k), 0.9, atol=1e-5)


def test_white_noise_is_gram_only():
    """Review regression: white noise lives on the GRAM diagonal only —
    zero cross-covariance (predictions must NOT interpolate the noise)
    and zero between distinct observations sharing a coordinate."""
    k = RBF(0.5, 1.0) + WhiteNoise(0.09)
    rng = np.random.default_rng(0)
    y = jnp.asarray(np.sin(np.asarray(XS))
                    + 0.3 * rng.standard_normal(16))
    mean, var = gp_predict(k, XS, y, XS, noise=0.0)
    resid = float(np.sqrt(np.mean((np.asarray(mean) - np.asarray(y)) ** 2)))
    assert resid > 0.05, "prediction interpolated the white noise"
    # duplicate coordinates: gram has the noise only on the diagonal
    xdup = jnp.array([0.0, 0.0, 1.0])
    g = np.asarray(WhiteNoise(0.5).gram(xdup))
    np.testing.assert_allclose(g, 0.5 * np.eye(3), atol=1e-7)
    assert float(np.abs(np.asarray(WhiteNoise(0.5)(xdup, xdup))).max()) == 0
    # diag avoids the (M, M) temporary and matches the gram diagonal
    np.testing.assert_allclose(
        np.asarray(k.diag(XS)), np.diagonal(np.asarray(k.gram(XS))),
        atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(Linear(0.5).diag(XS)),
        np.diagonal(np.asarray(Linear(0.5)(XS, XS))), atol=1e-6)


def test_gram_cholesky_escalates_jitter_on_nan():
    """Robustness guard: an accelerator's blocked f32 Cholesky can NaN
    on ill-conditioned grams CPU LAPACK survives; gram_cholesky
    must escalate jitter until the factorization is finite, stay
    jittable, and stay reverse-differentiable (the Gibbs interweave
    kernel differentiates through it)."""
    import jax
    import jax.numpy as jnp

    from mcmcpp_tpu.models.gp import RBF, gram_cholesky

    xs = np.linspace(0.0, 1.0, 48)[:, None].astype(np.float32)

    # gram so ill-conditioned even CPU f32 NaNs at the base jitter:
    # duplicated inputs make it exactly singular (escalation reaches
    # 1e-8 * 10^5 = 1e-3, which factorizes)
    xs_dup = np.repeat(xs[:24], 2, axis=0)
    kern = RBF(lengthscale=0.8, variance=1.5)
    chol = gram_cholesky(kern, xs_dup, jitter=1e-8)
    assert np.isfinite(np.asarray(chol)).all()
    # jittable with traced hyperparameters
    f = jax.jit(lambda ll: gram_cholesky(
        RBF(lengthscale=jnp.exp(ll), variance=1.0), xs_dup, jitter=1e-8
    ))
    assert np.isfinite(np.asarray(f(-0.2))).all()
    # reverse-differentiable (sum of the factor as a scalar probe)
    g = jax.grad(lambda ll: jnp.sum(gram_cholesky(
        RBF(lengthscale=jnp.exp(ll), variance=1.0), xs, jitter=1e-6
    )))(-0.2)
    assert np.isfinite(float(g))
