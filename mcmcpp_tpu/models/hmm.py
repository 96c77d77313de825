"""Hidden Markov models with finite state spaces: forward filtering,
forward-backward smoothing, exact posterior path sampling (discrete FFBS),
Viterbi decoding, and a blocked-Gibbs kernel for state sequences.

No reference counterpart (jmatta1/MCMCpp's model surface is the scalar
``calcLogPostProb``, ``MCMCpp/EnsembleSampler.h:80-96``); north-star
scope, completing the time-series layer: exact linear-Gaussian latents in
:mod:`mcmcpp_tpu.models.lgss`, particle methods for the nonlinear
continuous case in :mod:`mcmcpp_tpu.particle`, and exact DISCRETE latents
here.

Contract: the user supplies the per-step emission table
``log_obs[t, k] = log p(y_t | z_t = k)`` — emissions stay model-agnostic
and fully vectorized (compute them with one batched op over your data).
``log_pi`` is the (K,) initial log-distribution, ``log_gamma`` the (K, K)
row-stochastic transition log-matrix (rows: from-state).

Accelerator-native design
-----------------
Everything runs in log space. The forward recursion is a max-K² matvec
per step under ``lax.scan``; ``method="parallel"`` instead reformulates
the whole pass as an ``associative_scan`` over (K, K) log-matmul-exp
elements — O(log T) depth of batched (K, K) contractions, the discrete
analogue of the associative Kalman elements in models/lgss.py. The
parallel path costs K³ work per combine vs K² sequential, the right
trade for long T and the small-to-moderate K of applied HMMs.
"""

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.special import logsumexp


class HMMForward(NamedTuple):
    log_alpha: jnp.ndarray  # (T, K) NORMALIZED filtered log p(z_t | y_1:t)
    loglik: jnp.ndarray     # scalar log p(y_{1:T})


def _validate(log_pi, log_gamma, log_obs):
    log_pi = jnp.asarray(log_pi)
    log_gamma = jnp.asarray(log_gamma)
    log_obs = jnp.asarray(log_obs)
    k = log_pi.shape[0]
    if log_gamma.shape != (k, k):
        raise ValueError(
            f"log_gamma must be ({k}, {k}), got {log_gamma.shape}"
        )
    if log_obs.ndim != 2 or log_obs.shape[1] != k:
        raise ValueError(
            f"log_obs must be (T, {k}), got {log_obs.shape}"
        )
    return log_pi, log_gamma, log_obs


def _seq_forward(log_pi, log_gamma, log_obs):
    a0 = log_pi + log_obs[0]
    c0 = logsumexp(a0)
    a0 = a0 - c0

    def step(a, lo):
        nxt = logsumexp(a[:, None] + log_gamma, axis=0) + lo
        c = logsumexp(nxt)
        return nxt - c, (nxt - c, c)

    _, (alphas, cs) = jax.lax.scan(step, a0, log_obs[1:])
    return HMMForward(
        jnp.concatenate([a0[None], alphas], axis=0), c0 + jnp.sum(cs)
    )


def _logmatmulexp(a, b):
    """(..., K, K) log-space matrix product (the associative combine)."""
    return logsumexp(a[..., :, :, None] + b[..., None, :, :], axis=-2)


def _par_forward(log_pi, log_gamma, log_obs):
    # element t is the (K, K) map M_t(i, j) = Gamma(i, j) + obs_t(j);
    # the prefix product applied to the initial row gives alpha_t.
    # Fold the initial distribution into element 0 as a rank-1 map so a
    # single associative_scan yields every prefix.
    t_n, k = log_obs.shape
    elems = log_gamma[None, :, :] + log_obs[1:, None, :]   # (T-1, K, K)
    first = jnp.broadcast_to(
        (log_pi + log_obs[0])[None, :], (k, k)
    )[None]                                                 # (1, K, K)
    pref = jax.lax.associative_scan(
        _logmatmulexp, jnp.concatenate([first, elems], axis=0)
    )                                                       # (T, K, K)
    log_alpha_un = pref[:, 0, :]  # row 0 = the folded initial row
    norm = logsumexp(log_alpha_un, axis=1, keepdims=True)
    return HMMForward(log_alpha_un - norm, norm[-1, 0])


def hmm_forward(log_pi, log_gamma, log_obs, method="sequential"):
    """Filtered state posteriors and log p(y_{1:T}).

    ``method="parallel"`` is the O(log T)-depth associative-scan path;
    the two agree to float tolerance (tested)."""
    log_pi, log_gamma, log_obs = _validate(log_pi, log_gamma, log_obs)
    if method == "parallel":
        return _par_forward(log_pi, log_gamma, log_obs)
    if method == "sequential":
        return _seq_forward(log_pi, log_gamma, log_obs)
    raise ValueError(f"method must be 'parallel'|'sequential', got {method!r}")


def hmm_loglik(log_pi, log_gamma, log_obs, method="sequential"):
    """Marginal log-likelihood with the states summed out — the collapsed
    differentiable target for sampling HMM hyperparameters with any
    gradient engine (gradients flow through both scans)."""
    return hmm_forward(log_pi, log_gamma, log_obs, method=method).loglik


def hmm_smoother(log_pi, log_gamma, log_obs, method="sequential"):
    """Forward-backward: ``(log_marginals (T, K), loglik)`` where
    ``log_marginals[t, k] = log p(z_t = k | y_{1:T})``."""
    log_pi, log_gamma, log_obs = _validate(log_pi, log_gamma, log_obs)
    fwd = hmm_forward(log_pi, log_gamma, log_obs, method=method)

    def step(b, lo):
        nxt = logsumexp(log_gamma + (lo + b)[None, :], axis=1)
        return nxt - logsumexp(nxt), nxt - logsumexp(nxt)

    k = log_pi.shape[0]
    b_last = jnp.zeros((k,), log_obs.dtype)
    _, betas = jax.lax.scan(step, b_last, log_obs[1:], reverse=True)
    log_beta = jnp.concatenate([betas, b_last[None]], axis=0)
    post = fwd.log_alpha + log_beta
    post = post - logsumexp(post, axis=1, keepdims=True)
    return post, fwd.loglik


def hmm_sample_posterior(key, log_pi, log_gamma, log_obs, n_paths=None,
                         method="sequential"):
    """EXACT joint draw(s) z_{1:T} ~ p(z | y): forward filter, backward
    sampling (the discrete FFBS). Returns (T,) int32, or (n_paths, T)
    when ``n_paths`` is given (one forward pass shared by all draws)."""
    log_pi, log_gamma, log_obs = _validate(log_pi, log_gamma, log_obs)
    fwd = hmm_forward(log_pi, log_gamma, log_obs, method=method)
    squeeze = n_paths is None
    n = 1 if squeeze else int(n_paths)
    k_last, k_scan = jax.random.split(key)
    z_last = jax.random.categorical(
        k_last, fwd.log_alpha[-1], shape=(n,)
    )

    def step(z, inp):
        a, kk = inp
        # p(z_t | z_{t+1}, y_1:t) ∝ alpha_t(i) Gamma(i, z_{t+1})
        logits = a[None, :] + log_gamma.T[z]  # (n, K)
        z_prev = jax.random.categorical(kk, logits, axis=-1)
        return z_prev, z_prev

    keys = jax.random.split(k_scan, fwd.log_alpha.shape[0] - 1)
    _, zs = jax.lax.scan(
        step, z_last, (fwd.log_alpha[:-1], keys), reverse=True
    )
    path = jnp.concatenate([zs, z_last[None]], axis=0).T.astype(jnp.int32)
    return path[0] if squeeze else path


def viterbi(log_pi, log_gamma, log_obs):
    """MAP state path: ``(path (T,) int32, log p(path, y))``."""
    log_pi, log_gamma, log_obs = _validate(log_pi, log_gamma, log_obs)
    d0 = log_pi + log_obs[0]

    def fwd(d, lo):
        scores = d[:, None] + log_gamma          # (K from, K to)
        best = jnp.max(scores, axis=0) + lo
        return best, (best, jnp.argmax(scores, axis=0))

    d_last, (_, ptrs) = jax.lax.scan(fwd, d0, log_obs[1:])
    z_last = jnp.argmax(d_last)

    def back(z, p):
        zp = p[z]
        return zp, zp

    _, zs = jax.lax.scan(back, z_last, ptrs, reverse=True)
    path = jnp.concatenate([zs, z_last[None]]).astype(jnp.int32)
    return path, jnp.max(d_last)


def transition_counts(path, n_states):
    """(K, K) transition count matrix of an int path — the sufficient
    statistic for conjugate Dirichlet transition-row updates."""
    path = jnp.asarray(path)
    idx = path[:-1] * n_states + path[1:]
    flat = jnp.zeros((n_states * n_states,), jnp.int32).at[idx].add(1)
    return flat.reshape(n_states, n_states)


class HMMKernel:
    """Blocked-Gibbs kernel drawing a state sequence EXACTLY from its
    full conditional via discrete FFBS. States are stored as a float
    block (the sampler's storage dtype); read them back with
    ``.astype(int)``.

        BlockedGibbsSampler([
            ("z", T, HMMKernel(log_obs_fn, log_pi, log_gamma_fn)),
            ("mu", K, <any kernel>),    # emissions see z via `others`
        ], ...)

    log_obs_fn: (T, K) array, or callable ``others -> (T, K)`` tracking
        live emission-parameter blocks.
    log_gamma_fn: (K, K) array or callable ``others -> (K, K)`` (e.g. a
        Dirichlet-conjugate transition block, see
        :func:`transition_counts`).
    """

    def __init__(self, log_obs_fn, log_pi, log_gamma_fn,
                 method="sequential"):
        self._obs = log_obs_fn
        self.log_pi = jnp.asarray(log_pi)
        self._gamma = log_gamma_fn
        self.method = method

    def step(self, key, x, others):
        lo = self._obs(others) if callable(self._obs) else self._obs
        lg = self._gamma(others) if callable(self._gamma) else self._gamma
        path = hmm_sample_posterior(
            key, self.log_pi, lg, lo, method=self.method
        )
        return path.astype(x.dtype)


def hmm_forecast(log_pi, log_gamma, log_obs, horizon=1,
                 method="sequential"):
    """k-step-ahead predictive STATE distributions from the filtered
    endpoint: ``(h, K)`` log p(z_{T+k} | y_{1:T}) for k = 1..h. Combine
    with your emission law for observation forecasts (e.g. mixture
    moments under ``gaussian_emission_logpdf``'s means)."""
    log_pi, log_gamma, log_obs = _validate(log_pi, log_gamma, log_obs)
    fwd = hmm_forward(log_pi, log_gamma, log_obs, method=method)

    def step(a, _):
        nxt = logsumexp(a[:, None] + log_gamma, axis=0)
        nxt = nxt - logsumexp(nxt)
        return nxt, nxt

    _, preds = jax.lax.scan(
        step, fwd.log_alpha[-1], None, length=int(horizon)
    )
    return preds


def gaussian_emission_logpdf(ys, means, sigmas):
    """Convenience (T, K) table for scalar-Gaussian emissions: ``ys``
    (T,), ``means``/``sigmas`` (K,)."""
    ys = jnp.asarray(ys)[:, None]
    means = jnp.asarray(means)[None, :]
    sigmas = jnp.asarray(sigmas)[None, :]
    z = (ys - means) / sigmas
    return -0.5 * z * z - jnp.log(sigmas) - 0.5 * np.log(2.0 * np.pi)
