"""Integrated autocorrelation time (ACT) via FFT autocovariance.

accelerator-native rebuild of ``MCMCpp/Analysis/AutoCorrCalc.h`` +
``MCMCpp/Analysis/Detail/AutoCov.h``: the hand-rolled iterative radix-2
Cooley–Tukey FFT (AutoCov.h:167-248) becomes ``jnp.fft`` (XLA-fused,
batched over walkers); the per-walker loop + Kahan-compensated
averaging (AutoCorrCalc.h:210-221) becomes a batched mean; the windowed
Sokal sum τ = −1 + 2·Σρ with adaptive window ``t > c·τ̂(t)``
(AutoCorrCalc.h:185-206, c = window_scaling, default 4) is a cumulative-sum
scan. Like the reference, an estimate whose window never closes is returned
**negative** to flag non-convergence (AutoCorrCalc.h:204-206).

(The reference's cross-walker accumulation bug — AutoCorrCalc.h:234-240
never zeroes its scratch between walkers — and its normal-instead-of-uniform
subset draw (:290-303) are intentionally not replicated.)
"""

import numpy as np
import jax
import jax.numpy as jnp


def _next_pow2(n):
    return 1 << (int(n) - 1).bit_length()


@jax.jit
def _norm_autocov_fft(series):
    """Normalized autocovariance per walker via FFT.

    series: (walkers, n) float. Returns (walkers, n) with ρ(0) = 1.
    Zero-pads to 2·next_pow2(n) (linear, not circular, autocovariance —
    ≙ AutoCov.h:286-290).
    """
    w, n = series.shape
    centered = series - jnp.mean(series, axis=1, keepdims=True)
    npad = 2 * _next_pow2(n)
    f = jnp.fft.rfft(centered, n=npad, axis=1)
    acov = jnp.fft.irfft(f * jnp.conj(f), n=npad, axis=1)[:, :n]
    return acov / acov[:, :1]


def normalized_autocov(series):
    """Normalized autocovariance ρ(t). ``series``: (n,) or (walkers, n)."""
    arr = jnp.atleast_2d(jnp.asarray(series, jnp.float32))
    out = np.asarray(_norm_autocov_fft(arr))
    return out[0] if np.ndim(series) == 1 else out


def _sokal_window_tau(rho, window_scaling):
    """Windowed Sokal estimate from the walker-averaged ρ(t).

    τ(M) = −1 + 2·Σ_{t=0..M} ρ(t); pick the smallest M with M ≥ c·τ(M).
    Returns −τ(last) if the window never closes (non-convergence flag).

    A CLOSED window's estimate is floored at a small positive value: for
    antithetic chains (e.g. fixed-length HMC, ρ(1) < −1/2) the finite-
    sample τ̂ can dip below zero even though τ ≥ 0 holds for any
    reversible chain — without the floor such super-efficient chains
    would be indistinguishable from the never-closed flag.
    """
    taus = 2.0 * np.cumsum(rho) - 1.0
    m = np.arange(len(rho))
    closed = m >= window_scaling * taus
    closed[0] = False  # need at least one lag
    if not np.any(closed):
        return -float(taus[-1])
    return float(max(taus[np.argmax(closed)], 1e-3))


def _geyer_tau(rho):
    """Geyer (1992) initial monotone sequence estimator from the
    walker-averaged ρ(t): pair sums Γ_m = ρ(2m) + ρ(2m+1) are positive
    and non-increasing for any reversible chain, so truncate at the
    first nonpositive pair and enforce the monotone envelope —
    the truncation rule Stan uses, with no tuning constant and no
    never-closed failure mode (it always returns a finite positive τ;
    prefer the Sokal window when you WANT short chains flagged).
    """
    n = (len(rho) // 2) * 2
    gam = rho[0:n:2] + rho[1:n:2]
    pos = gam > 0
    m_stop = int(np.argmin(pos)) if not pos.all() else len(gam)
    g = np.minimum.accumulate(gam[:max(m_stop, 1)])
    return float(max(2.0 * g.sum() - 1.0, 1e-3))


def autocorr_time(
    samples,
    window_scaling=4.0,
    walkers_to_use=None,
    key=None,
    walker_chunk=None,
    method="sokal",
):
    """Integrated ACT per parameter.

    samples: (S, W) or (S, W, P) chain array (steps, walkers[, params]).
    walkers_to_use: optionally estimate from a uniform random subset of
    walkers (≙ AutoCorrCalc.h:276-305; needs ``key``).
    walker_chunk: process walkers in chunks of this size to bound the FFT
    working set for very long chains.
    method: "sokal" (reference-faithful adaptive window, c =
    ``window_scaling``, NEGATIVE when the window never closes) or
    "geyer" (initial-monotone-sequence truncation — Stan's rule,
    tuning-free, always positive; see :func:`_geyer_tau`).

    Returns a float (for (S, W)) or (P,) array; negative values flag a
    window that never closed (chain too short relative to τ).
    """
    arr = np.asarray(samples)
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[:, :, None]
    if arr.ndim != 3:
        raise ValueError("samples must be (S, W) or (S, W, P)")
    if method not in ("sokal", "geyer"):
        raise ValueError(f"unknown method {method!r}")
    estimate = (
        (lambda r: _sokal_window_tau(r, window_scaling))
        if method == "sokal" else _geyer_tau
    )
    s, w, p = arr.shape
    if walkers_to_use is not None and walkers_to_use < w:
        if key is None:
            key = jax.random.key(0)
        idx = np.asarray(
            jax.random.choice(key, w, (int(walkers_to_use),), replace=False)
        )
        arr = arr[:, idx, :]
        w = arr.shape[1]
    taus = np.empty((p,))
    if walker_chunk:
        # memory-bounded path: per-(param, walker-chunk) slices only —
        # callers pass walker_chunk precisely because the chain is near
        # host RAM, so never build a second full-size transposed copy
        chunk = int(walker_chunk)
        for param in range(p):
            acc = np.zeros((s,), np.float64)
            for lo in range(0, w, chunk):
                blk = jnp.asarray(arr[:, lo : lo + chunk, param].T,
                                  jnp.float32)
                acc += np.asarray(_norm_autocov_fft(blk), np.float64).sum(
                    axis=0
                )
            taus[param] = estimate(acc / w)
    else:
        # throughput path: fold params into the batch axis — ONE FFT
        # launch over p*w rows (costs one transposed host copy)
        rows = np.ascontiguousarray(
            np.transpose(arr, (2, 1, 0)).reshape(p * w, s)
        )
        out = np.asarray(
            _norm_autocov_fft(jnp.asarray(rows, jnp.float32)), np.float64
        )
        rho = out.reshape(p, w, s).mean(axis=1)
        for param in range(p):
            taus[param] = estimate(rho[param])
    return float(taus[0]) if squeeze else taus
