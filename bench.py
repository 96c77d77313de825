"""Headline benchmark: walker-updates/s + ESS/s on a 10-D correlated Gaussian.

Prints ONE JSON line {"metric", "value", "unit", ...} where the primary
metric is walker-updates/s/chip and the primary ESS metric is the
DEVICE-RESIDENT ESS/s (sampling scan + autocovariance FFT in one jitted
program, only the walker-averaged rho crossing to the host). The
store-inclusive tiers ride along as secondary keys: their window includes
the device->host chain offload at f32, bf16 and f8 row precision.

Statistical rigor: every metric is measured >=3 times (state chained
between repeats — see the CLAUDE.md microbenchmark rule) and reported as
median with min/max spread in a "spread" map.

The run is one process: stage timestamps go to stderr, the JSON line to
stdout. ``python bench.py``.
"""

import json
import os
import sys
import time

import numpy as np

REPEATS = int(os.environ.get("BENCH_REPEATS", 3))
REPO = os.path.dirname(os.path.abspath(__file__))


def use_compile_cache(root=REPO):
    """Keep JAX's persistent compile cache at a fixed path.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX's own config already reads
    it and nothing is changed. Otherwise the cache goes to
    ``<root>/.jax_cache`` (a fixed path: the path is part of the cache key,
    so a moving directory never hits). Returns the directory in use.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(root, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def _spread(values):
    """(median, {median,min,max,n}) for a list of repeat measurements."""
    v = np.asarray(values, np.float64)
    return float(np.median(v)), {
        "median": float(np.median(v)),
        "min": float(np.min(v)),
        "max": float(np.max(v)),
        "n": int(v.size),
    }


def _target(jnp):
    import jax

    dim = 10
    rho = 0.5
    cov = rho * np.ones((dim, dim)) + (1 - rho) * np.eye(dim)
    prec_chol = jnp.asarray(np.linalg.cholesky(np.linalg.inv(cov)), jnp.float32)

    def logp_batched(theta):  # (n, P) -> (n,): one matmul per half-step
        # HIGHEST: a bare f32 matmul may run as TF32 on the GPU, and that
        # rounding would enter the Metropolis ratios
        y = jnp.matmul(theta, prec_chol, precision=jax.lax.Precision.HIGHEST)
        return -0.5 * jnp.sum(y * y, axis=-1)

    return dim, logp_batched


def headline_updates_per_s(jax, jnp):
    """Peak walker-updates/s: single-launch jit(fori_loop), state chained
    between calls (see CLAUDE.md microbenchmark rule)."""
    from mcmcpp_tpu import EnsembleSampler
    from mcmcpp_tpu.sampler import run_nostore

    dim, logp_batched = _target(jnp)
    n_walkers = 1 << 21
    # rbg: XLA RngBitGenerator (cross-topology bitwise reproducibility is
    # irrelevant for a throughput benchmark)
    s = EnsembleSampler(
        logp_batched, n_walkers=n_walkers, n_params=dim, seed=0, batched=True,
        prng_impl="rbg",
    )
    s.init_ball(np.zeros(dim), scale=0.5, seed=1)

    steps = 1000
    # warmup/compile the exact program that gets timed (same static shape)
    state = run_nostore(s.state, s._step_fn, steps)
    jax.block_until_ready(state)
    rates = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        state = run_nostore(state, s._step_fn, steps)
        jax.block_until_ready(state)
        rates.append(n_walkers * steps / (time.perf_counter() - t0))
    return _spread(rates)


def ess_per_s(jax, jnp, store_dtype=None):
    """Store-inclusive ESS/s (secondary tier).

    The measured window covers sampling + the pipelined device->host chain
    offload. ``store_dtype=bfloat16`` measures the reduced-precision store
    path (half the offload bytes).
    """
    from mcmcpp_tpu import EnsembleSampler
    from mcmcpp_tpu.utils import ThroughputMonitor

    dim, logp_batched = _target(jnp)
    n_walkers = 1 << 12
    steps, thin, chunk = 3000, 6, 250
    s = EnsembleSampler(
        logp_batched, n_walkers=n_walkers, n_params=dim, seed=0, batched=True,
        prng_impl="rbg", store_chunk_steps=chunk, store_dtype=store_dtype,
    )
    s.init_ball(np.zeros(dim), scale=0.5, seed=1)
    s.run_mcmc(300, store=False)  # burn-in + nostore compile warm
    # warm the EXACT stored-run program (one full (chunk, thin) launch),
    # then clear the chain so the measured windows pay zero compile
    s.run_mcmc(chunk * thin, thin=thin)
    rates, window_rates = [], []
    for _ in range(REPEATS):
        s.reset()
        mon = ThroughputMonitor(n_walkers=n_walkers)
        with mon.measure(steps=steps):
            s.run_mcmc(steps, thin=thin)
        rates.append(float(np.nanmin(mon.ess_per_s(s.get_samples()))))
        window_rates.append(mon.updates_per_s)
    med, spread = _spread(rates)
    return med, spread, float(np.median(window_rates))


def ess_per_s_device_resident(jax, jnp, w_log2=None, steps=None, thin=None):
    """PRIMARY ESS metric: ESS/s with the samples never leaving the device.

    One jitted program runs the full thinned sampling scan AND the
    per-walker autocovariance FFT on device; only the walker-averaged
    rho(t) (P x S floats, ~20 KB) crosses to the host for the Sokal window.

    The autocovariance FFT is CHUNKED over walker blocks inside the same
    program so peak scratch stays bounded (an unchunked rfft over all P*W
    rows would add several GB of complex scratch on top of the (S, W, P)
    sample block).

    Returns (median ESS/s, spread, n_walkers, median window updates/s,
    taus of the last repeat).
    """
    from mcmcpp_tpu import EnsembleSampler
    from mcmcpp_tpu.analysis.autocorr import _sokal_window_tau
    from mcmcpp_tpu.sampler import run_scan

    dim, logp_batched = _target(jnp)
    # thin=96 puts the stored-series tau near 1.4, the thinning optimum
    # (beyond it thinning discards independent samples)
    if w_log2 is None:
        w_log2 = int(os.environ.get("BENCH_DEVICE_W_LOG2", 18))
    n_walkers = 1 << w_log2
    if steps is None:
        steps = int(os.environ.get("BENCH_DEVICE_STEPS", 48000))
    if thin is None:
        thin = int(os.environ.get("BENCH_DEVICE_THIN", 96))
    n_store = steps // thin
    blk = min(n_walkers, 1 << 13)  # FFT block: 8192 walkers
    s = EnsembleSampler(
        logp_batched, n_walkers=n_walkers, n_params=dim, seed=0, batched=True,
        prng_impl="rbg",
    )
    s.init_ball(np.zeros(dim), scale=0.5, seed=1)
    s.run_mcmc(300, store=False)  # burn-in

    npad = 2 * (1 << (n_store - 1).bit_length())

    def prog(state):
        final, pos, _, _, _ = run_scan(state, s._step_fn, n_store, thin)

        # pos: (S, W, P). Chunk the batched FFT over walker blocks; only
        # the per-block rho sums (n_blocks, P, S) are materialized.
        def block_rho(j):
            b = jax.lax.dynamic_slice(
                pos, (0, j * blk, 0), (n_store, blk, dim)
            )
            rows = b.transpose(2, 1, 0).reshape(dim * blk, n_store)
            centered = rows - jnp.mean(rows, axis=1, keepdims=True)
            f = jnp.fft.rfft(centered, n=npad, axis=1)
            acov = jnp.fft.irfft(f * jnp.conj(f), n=npad, axis=1)[:, :n_store]
            rho_b = (acov / acov[:, :1]).reshape(dim, blk, n_store)
            return rho_b.sum(axis=1)

        rho = jax.lax.map(
            block_rho, jnp.arange(n_walkers // blk)
        ).sum(axis=0) / n_walkers
        return final, rho

    prog = jax.jit(prog)
    state, _ = prog(s.state)  # compile + warm the exact program
    jax.block_until_ready(state)
    rates, window_rates = [], []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        state, rho = prog(state)
        rho = np.asarray(rho)  # ~20 KB transfer fences the timing
        taus = np.array([_sokal_window_tau(r, 4.0) for r in rho])
        dt = time.perf_counter() - t0
        ess = np.where(
            taus > 0, n_store * n_walkers / np.maximum(taus, 1e-12), np.nan
        )
        rates.append(float(np.nanmin(ess) / dt))
        window_rates.append(steps * n_walkers / dt)
    med, spread = _spread(rates)
    return med, spread, n_walkers, float(np.median(window_rates)), taus


def _log(msg):
    print(f"[bench +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


_T0 = time.time()


def run():
    """Measure every metric once (with repeats) and print the JSON line."""
    use_compile_cache()
    import jax
    import jax.numpy as jnp

    devs = jax.devices()
    _log(f"backend up: {devs}")

    _log("headline walker-updates/s (compile + chained repeat launches)")
    updates_per_s, updates_spread = headline_updates_per_s(jax, jnp)
    _log(f"headline done: {updates_per_s:.3e} {updates_spread}")
    ess_device, dev_spread, dev_w, dev_window, _ = ess_per_s_device_resident(
        jax, jnp
    )
    _log(f"device-resident ESS/s done (W=2^{int(np.log2(dev_w))}): "
         f"{ess_device:.3e} {dev_spread}")
    ess_rate, ess_spread, ess_window_updates = ess_per_s(jax, jnp)
    _log(f"store-inclusive ESS/s done: {ess_rate:.3e} {ess_spread}")
    ess_bf16, bf16_spread, _ = ess_per_s(jax, jnp, store_dtype=jnp.bfloat16)
    _log(f"store-inclusive ESS/s (bf16 store) done: {ess_bf16:.3e} "
         f"{bf16_spread}")
    ess_f8, f8_spread, _ = ess_per_s(
        jax, jnp, store_dtype=jnp.float8_e4m3fn
    )
    _log(f"store-inclusive ESS/s (f8 store) done: {ess_f8:.3e} {f8_spread}")
    result = {
        "metric": "walker_updates_per_s_10d_gaussian",
        "value": updates_per_s,
        "unit": "walker-updates/s/chip",
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(devs),
        },
        "ess_per_s_device_resident": ess_device,
        "ess_device_unit": "ESS/s (worst parameter, samples+ACT on device; "
                           "PRIMARY ESS metric)",
        "ess_device_n_walkers": dev_w,
        "ess_device_window_updates_per_s": dev_window,
        "ess_per_s_10d_gaussian": ess_rate,
        "ess_per_s_10d_gaussian_bf16store": ess_bf16,
        "ess_per_s_10d_gaussian_f8store": ess_f8,
        "ess_unit": "ESS/s (worst parameter, chain store included)",
        "ess_window_updates_per_s": ess_window_updates,
    }
    result["spread"] = {
        "walker_updates_per_s": updates_spread,
        "ess_per_s_device_resident": dev_spread,
        "ess_per_s_10d_gaussian": ess_spread,
        "ess_per_s_10d_gaussian_bf16store": bf16_spread,
        "ess_per_s_10d_gaussian_f8store": f8_spread,
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    run()
