"""Sequential-layer throughput measurement on the GPU.

Measures the engines added in the second half of round 4 so docs/design.md
§16 carries numbers, not assertions:

- bootstrap particle filter: particle-steps/s at N = 2^13..2^15 (T=512);
- Rao-Blackwellised filter (2-regime switching, D=1): particle-steps/s —
  each "step" here is N tiny Kalman updates batched into (N, D, D)
  einsums, so the comparison quantifies what the exact marginalization
  costs over pure sampling;
- particle smoother backward pass: (J, N) reweighting steps/s;
- SMC²: wall time per absorbed observation at M=256, Nx=128 (advance
  only, rejuvenation excluded by setting target_ess=0).

Method: whole-program jit launches (a filter IS one scan launch) with
distinct PRNG keys per repeat, best-of-3, each ended by
``block_until_ready``.

Run: ``timeout 1800 python benchmarks/sequential_bench.py``.
Prints one JSON line per cell.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from mcmcpp_tpu import (
    SMC2Sampler, StateSpaceModel, particle_filter, particle_smoother,
    rao_blackwell_filter, switching_model,
)

T = 512
SIG_Q, SIG_R = 0.35, 0.6


def _ssm():
    return StateSpaceModel(
        init_sample=lambda k, n, th: jnp.sqrt(2.0) * jax.random.normal(
            k, (n, 1)
        ),
        trans_sample=lambda k, x, t, th: x + SIG_Q * jax.random.normal(
            k, x.shape
        ),
        obs_logpdf=lambda y, x, t, th: -0.5 * ((y[0] - x[:, 0]) / SIG_R) ** 2,
        trans_logpdf=lambda xn, x, t, th: -0.5 * (
            (xn[:, 0] - x[:, 0]) / SIG_Q
        ) ** 2,
    )


def _switch():
    eye = jnp.eye(1, dtype=jnp.float32)
    return switching_model(
        jnp.asarray([[0.9, 0.1], [0.2, 0.8]], jnp.float32),
        A=jnp.stack([eye, 0.6 * eye]), b=jnp.zeros((2, 1), jnp.float32),
        Q=jnp.stack([0.1 * eye, 0.6 * eye]), H=jnp.stack([eye, eye]),
        c=jnp.zeros((2, 1), jnp.float32),
        R=jnp.stack([SIG_R ** 2 * eye, SIG_R ** 2 * eye]),
        m0=jnp.zeros(1, jnp.float32), P0=2.0 * eye,
    )


def _time(fn, *args_list):
    """best-of over launches with distinct args; returns seconds."""
    best = float("inf")
    for args in args_list:
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    rng = np.random.default_rng(0)
    ys = np.cumsum(SIG_Q * rng.standard_normal(T)).astype(np.float32)
    keys = [jax.random.key(i) for i in range(4)]

    ssm = _ssm()
    for logn in (13, 14, 15):
        n = 1 << logn
        fn = jax.jit(lambda k, n=n: particle_filter(
            k, ssm, None, ys, n
        ).loglik)
        jax.block_until_ready(fn(keys[0]))  # compile+sync
        dt = _time(fn, (keys[1],), (keys[2],), (keys[3],))
        print(json.dumps({
            "bench": "bootstrap_pf", "N": n, "T": T,
            "s_per_filter": round(dt, 4),
            "particle_steps_per_s": round(n * T / dt),
        }), flush=True)

    # the vmapped-filters regime (the PMMH/SMC² shape): same total
    # particle count as the biggest single filter, partitioned into 64
    # independent device-local filters
    c, n = 64, 512
    fnv = jax.jit(lambda k: jax.vmap(
        lambda kk: particle_filter(kk, ssm, None, ys, n).loglik
    )(jax.random.split(k, c)))
    jax.block_until_ready(fnv(keys[0]))  # compile+sync
    dt = _time(fnv, (keys[1],), (keys[2],), (keys[3],))
    print(json.dumps({
        "bench": "bootstrap_pf_vmapped", "C": c, "N": n, "T": T,
        "s_per_batch": round(dt, 4),
        "particle_steps_per_s": round(c * n * T / dt),
    }), flush=True)

    model = _switch()
    for logn in (13, 14, 15):
        n = 1 << logn
        fn = jax.jit(lambda k, n=n: rao_blackwell_filter(
            k, model, ys, n
        ).loglik)
        jax.block_until_ready(fn(keys[0]))  # compile+sync
        dt = _time(fn, (keys[1],), (keys[2],), (keys[3],))
        print(json.dumps({
            "bench": "rbpf_switching", "N": n, "T": T,
            "s_per_filter": round(dt, 4),
            "particle_steps_per_s": round(n * T / dt),
        }), flush=True)

    n, j = 1 << 13, 512
    fn = jax.jit(lambda k: particle_smoother(
        k, ssm, None, ys, n, j
    ).smoothed_means)
    jax.block_until_ready(fn(keys[0]))  # compile+sync
    dt = _time(fn, (keys[1],), (keys[2],), (keys[3],))
    print(json.dumps({
        "bench": "ffbs_smoother", "N": n, "J": j, "T": T,
        "s_total": round(dt, 4),
        "backward_reweights_per_s": round(j * n * T / dt),
    }), flush=True)

    s = SMC2Sampler(
        ssm, lambda th: -0.5 * th[0] ** 2,
        lambda k, n: jax.random.normal(k, (n, 1)),
        n_theta=256, n_params=1, n_particles=128, seed=0,
        target_ess=0.0,   # advance-only cost (no rejuvenation)
    )
    # warm PAST the capacity-256 boundary (rows 129+ run the capacity-256
    # program) so the timed window measures launches, not the trace+
    # compile of a fresh capacity program
    s.update(ys[:130])
    t0 = time.perf_counter()
    s.update(ys[130:256])
    dt = (time.perf_counter() - t0) / 126
    print(json.dumps({
        "bench": "smc2_advance", "M": 256, "Nx": 128,
        "s_per_obs": round(dt, 5),
        "x_particle_steps_per_s": round(256 * 128 / dt),
    }), flush=True)


if __name__ == "__main__":
    main()
