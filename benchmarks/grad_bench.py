#!/usr/bin/env python
"""Gradient-engine throughput: ESS/s for NUTS / ChEES / MEADS on the GPU.

10-D correlated Gaussian (same target as bench.py), many vmapped chains.
Each engine: warmup, one compiled+warmed stored run, ESS from the stored
draws over the measured window (device-resident ACT; only rho crosses
the link). Prints one JSON line per engine.

Usage: python benchmarks/grad_bench.py [--chains 1024] [--steps 400]
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--warmup", type=int, default=300)
    ap.add_argument("--engines", default=None,
                    help="comma list (nuts,chees,meads,mclmc,mams); "
                    "default all")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from mcmcpp_tpu import (
        CheesHMCSampler, MAMSSampler, MCLMCSampler, MEADSSampler,
        NUTSSampler,
    )
    from mcmcpp_tpu.analysis import effective_sample_size

    dim, rho = 10, 0.5
    cov = rho * np.ones((dim, dim)) + (1 - rho) * np.eye(dim)
    prec = jnp.asarray(np.linalg.inv(cov), jnp.float32)

    def logp(t):
        return -0.5 * t @ prec @ t

    engines = [
        ("nuts", NUTSSampler, {"max_depth": 8}),
        ("chees", CheesHMCSampler, {}),
        ("meads", MEADSSampler, {}),
        ("mclmc", MCLMCSampler, {}),
        ("mams", MAMSSampler, {}),
    ]
    if args.engines:
        keep = {e.strip() for e in args.engines.split(",")}
        engines = [e for e in engines if e[0] in keep]
    for name, cls, kw in engines:
        s = cls(logp, n_chains=args.chains, n_params=dim, seed=0, **kw)
        s.init_ball(np.zeros(dim), scale=1.0, seed=1)
        if name in ("mclmc", "mams"):
            s.tune(args.warmup)  # microcanonical tuners, no MH warmup
        else:
            s.warmup(args.warmup)
        s.run(8)  # compile + warm the exact stored-run program
        s.chain.clear()
        t0 = time.perf_counter()
        s.run(args.steps)
        dt = time.perf_counter() - t0
        ess = effective_sample_size(s.get_samples())
        worst = float(np.nanmin(np.asarray(ess)))
        print(json.dumps({
            "engine": name,
            "chains": args.chains,
            "steps": args.steps,
            "wall_s": round(dt, 3),
            "ess_per_s_worst_param": round(worst / dt, 1),
            "transitions_per_s": round(args.chains * args.steps / dt, 1),
        }))


if __name__ == "__main__":
    main()
