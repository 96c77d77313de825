#!/usr/bin/env python
"""Scaling-efficiency benchmark: walker throughput vs device count.

Measures samples/s scaling efficiency from 1 card to all the cards of a
host (and across hosts with ``--distributed``). On real hardware run this
per topology; on a dev box use ``--cpu-mesh`` to validate the sharded
program over virtual devices (logic check — CPU times are not GPU times).

Weak scaling: walkers per device held fixed, total walkers grow with the
mesh; efficiency = (updates/s at N devices) / (N x updates/s at 1 device).

Usage:
    python benchmarks/scaling.py [--walkers-per-device 262144] [--steps 50]
        [--cpu-mesh]
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--walkers-per-device", type=int, default=1 << 18)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--cpu-mesh", action="store_true",
                    help="8 virtual CPU devices (logic check)")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-host mode: jax.distributed.initialize() "
                         "then measure the FULL global mesh only (run the "
                         "same command on every host)")
    ap.add_argument("--base-rate", type=float, default=None,
                    help="single-device updates/s from a prior 1-chip run "
                         "(efficiency denominator in --distributed mode)")
    args = ap.parse_args()

    if args.cpu_mesh:
        import os

        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    if args.cpu_mesh:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from mcmcpp_tpu import ShardedEnsembleSampler
    from mcmcpp_tpu.models import correlated_gaussian
    from mcmcpp_tpu.parallel.mesh import make_walker_mesh
    from mcmcpp_tpu.sampler import run_nostore

    if args.distributed:
        if args.base_rate is None:
            ap.error("--distributed needs --base-rate <single-card "
                     "updates/s> (run this script on one card first); "
                     "without it the efficiency column would divide the "
                     "slice rate by itself")
        from mcmcpp_tpu.parallel.distributed import initialize

        initialize()  # cluster auto-discovery (e.g. SLURM); idempotent

    target = correlated_gaussian(dim=10)
    all_devices = jax.devices()
    if args.distributed:
        # one measurement over the whole slice; per-subset iteration is
        # a single-controller concept (run on one card and on one host
        # first to collect the denominators)
        counts = [len(all_devices)]
    else:
        counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(all_devices)]
    results = []
    base_rate = args.base_rate
    for n in counts:
        mesh = make_walker_mesh(all_devices[:n])
        w = args.walkers_per_device * n
        s = ShardedEnsembleSampler(
            target.logp, n_walkers=w, n_params=target.dim, seed=0, mesh=mesh
        )
        s.init_ball(np.zeros(target.dim), scale=0.5, seed=1)
        st = run_nostore(s.state, s._step_fn, args.steps)
        jax.block_until_ready(st)
        t0 = time.perf_counter()
        st = run_nostore(st, s._step_fn, args.steps)
        jax.block_until_ready(st)
        dt = time.perf_counter() - t0
        rate = w * args.steps / dt
        if base_rate is None:
            base_rate = rate
        eff = rate / (n * base_rate)
        results.append(
            {"devices": n, "walkers": w, "updates_per_s": rate,
             "efficiency": eff}
        )
        if jax.process_index() == 0:
            print(f"devices={n:3d} walkers={w:9d} "
                  f"{rate / 1e6:9.1f}M upd/s  efficiency={eff:6.1%}")
    if jax.process_index() == 0:
        print(json.dumps(results))


if __name__ == "__main__":
    main()
