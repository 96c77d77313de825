#!/usr/bin/env python
"""ESS/s benchmark on the 10-D correlated Gaussian (BASELINE tracked metric).

Measures effective samples per wall-second for the stretch sampler,
including chain-store traffic (stored steps stream host-ward). Prints one
JSON line.

The number without chain-store traffic is measured by bench.py's
`ess_per_s_device_resident` (sampling + ACT FFT in one jitted program,
nothing but the tiny rho vector crossing to the host).

Usage: python benchmarks/ess_bench.py [--walkers 65536] [--steps 2000]
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--walkers", type=int, default=1 << 16)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--thin", type=int, default=4)
    args = ap.parse_args()

    import numpy as np

    from mcmcpp_tpu import EnsembleSampler
    from mcmcpp_tpu.models import correlated_gaussian
    from mcmcpp_tpu.utils import ThroughputMonitor

    t = correlated_gaussian(dim=10)
    s = EnsembleSampler(t.logp, n_walkers=args.walkers, n_params=t.dim,
                        seed=0, max_chain_bytes=8 << 30)
    s.init_ball(np.zeros(t.dim), scale=0.5, seed=1)
    s.run_mcmc(200, store=False)  # burn + compile warm
    mon = ThroughputMonitor(n_walkers=args.walkers)
    with mon.measure(steps=args.steps):
        s.run_mcmc(args.steps, thin=args.thin)
    ess_rate = mon.ess_per_s(s.get_samples())
    print(json.dumps({
        "metric": "ess_per_s_10d_gaussian",
        "value": float(np.nanmin(ess_rate)),
        "unit": "ESS/s (worst parameter)",
        "updates_per_s": mon.updates_per_s,
        "ess_per_s_all": [float(x) for x in ess_rate],
    }))


if __name__ == "__main__":
    main()
