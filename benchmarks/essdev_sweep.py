"""Sweep the device-resident ESS/s window geometry (W, steps, thin).

Finds the (walker count, window length, thinning) that maximizes the
device-resident ESS/s metric on the GPU. Each config runs the exact
bench.py program (sampling scan + chunked autocov FFT in one jitted
launch, 3 chained repeats).

Usage: python benchmarks/essdev_sweep.py [w_log2 steps thin]...
(no args = the default grid).
"""

import sys

sys.path.insert(0, ".")


def main():
    import jax
    import jax.numpy as jnp

    import bench

    if len(sys.argv) > 1:
        args = [int(a) for a in sys.argv[1:]]
        grid = [tuple(args[i:i + 3]) for i in range(0, len(args), 3)]
    else:
        grid = [
            (16, 3000, 6),
            (17, 3000, 6),
            (18, 3000, 6),
            (17, 6000, 12),
            (18, 6000, 12),
        ]
    print(f"devices: {jax.devices()}", file=sys.stderr, flush=True)
    for w_log2, steps, thin in grid:
        med, spread, w, win, _ = bench.ess_per_s_device_resident(
            jax, jnp, w_log2=w_log2, steps=steps, thin=thin
        )
        print(
            f"W=2^{w_log2} steps={steps} thin={thin}: "
            f"ESS/s={med:.3e} (min {spread['min']:.3e} max "
            f"{spread['max']:.3e}) window-updates/s={win:.3e}",
            flush=True,
        )


if __name__ == "__main__":
    main()
