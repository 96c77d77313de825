"""WalkMove gather-mode scale measurement (VERDICT r2 item 8).

``movers/walk.py``'s exact per-walker S-subset path ("gather" mode,
O(n·S) memory) claims usability at W=2^21 — the scale the reference's
per-walker Knuth selection sampling (``MCMCpp/Movers/WalkMove.h:130-150``)
serves on the CPU. This script MEASURES that claim on the GPU: step time
and compiled peak memory for both partner modes at W=2^18..2^21, P=10,
so docs/design.md can carry a table instead of a docstring assertion.

Method: single-launch ``jit(fori_loop)`` with state chained between calls
(CLAUDE.md microbenchmark rule); peak memory from the compiled program's
``memory_analysis()`` (temp + argument bytes — what the chip actually
reserves, not live-array heuristics).

Run: ``timeout 1800 python benchmarks/walk_scale.py``.
Prints one JSON line per (W, mode) cell.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

P = 10
S = 6
STEPS = 200  # gather mode is expected ~20x slower; keep launches bounded


def main():
    smoke = "--smoke" in sys.argv  # CPU logic check: tiny W, cpu platform
    print(f"[{time.strftime('%T')}] importing jax...", file=sys.stderr, flush=True)
    import jax

    if smoke:
        jax.config.update("jax_platforms", "cpu")
    print(f"[{time.strftime('%T')}] devices: {jax.devices()}",
          file=sys.stderr, flush=True)
    import jax.numpy as jnp

    from mcmcpp_tpu import EnsembleSampler, WalkMove
    from mcmcpp_tpu.sampler import run_nostore

    rho = 0.5
    cov = rho * np.ones((P, P)) + (1 - rho) * np.eye(P)
    prec_chol = np.linalg.cholesky(np.linalg.inv(cov)).astype(np.float32)

    def logp_batched(theta):
        y = theta @ prec_chol
        return -0.5 * jnp.sum(y * y, axis=-1)

    rows = []
    for log2w in ((8, 9) if smoke else (18, 19, 20, 21)):
        w = 1 << log2w
        for mode in ("roll", "gather"):
            s = EnsembleSampler(
                logp_batched, n_walkers=w, n_params=P, seed=0, batched=True,
                prng_impl="rbg", mover=WalkMove(n_samples=S, partner_mode=mode),
            )
            s.init_ball(np.zeros(P), scale=0.5, seed=1)
            launch = jax.jit(lambda st, f=s._step_fn: run_nostore(st, f, STEPS))
            lowered = launch.lower(s.state)
            compiled = lowered.compile()
            try:
                mem = compiled.memory_analysis()
                peak = (int(mem.temp_size_in_bytes)
                        + int(mem.argument_size_in_bytes)) / 2**20
            except Exception:  # some backends lack memory analysis
                peak = float("nan")
            state = compiled(s.state)
            jax.block_until_ready(state)  # warm + first chained input
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                state = compiled(state)
                jax.block_until_ready(state)
                best = min(best, time.perf_counter() - t0)
            n_acc = (jnp.sum(state.accepted_red)
                     + jnp.sum(state.accepted_black))
            acc = float(n_acc) / (w * int(state.step))
            row = {
                "mode": mode, "W": w, "P": P, "S": S,
                "step_us": best / STEPS * 1e6,
                "walker_updates_per_s": w * STEPS / best,
                "peak_mem_mib": round(peak, 1),
                "acceptance": round(acc, 4),
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
            del launch, lowered, compiled, state, s
            jax.clear_caches()
    # markdown table for docs/design.md
    print("\n| W | mode | step µs | walker-updates/s | peak MiB | accept |",
          file=sys.stderr)
    print("|---|---|---|---|---|---|", file=sys.stderr)
    for r in rows:
        print(f"| 2^{int(np.log2(r['W']))} | {r['mode']} | "
              f"{r['step_us']:.0f} | {r['walker_updates_per_s']:.3g} | "
              f"{r['peak_mem_mib']} | {r['acceptance']} |", file=sys.stderr)


if __name__ == "__main__":
    main()
