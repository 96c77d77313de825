"""StretchMove partner-selection scale study (round-4 VERDICT item 4).

The one place the reference's exact algorithm (per-walker iid partner
draw, ``MCMCpp/Movers/StretchMove.h:102``) gave up for speed is the
per-row HBM gather. This script measures every candidate at W=2^18 and
W=2^21, P=10, full stretch step (both halves):

- roll          one shared shift (production default)
- block         one iid shift per 128-walker block (ops/partner.py)
- block1024     same with 1024-walker blocks (granularity ablation)
- gather        per-walker iid draw, plain jnp.take
- gather_sorted per-walker iid draw via sort -> monotone gather ->
                invert-permutation unsort (tests whether the gather cost
                is transaction-randomness or per-row issue overhead)

Method: single-launch ``jit(fori_loop)`` with state chained between
calls (CLAUDE.md microbenchmark rule); peak memory from the compiled
``memory_analysis()``. Results belong in docs/design.md §10b.

Run: ``timeout 1800 python benchmarks/partner_scale.py``.
``--smoke`` runs tiny shapes on CPU to check the harness logic.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

P = 10
STEPS = 200


def main():
    smoke = "--smoke" in sys.argv
    print(f"[{time.strftime('%T')}] importing jax...", file=sys.stderr,
          flush=True)
    import jax

    if smoke:
        jax.config.update("jax_platforms", "cpu")
    print(f"[{time.strftime('%T')}] devices: {jax.devices()}",
          file=sys.stderr, flush=True)
    import jax.numpy as jnp

    from mcmcpp_tpu import EnsembleSampler, StretchMove
    from mcmcpp_tpu.movers.base import Mover
    from mcmcpp_tpu.ops.gw import gw_sample
    from mcmcpp_tpu.ops.partner import block_partners
    from mcmcpp_tpu.sampler import run_nostore

    class SortedGatherStretch(Mover):
        """iid partner draw routed through sort/monotone-gather/unsort."""

        def __init__(self, a=2.0):
            self.a = float(a)

        def propose(self, key, active, other, state):
            n, p = active.shape
            m = other.shape[0]
            kj, kz = jax.random.split(key)
            j = jax.random.randint(kj, (n,), 0, m)
            order = jnp.argsort(j)
            rows_sorted = jnp.take(other, jnp.take(j, order), axis=0)
            inv = jnp.zeros((n,), jnp.int32).at[order].set(
                jnp.arange(n, dtype=jnp.int32)
            )
            partner = jnp.take(rows_sorted, inv, axis=0)
            u = jax.random.uniform(kz, (n,), active.dtype)
            z = gw_sample(u, self.a)
            proposal = partner + z[:, None] * (active - partner)
            return proposal, (p - 1) * jnp.log(z)

    class BlockStretch(Mover):
        """block mode with a configurable block size (ablation)."""

        def __init__(self, block, a=2.0):
            self.block = int(block)
            self.a = float(a)

        def propose(self, key, active, other, state):
            n, p = active.shape
            kj, kz = jax.random.split(key)
            partner = block_partners(kj, other, n, 1, block=self.block)[0]
            u = jax.random.uniform(kz, (n,), active.dtype)
            z = gw_sample(u, self.a)
            proposal = partner + z[:, None] * (active - partner)
            return proposal, (p - 1) * jnp.log(z)

    rho = 0.5
    cov = rho * np.ones((P, P)) + (1 - rho) * np.eye(P)
    prec_chol = np.linalg.cholesky(np.linalg.inv(cov)).astype(np.float32)

    def logp_batched(theta):
        y = theta @ prec_chol
        return -0.5 * jnp.sum(y * y, axis=-1)

    movers = {
        "roll": lambda: StretchMove(),
        "block": lambda: StretchMove(partner_mode="block"),
        "block1024": lambda: BlockStretch(1024),
        "gather": lambda: StretchMove(partner_mode="gather"),
        "gather_sorted": lambda: SortedGatherStretch(),
    }
    rows = []
    for log2w in ((8,) if smoke else (18, 21)):
        w = 1 << log2w
        for mode, make in movers.items():
            s = EnsembleSampler(
                logp_batched, n_walkers=w, n_params=P, seed=0, batched=True,
                prng_impl="rbg", mover=make(),
            )
            s.init_ball(np.zeros(P), scale=0.5, seed=1)
            launch = jax.jit(
                lambda st, f=s._step_fn: run_nostore(st, f, STEPS)
            )
            compiled = launch.lower(s.state).compile()
            try:
                mem = compiled.memory_analysis()
                peak = (int(mem.temp_size_in_bytes)
                        + int(mem.argument_size_in_bytes)) / 2**20
            except Exception:
                peak = float("nan")
            state = compiled(s.state)
            jax.block_until_ready(state)
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                state = compiled(state)
                jax.block_until_ready(state)
                best = min(best, time.perf_counter() - t0)
            accept = float(np.mean(
                (np.asarray(state.accepted_red).sum()
                 + np.asarray(state.accepted_black).sum())
            ) / (w * 4 * STEPS))  # 4 = warm + 3 timed launches
            row = {
                "w": w, "mode": mode, "step_us": best / STEPS * 1e6,
                "updates_per_s": w * STEPS / best, "peak_mib": peak,
                "accept": accept,
            }
            rows.append(row)
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
