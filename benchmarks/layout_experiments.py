"""Layout/padding ablations for the hot stretch step (VERDICT r1 item 4).

Questions, each answered by a single-launch ``jit(fori_loop)`` timing with
state chained between calls (CLAUDE.md microbenchmark rule):

A. baseline: the real package step at W=2^21, P=10, rbg PRNG (bench config).
B. P=16: params fill a 16-wide tile exactly — if the step pads P=10 to 16
   (docs/design.md §10), step TIME should match A (same padded bytes
   moved) while doing 1.6x the useful work.
C. P=8: one 8-wide tile, zero padding, 0.8x the bytes of A's padded state.
D. flat carry: the ROADMAP "flat view" experiment done at the XLA level —
   loop state carried as unpadded (n*P,) vectors, reshaped to (n, P) inside
   the step for partner/z/logp math. Measures whether removing carry
   padding beats the relayout cost at the reshape boundaries.
E. flat math: as D, but the elementwise proposal/select also run on flat
   vectors (partner roll becomes a flat roll by r*P; z and the accept mask
   broadcast via (n,1)->(n,P)->flat reshapes); only logp reshapes to 2-D.

Run: ``timeout 900 python benchmarks/layout_experiments.py``.
Prints one JSON line per experiment; optionally dumps a profiler trace and
the optimized HLO of A with ``--artifacts``.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


STEPS = 400
W = 1 << 21


def make_logp(dim):
    import jax.numpy as jnp

    rho = 0.5
    cov = rho * np.ones((dim, dim)) + (1 - rho) * np.eye(dim)
    prec_chol = np.linalg.cholesky(np.linalg.inv(cov)).astype(np.float32)

    def logp_batched(theta):
        y = theta @ prec_chol
        return -0.5 * jnp.sum(y * y, axis=-1)

    return prec_chol, logp_batched


def time_chained(launch, state, n_rep=3):
    """Best-of-n chained launches of an already-warm compiled program."""
    import jax

    best = float("inf")
    for _ in range(n_rep):
        t0 = time.perf_counter()
        state = launch(state)
        jax.block_until_ready(state)
        best = min(best, time.perf_counter() - t0)
    return best, state


def package_step_rate(dim):
    """Experiments A/B/C: the real sampler step via run_nostore."""
    import jax

    from mcmcpp_tpu import EnsembleSampler
    from mcmcpp_tpu.sampler import run_nostore

    _, logp_batched = make_logp(dim)
    s = EnsembleSampler(
        logp_batched, n_walkers=W, n_params=dim, seed=0, batched=True,
        prng_impl="rbg",
    )
    s.init_ball(np.zeros(dim), scale=0.5, seed=1)
    launch = jax.jit(lambda st: run_nostore(st, s._step_fn, STEPS))
    state = launch(s.state)
    jax.block_until_ready(state)  # warm the exact program
    dt, _ = time_chained(launch, state)
    return W * STEPS / dt, dt / STEPS


def _flat_step_factory(dim, flat_math):
    """Experiments D/E: semantically-equivalent step with (n*P,) carries."""
    import jax
    import jax.numpy as jnp

    from mcmcpp_tpu.ops.gw import gw_sample

    prec_chol, _ = make_logp(dim)
    pc = jnp.asarray(prec_chol)
    n = W // 2
    base_key = jax.random.key(0)

    def half_update(key, act_flat, lp, oth_flat):
        kr, kz, ka = jax.random.split(key, 3)
        r = jax.random.randint(kr, (), 0, n)
        u = jax.random.uniform(kz, (n,), jnp.float32)
        z = gw_sample(u, 2.0)
        if flat_math:
            partner_flat = jnp.roll(oth_flat, -r * dim)
            z_flat = jnp.broadcast_to(z[:, None], (n, dim)).reshape(-1)
            prop_flat = partner_flat + z_flat * (act_flat - partner_flat)
            y = prop_flat.reshape(n, dim) @ pc
        else:
            act = act_flat.reshape(n, dim)
            oth = oth_flat.reshape(n, dim)
            partner = jnp.roll(oth, -r, axis=0)
            prop = partner + z[:, None] * (act - partner)
            y = prop @ pc
        lp_new = -0.5 * jnp.sum(y * y, axis=-1)
        log_ratio = (dim - 1) * jnp.log(z) + lp_new - lp
        accept = -jax.random.exponential(ka, (n,)) < log_ratio
        if flat_math:
            acc_flat = jnp.broadcast_to(
                accept[:, None], (n, dim)
            ).reshape(-1)
            new_flat = jnp.where(acc_flat, prop_flat, act_flat)
        else:
            new_flat = jnp.where(accept[:, None], prop, act).reshape(-1)
        return new_flat, jnp.where(accept, lp_new, lp)

    def step(state):
        red, black, lp_r, lp_b, i = state
        k1, k2 = jax.random.split(jax.random.fold_in(base_key, i))
        red, lp_r = half_update(k1, red, lp_r, black)
        black, lp_b = half_update(k2, black, lp_b, red)
        return (red, black, lp_r, lp_b, i + 1)

    return step


def flat_rate(dim, flat_math):
    import jax
    import jax.numpy as jnp

    step = _flat_step_factory(dim, flat_math)
    n = W // 2
    rng = np.random.default_rng(0)
    pos = rng.normal(0, 0.5, (n, dim)).astype(np.float32)
    pc, _ = make_logp(dim)
    lp0 = -0.5 * np.sum((pos @ pc) ** 2, -1)
    state = (
        jnp.asarray(pos.reshape(-1)), jnp.asarray(pos.reshape(-1)),
        jnp.asarray(lp0), jnp.asarray(lp0), jnp.zeros((), jnp.int32),
    )
    launch = jax.jit(
        lambda st: jax.lax.fori_loop(0, STEPS, lambda i, s: step(s), st)
    )
    state = launch(state)
    jax.block_until_ready(state)
    dt, _ = time_chained(launch, state)
    return W * STEPS / dt, dt / STEPS


def dump_artifacts(outdir):
    """Profiler trace (3 chained launches) + optimized HLO of experiment A."""
    import os

    import jax

    from mcmcpp_tpu import EnsembleSampler
    from mcmcpp_tpu.sampler import run_nostore

    _, logp_batched = make_logp(10)
    s = EnsembleSampler(
        logp_batched, n_walkers=W, n_params=10, seed=0, batched=True,
        prng_impl="rbg",
    )
    s.init_ball(np.zeros(10), scale=0.5, seed=1)
    launch = jax.jit(lambda st: run_nostore(st, s._step_fn, STEPS))
    lowered = launch.lower(s.state)
    compiled = lowered.compile()
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "step_optimized_hlo.txt"), "w") as f:
        f.write(compiled.as_text())
    ca = compiled.cost_analysis()
    with open(os.path.join(outdir, "step_cost_analysis.json"), "w") as f:
        json.dump({k: v for k, v in sorted(ca.items())
                   if isinstance(v, (int, float))}, f, indent=1)
    state = launch(s.state)
    jax.block_until_ready(state)
    with jax.profiler.trace(os.path.join(outdir, "trace")):
        for _ in range(3):
            state = launch(state)
        jax.block_until_ready(state)
    print(json.dumps({"artifacts": outdir}))


def main():
    artifacts = "--artifacts" in sys.argv
    results = {}
    for name, dim in (("A_pkg_p10", 10), ("B_pkg_p16", 16), ("C_pkg_p8", 8)):
        rate, step_us = package_step_rate(dim)
        results[name] = {"updates_per_s": rate, "step_us": step_us * 1e6}
        print(json.dumps({name: results[name]}), flush=True)
    for name, fm in (("D_flat_carry_p10", False), ("E_flat_math_p10", True)):
        rate, step_us = flat_rate(10, fm)
        results[name] = {"updates_per_s": rate, "step_us": step_us * 1e6}
        print(json.dumps({name: results[name]}), flush=True)
    if artifacts:
        dump_artifacts("chiprun_out/layout")


if __name__ == "__main__":
    main()
