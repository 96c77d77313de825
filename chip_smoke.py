"""On-card smoke run of the ensemble sampler's main path.

Drives the flow a user calls — ``EnsembleSampler`` with the default
threefry key and ``StretchMove`` (shared-shift partners), the ``lax.scan``
drivers, the host chain store and the analysis layer — at full width
(W = 2^21 walkers, P = 10) on one NVIDIA GPU, and checks what comes out
against the target's analytic moments and a float64 reference.

    python chip_smoke.py              # one card: target, main, cross_backend, ess
    python chip_smoke.py --multi-gpu  # four cards: sharded vs unsharded only

Each phase prints one JSON line of findings, tagged with the card's name
and power limit as ``nvidia-smi`` reports them. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a GPU, or if any phase fails, the script exits non-zero and prints
no such line.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

import bench

REPO = os.path.dirname(os.path.abspath(__file__))
DIM = 10
RHO = 0.5
SINGLE_GPU_PHASES = ("target", "main", "cross_backend", "ess")
MULTI_GPU_PHASES = ("multi_gpu",)


class NoAccelerator(RuntimeError):
    """JAX found no GPU; the smoke run never falls back to the CPU."""


def target(precision=jax.lax.Precision.HIGHEST):
    """The benchmark's 10-D equicorrelated Gaussian (rho = 0.5).

    Returns (cov, prec_chol in float64, batched logp (n, P) -> (n,)).
    ``precision=None`` leaves the matmul at JAX's default precision.
    """
    cov = RHO * np.ones((DIM, DIM)) + (1 - RHO) * np.eye(DIM)
    prec_chol = np.linalg.cholesky(np.linalg.inv(cov))
    prec_chol32 = prec_chol.astype(np.float32)

    def logp(theta):
        y = jnp.matmul(theta, prec_chol32, precision=precision)
        return -0.5 * jnp.sum(y * y, axis=-1)

    return cov, prec_chol, logp


def card_info():
    """The card's name and power limit, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def build_native():
    """Build the optional native chain store from its committed source
    (``make -C mcmcpp_tpu/native``); without it the NumPy store runs."""
    try:
        out = subprocess.run(
            ["make", "-C", os.path.join(REPO, "mcmcpp_tpu", "native")],
            capture_output=True, text=True, timeout=300,
        )
    except FileNotFoundError:
        return "make not found"
    return "built" if out.returncode == 0 else f"make rc {out.returncode}"


def require_gpu():
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise NoAccelerator(
            f"no GPU: JAX's default platform is {devs[0].platform!r}"
        )
    return devs


def final_line(devs):
    return json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }})


def _max_rel_err(x, ref):
    return float(np.max(np.abs(np.asarray(x, np.float64) - ref) / np.abs(ref)))


def phase_target(devs, n=1 << 21, seed=0):
    """Batched logp at default precision and at HIGHEST vs float64 NumPy."""
    cov, prec_chol, logp_highest = target()
    _, _, logp_default = target(precision=None)
    rng = np.random.default_rng(seed)
    # draws from the target itself, so |logp| follows chi2(10)/2
    theta = (rng.standard_normal((n, DIM)) @ np.linalg.cholesky(cov).T
             ).astype(np.float32)
    ref = -0.5 * np.sum((theta.astype(np.float64) @ prec_chol) ** 2, axis=-1)
    x = jax.device_put(theta, devs[0])
    err_default = _max_rel_err(jax.jit(logp_default)(x), ref)
    err_highest = _max_rel_err(jax.jit(logp_highest)(x), ref)
    failed = []
    if not err_highest <= 1e-5:
        failed.append(f"HIGHEST logp max rel err {err_highest:.3e} > 1e-5")
    return {"n": n, "max_rel_err_default": err_default,
            "max_rel_err_highest": err_highest, "failed": failed}


def phase_main(devs, n_walkers=1 << 21, burn=1000, n_rows=20, thin=50,
               launch_steps=1000, timed_launches=3, tol=0.01):
    """init_ball -> burn-in -> stored run through the host chain store.

    ``tol`` bounds every sample mean and covariance entry. Each walker
    contributes at least one effective draw, so at W = 2^21 the Monte-Carlo
    standard error of a mean is <= 1/sqrt(W) = 7e-4 and of a covariance
    entry <= sqrt((1 + rho^2)/W) = 8e-4: 0.01 is more than ten of them.
    """
    from mcmcpp_tpu import EnsembleSampler, analysis
    from mcmcpp_tpu.sampler import run_nostore

    cov, _, logp = target()
    failed = []
    with jax.default_device(devs[0]):
        s = EnsembleSampler(logp, n_walkers=n_walkers, n_params=DIM,
                            batched=True)
        s.init_ball(np.zeros(DIM), scale=0.5, seed=1)
        s.run_mcmc(burn, store=False)
        t0 = time.perf_counter()
        if not s.run_mcmc(n_rows * thin, thin=thin):
            failed.append("chain byte cap hit before the stored run ended")
        store_s = time.perf_counter() - t0
        samples = s.get_samples()
        if samples.shape != (n_rows, n_walkers, DIM):
            failed.append(f"samples shape {samples.shape}")
        if not np.isfinite(samples).all():
            failed.append("non-finite samples")
        flat = samples.reshape(-1, DIM)
        mean = flat.mean(axis=0, dtype=np.float64)
        emp_cov = analysis.covariance_matrix(flat)
        acc = float(s.acceptance_fraction)

        # device time per step: chained launches, each fenced by fetching
        # one scalar to the host
        state = run_nostore(s.state, s._step_fn, launch_steps)
        float(state.logp_red[0])
        times = []
        for _ in range(timed_launches):
            t0 = time.perf_counter()
            state = run_nostore(state, s._step_fn, launch_steps)
            float(state.logp_red[0])
            times.append(time.perf_counter() - t0)
        s.state = state
    dt = float(np.median(times))
    mean_err = float(np.max(np.abs(mean)))
    cov_err = float(np.max(np.abs(emp_cov - cov)))
    if not 0.2 <= acc <= 0.8:
        failed.append(f"acceptance {acc:.3f} outside [0.2, 0.8]")
    if not mean_err <= tol:
        failed.append(f"max |mean| {mean_err:.3e} > {tol}")
    if not cov_err <= tol:
        failed.append(f"max |cov - analytic| {cov_err:.3e} > {tol}")
    stats = devs[0].memory_stats() or {}
    return {
        "n_walkers": n_walkers, "stored_rows": n_rows, "thin": thin,
        "acceptance": acc, "max_abs_mean": mean_err,
        "max_abs_cov_err": cov_err, "chain_backend": s.chain.backend,
        "store_window_s": store_s, "chain_bytes": int(s.chain.nbytes),
        "launch_steps": launch_steps,
        "launch_s": times,
        "us_per_step": dt / launch_steps * 1e6,
        "walker_updates_per_s": n_walkers * launch_steps / dt,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "failed": failed,
    }


def phase_cross_backend(devs, n_walkers=1 << 16, other=None):
    """One step on the card and the same step on another device (the CPU).

    Positions and logp must agree within rtol 1e-5 (with an absolute floor
    of 1e-6 for coordinates near zero, where x' = y + z (x - y) cancels).
    An accept decision can differ only where the logp rounding of the two
    backends straddles log(u), so the share of differing walkers should be
    ~0; each differing decision moves its own row and, in roll mode, the
    one black row that proposes against it.
    """
    from mcmcpp_tpu import EnsembleSampler
    from mcmcpp_tpu.sampler import run_nostore

    if other is None:
        other = jax.devices("cpu")[0]
    _, _, logp = target()

    def one_step(dev):
        with jax.default_device(dev):
            s = EnsembleSampler(logp, n_walkers=n_walkers, n_params=DIM,
                                batched=True, seed=3)
            s.init_ball(np.zeros(DIM), scale=1.0, seed=4)
            st = jax.device_get(run_nostore(s.state, s._step_fn, 1))
        return (np.concatenate([st.red, st.black]),
                np.concatenate([st.logp_red, st.logp_black]),
                np.concatenate([st.accepted_red, st.accepted_black]))

    pos_a, lp_a, acc_a = one_step(devs[0])
    pos_b, lp_b, acc_b = one_step(other)
    n_differ = int(np.sum(acc_a != acc_b))
    close = np.all(np.isclose(pos_a, pos_b, rtol=1e-5, atol=1e-6), axis=1)
    close &= np.isclose(lp_a, lp_b, rtol=1e-5, atol=1e-6)
    n_apart = int(np.sum(~close))
    failed = []
    if n_apart > 2 * n_differ:
        failed.append(f"{n_apart} walkers differ beyond rtol 1e-5 with only "
                      f"{n_differ} differing accept decisions")
    if n_differ > 1e-3 * n_walkers:
        failed.append(f"{n_differ} of {n_walkers} accept decisions differ")
    return {
        "n_walkers": n_walkers, "against": f"{other.platform}:{other.id}",
        "accept_differ_share": n_differ / n_walkers,
        "walkers_beyond_tol": n_apart,
        "max_abs_pos_diff": float(np.max(np.abs(pos_a - pos_b))),
        "failed": failed,
    }


def phase_ess(devs, w_log2=18, steps=48000, thin=96):
    """bench.py's device-resident ESS program at its window."""
    with jax.default_device(devs[0]):
        ess, spread, n_walkers, window, taus = (
            bench.ess_per_s_device_resident(jax, jnp, w_log2, steps, thin)
        )
    failed = []
    if not (np.all(np.isfinite(taus)) and np.all(taus > 0)):
        failed.append(f"tau not positive and finite: {taus.tolist()}")
    return {"n_walkers": n_walkers, "steps": steps, "thin": thin,
            "ess_per_s": ess, "spread": spread,
            "window_updates_per_s": window, "taus": taus.tolist(),
            "failed": failed}


def phase_multi_gpu(devs, n_walkers=1 << 22, n_store=2, thin=8):
    """Stored scan of ShardedEnsembleSampler over 4 cards vs the unsharded
    sampler on one card, same seed.

    On the CPU mesh the two agree bitwise. On the GPU the logp matmul runs
    at two row counts (per shard and whole), for which cuBLAS may pick
    different GEMM kernels (split-K or not), so logp can round differently
    in its last bits: the check is rtol 1e-5 with an absolute floor of
    1e-6 (a few float32 ULPs at |logp| ~ 5), and ``bitwise`` reports
    whether the arrays were identical anyway.
    """
    from mcmcpp_tpu import EnsembleSampler, ShardedEnsembleSampler
    from mcmcpp_tpu.parallel.mesh import make_walker_mesh
    from mcmcpp_tpu.sampler import run_scan

    if len(devs) < 4:
        raise RuntimeError(f"--multi-gpu needs 4 devices, found {len(devs)}")
    mesh = make_walker_mesh(devs[:4])
    _, _, logp = target()

    def scan(s):
        s.init_ball(np.zeros(DIM), scale=0.5, seed=1)
        _, pos, lp, _, _ = run_scan(s.state, s._step_fn, n_store, thin)
        return np.asarray(pos), np.asarray(lp)

    pos_s, lp_s = scan(ShardedEnsembleSampler(
        logp, n_walkers=n_walkers, n_params=DIM, batched=True, mesh=mesh))
    with jax.default_device(devs[0]):
        pos_r, lp_r = scan(EnsembleSampler(
            logp, n_walkers=n_walkers, n_params=DIM, batched=True))
    bitwise = bool(np.array_equal(pos_s, pos_r)
                   and np.array_equal(lp_s, lp_r))
    close = (np.allclose(pos_s, pos_r, rtol=1e-5, atol=1e-6)
             and np.allclose(lp_s, lp_r, rtol=1e-5, atol=1e-6))
    failed = [] if close else ["sharded scan != unsharded scan (rtol 1e-5)"]
    return {
        "n_walkers": n_walkers, "mesh": dict(mesh.shape),
        "n_store": n_store, "thin": thin, "bitwise": bitwise,
        "max_abs_pos_diff": float(np.max(np.abs(pos_s - pos_r))),
        "max_abs_logp_diff": float(np.max(np.abs(lp_s - lp_r))),
        "failed": failed,
    }


def plan(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--multi-gpu", action="store_true",
        help="run only the 4-card sharded-vs-unsharded comparison",
    )
    args = parser.parse_args(argv)
    return MULTI_GPU_PHASES if args.multi_gpu else SINGLE_GPU_PHASES


def emit(phase, card, fields):
    print(json.dumps({"phase": phase, "card": card, **fields}), flush=True)


def main(argv=None):
    phases = plan(argv)
    try:
        devs = require_gpu()
    except NoAccelerator as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    cache = bench.use_compile_cache(REPO)
    card = card_info()
    print(card, flush=True)
    card = "; ".join(card.splitlines())
    emit("device", card, {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
        "bytes_limit": (devs[0].memory_stats() or {}).get("bytes_limit"),
        "compile_cache": cache,
        "native_chain_store": build_native(),
    })
    for name in phases:
        t0 = time.perf_counter()
        fields = globals()["phase_" + name](devs)
        fields["phase_s"] = time.perf_counter() - t0
        emit(name, card, fields)
        if fields["failed"]:
            raise SystemExit(f"chip_smoke: phase {name} failed: "
                             f"{'; '.join(fields['failed'])}")
    print(final_line(devs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
