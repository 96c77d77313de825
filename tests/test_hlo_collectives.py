"""Pod-scaling readiness: inspect the compiled HLO of the sharded step
programs and pin the collective pattern (round-3 verdict item 7).

The perf model (docs/design.md; SURVEY.md §7 hard part (a)) requires the
hot loop's cross-device traffic to be BOUNDED AND NEIGHBORLY so it stays
on the fast links between devices:

- ensemble step: the complementary-set access exchanges only the OPPOSITE
  HALF (W/2, P) — never the whole ensemble — and the per-walker accept
  counters stay device-local (no per-step all-reduce);
- ladder-sharded PT step: temperature swaps move single-temperature
  slices between NEIGHBOR devices (collective-permute), with only
  bytes-sized bookkeeping gathers; the full (K, H, P) replica grid is
  never gathered.

These run on the 8-virtual-device CPU mesh; GSPMD partitioning decisions
(which collective, what shape) are backend-independent at this level, so
a regression here predicts a pod-scaling regression before hardware ever
sees it.
"""

import re

import numpy as np
import jax
import jax.numpy as jnp


def _result_shapes(hlo, op):
    """Shapes of all `op` instruction results, as (dtype, [dims]) pairs."""
    out = []
    for m in re.finditer(rf"= (\w+)\[([\d,]*)\][^ ]* {op}\(", hlo):
        dims = [int(d) for d in m.group(2).split(",") if d]
        out.append((m.group(1), dims))
    return out


def _logp(t):
    return -0.5 * jnp.sum(t * t)


def test_sharded_ensemble_step_collective_pattern():
    from mcmcpp_tpu import ShardedEnsembleSampler

    w, p = 64, 3
    s = ShardedEnsembleSampler(_logp, n_walkers=w, n_params=p, seed=0)
    s.init_ball(np.zeros(p), scale=0.5, seed=1)
    hlo = jax.jit(s._step_fn).lower(s.state).compile().as_text()

    gathers = _result_shapes(hlo, "all-gather")
    assert gathers, "expected the opposite-half exchange to compile in"
    for dtype, dims in gathers:
        # every gather is at most one HALF of the ensemble
        assert int(np.prod(dims)) <= (w // 2) * p, (dtype, dims)
    # the full ensemble (w, p) must never be materialized by a collective
    assert not any(dims == [w, p] for _, dims in gathers)
    # accept counters are sharded, not reduced per step
    assert "all-reduce" not in hlo
    assert "all-to-all" not in hlo


def test_ladder_sharded_pt_step_collective_pattern():
    from mcmcpp_tpu import ParallelTemperingSampler
    from mcmcpp_tpu.parallel.mesh import make_ladder_mesh

    k, h, p = 16, 4, 3
    pt = ParallelTemperingSampler(
        _logp, n_walkers=h, n_params=p, n_temps=k, seed=0,
        mesh=make_ladder_mesh(8),
    )
    pt.init_ball(np.zeros(p), scale=0.5, seed=1)
    hlo = jax.jit(pt._step).lower(pt.state).compile().as_text()

    # neighbor swaps: collective-permutes of single-temperature slices
    permutes = _result_shapes(hlo, "collective-permute")
    assert permutes, "expected the K-axis neighbor swap to permute"
    for dtype, dims in permutes:
        assert int(np.prod(dims)) <= 2 * h * p, (dtype, dims)
    # bookkeeping gathers only (swap decisions / indices — bytes, not the
    # replica grid); the full (K, H, P) grid must never be gathered
    for dtype, dims in _result_shapes(hlo, "all-gather"):
        assert int(np.prod(dims)) <= 2 * k * h, (dtype, dims)
        assert dims != [k, h, p]
    assert "all-to-all" not in hlo


def test_sharded_run_program_has_no_per_step_host_sync():
    """The chunked run program (scan over steps) must keep ALL collectives
    inside the scan body — one launch per chunk, zero host round-trips per
    step (a per-step sync would cap throughput at the host's dispatch
    rate)."""
    from mcmcpp_tpu import ShardedEnsembleSampler

    from mcmcpp_tpu.sampler import run_scan

    s = ShardedEnsembleSampler(_logp, n_walkers=64, n_params=3, seed=0)
    s.init_ball(np.zeros(3), scale=0.5, seed=1)
    # the chunked run program: thin-at-source scan, store every 2nd of 6
    lowered = run_scan.lower(s.state, step_fn=s._step_fn, n_store=3,
                             thin=2)
    hlo = lowered.compile().as_text()
    # outfeed/infeed or host custom-calls inside the loop would be a
    # per-step host sync; the program must have none
    assert "outfeed" not in hlo and "infeed" not in hlo
    assert "CustomCall(\"xla_python_cpu_callback" not in hlo


def test_two_level_mesh_gather_is_ici_inner_dcn_outer():
    """Two-level (hosts x devices) mesh (round-4 VERDICT item 9): the
    walker axis flattens with the DEVICES (same-host) axis innermost, so the
    opposite-half all-gather walks same-host devices contiguously —
    shard neighbors share a host and only the single host boundary
    crosses the network. An axes-order regression would interleave hosts
    (h0d0, h1d0, h0d1, ...), putting the network on every hop.

    GSPMD emits the gather with iota replica groups over the GLOBAL
    device assignment (``replica_groups=[1,8]<=[8]``,
    ``use_global_device_ids=true``), so the traversal order IS the
    executable's device-assignment order — that is what gets pinned."""
    from jax.sharding import Mesh

    from mcmcpp_tpu import ShardedEnsembleSampler
    from mcmcpp_tpu.parallel.mesh import WALKER_AXES, make_walker_mesh

    devices = jax.devices()[:8]
    host_of = {d.id: i // 4 for i, d in enumerate(devices)}  # 2 x 4

    def assignment_host_runs_contiguous(mesh):
        s = ShardedEnsembleSampler(
            _logp, n_walkers=64, n_params=3, seed=0, mesh=mesh
        )
        s.init_ball(np.zeros(3), scale=0.5, seed=1)
        compiled = jax.jit(s._step_fn).lower(s.state).compile()
        hlo = compiled.as_text()
        # the opposite-half exchange must be an iota-ordered global
        # gather (ordering == device assignment) over the full mesh
        assert re.search(
            r"all-gather\([^\n]*replica_groups=\[1,8\]<=\[8\]"
            r"[^\n]*use_global_device_ids=true", hlo
        ), "expected a full-mesh iota-ordered all-gather"
        order = compiled._executable.xla_executable.local_devices()
        hosts_seq = [host_of[d.id] for d in order]
        changes = sum(
            1 for a, b in zip(hosts_seq, hosts_seq[1:]) if a != b
        )
        return changes == len(set(hosts_seq)) - 1

    mesh = make_walker_mesh(devices, n_hosts=2)
    assert assignment_host_runs_contiguous(mesh), (
        "same-host devices not contiguous in the gather order"
    )

    # negative control: an interleaved device grid must FAIL the check
    # (proves the assert actually reads the ordering)
    grid = np.asarray(devices, dtype=object).reshape(4, 2).T
    assert not assignment_host_runs_contiguous(
        Mesh(grid, WALKER_AXES)
    ), "negative control: interleaved mesh should violate contiguity"
