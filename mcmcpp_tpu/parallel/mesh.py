"""Mesh construction helpers for walker-sharded sampling.

The reference's only parallelism axis is "walkers across pthreads on one
node" (``MCMCpp/Threading/RedBlkCtrlerSpinLock.h:119`` work stealing). Here
the same axis maps onto the devices as a (possibly 2-D ``hosts × devices``)
mesh whose flattened product shards the walker dimension: intra-host
collectives ride the links between a host's devices (NVLink on a GPU
host), cross-host ones the network. Work stealing is unnecessary —
walker updates are uniform cost, so a static equal shard is optimal.
"""

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec


WALKER_AXES = ("hosts", "devices")


def make_walker_mesh(devices=None, n_hosts=None):
    """Build a ``(hosts, devices)`` mesh over ``devices`` (default: all).

    ``n_hosts`` defaults to the number of distinct processes owning the
    devices (1 in single-controller runs), so in a multi-host run the
    ``hosts`` axis crosses the network and ``devices`` stays within a host.
    """
    if devices is None:
        devices = jax.devices()
    devices = list(devices)
    if n_hosts is None:
        n_hosts = len({getattr(d, "process_index", 0) for d in devices})
    n = len(devices)
    if n % n_hosts != 0:
        raise ValueError(f"{n} devices not divisible by {n_hosts} hosts")
    grid = np.asarray(devices, dtype=object).reshape(n_hosts, n // n_hosts)
    return Mesh(grid, WALKER_AXES)


def particle_constrainer(mesh, n, name="n_particles"):
    """Build ``constrain(*arrays) -> tuple`` pinning each array's
    LEADING axis over the whole mesh (identity when ``mesh`` is None),
    for any trailing rank — the shared guard + constraint used by the
    standalone filters (particle/RBPF/EnKF) and SVGD.

    Sharding one BIG filter/cloud differs from the vmapped path (PMMH/
    SMC², where whole filters stay device-local): the particle axis
    itself partitions and GSPMD inserts the collectives the reductions
    need (logsumexp/anomaly-product all-reduce, resampling all-gather).
    Correctness is unchanged up to float reduction order — parity-tested
    per caller on the CPU mesh.
    """
    if mesh is None:
        return lambda *arrs: arrs
    if n % mesh.size != 0:
        raise ValueError(
            f"{name}={n} not divisible by mesh size {mesh.size}"
        )

    def constrain(*arrs):
        return tuple(
            jax.lax.with_sharding_constraint(
                a, NamedSharding(mesh, PartitionSpec(
                    WALKER_AXES, *([None] * (a.ndim - 1))
                ))
            ) for a in arrs
        )

    return constrain


def walker_sharding(mesh):
    """NamedSharding putting the walker (leading) axis over the whole mesh."""
    return NamedSharding(mesh, PartitionSpec(WALKER_AXES, None))


def vector_sharding(matrix_sharding):
    """The (N,)-vector sharding matching a (N, P) walker sharding's rows."""
    return NamedSharding(
        matrix_sharding.mesh, PartitionSpec(matrix_sharding.spec[0])
    )


def replicated(mesh):
    return NamedSharding(mesh, PartitionSpec())


def grid_sharding(mesh, ndim=3):
    """Sharding for replica-grid arrays ``(K, H, ...)``: the ladder axis is
    replicated, the walker axis shards over the whole mesh (swaps act
    per-walker, so exchange phases need no cross-device communication;
    the K-axis rolls stay device-local)."""
    spec = (None, WALKER_AXES) + (None,) * (ndim - 2)
    return NamedSharding(mesh, PartitionSpec(*spec))


LADDER_AXES = ("ladder", "walkers")


def make_ladder_mesh(n_ladder_shards, devices=None):
    """Build a ``(ladder, walkers)`` mesh for K > device-count tempering.

    The first axis shards the temperature ladder itself; the second shards
    walkers within each replica. The replica-exchange K-axis rolls in
    ``tempering._swap_phase`` then lower to XLA collective-permutes between
    ladder-NEIGHBOR devices — point-to-point transfers between
    neighbours, never all-to-all. Pass the result as ``ParallelTemperingSampler(mesh=...)``;
    the sampler picks the layout from the axis names.
    """
    devices = list(jax.devices() if devices is None else devices)
    n = len(devices)
    k = int(n_ladder_shards)
    if k < 1 or n % k:
        raise ValueError(f"{n} devices not divisible by {k} ladder shards")
    grid = np.asarray(devices, dtype=object).reshape(k, n // k)
    return Mesh(grid, LADDER_AXES)


def ladder_grid_sharding(mesh, ndim=3):
    """``(K, H, ...)`` sharding over a :func:`make_ladder_mesh` mesh."""
    spec = LADDER_AXES + (None,) * (ndim - 2)
    return NamedSharding(mesh, PartitionSpec(*spec))
