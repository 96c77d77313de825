"""Sharded (multi-chip / multi-host) ensemble runtime.

Accelerator-native replacement for the reference's pthread parallel runtime
(``MCMCpp/ParallelEnsembleSampler.h``, ``MCMCpp/Threading/``): instead of a
persistent worker pool with red/black phase barriers and atomic work
stealing, the walker ensemble is ONE array sharded over a
``jax.sharding.Mesh`` and the (unchanged) pure step function is jitted with
sharding constraints. XLA inserts the collectives the barriers used to
provide: the complementary-half gather becomes an all-gather, and
acceptance counters become an all-reduce (cf. SURVEY.md §2
parallelism-strategy inventory).
"""

from mcmcpp_tpu.parallel.mesh import (
    make_ladder_mesh,
    make_walker_mesh,
    walker_sharding,
)
from mcmcpp_tpu.parallel.sharded import ShardedEnsembleSampler

__all__ = [
    "make_ladder_mesh",
    "make_walker_mesh",
    "walker_sharding",
    "ShardedEnsembleSampler",
]
