"""ShardedEnsembleSampler — the multi-chip ensemble driver.

Equivalent in capability to ``MCMCpp/ParallelEnsembleSampler.h:78-357``
(same public surface as the sequential sampler) but with NONE of its
machinery: no worker pool (ctor threads, :228-262), no controller state
machine (``Threading/RedBlkCtrler*.h``), no spin/mutex barrier flavors, and
no sampler-wide mutex. The SAME pure step function used single-chip is
jitted over a :class:`jax.sharding.Mesh` with the walker axis sharded;
GSPMD partitioning supplies what the pthread runtime hand-built:

- red/black phase barriers  → collective boundaries in the XLA program
- complementary-set access  → all-gather of the opposite half
- acceptance counters       → all-reduce (psum)
- per-thread pcg64 streams  → partitionable threefry (bitwise identical
  results at ANY device count — the reference's threaded sampler is
  explicitly non-deterministic, ParallelEnsembleSampler.h:71-76)
"""

import numpy as np
import jax
import jax.numpy as jnp

from mcmcpp_tpu.sampler import EnsembleSampler, EnsembleState, init_state
from mcmcpp_tpu.parallel.mesh import make_walker_mesh, walker_sharding, replicated


def constrain_state(state: EnsembleState, half_sharding, rep) -> EnsembleState:
    """Pin ensemble halves to the walker sharding, scalars replicated."""
    from mcmcpp_tpu.parallel.mesh import vector_sharding

    vec_sharding = vector_sharding(half_sharding)
    c = lambda x: jax.lax.with_sharding_constraint(x, half_sharding)
    v = lambda x: jax.lax.with_sharding_constraint(x, vec_sharding)
    r = lambda x: jax.lax.with_sharding_constraint(x, rep)
    return EnsembleState(
        red=c(state.red),
        black=c(state.black),
        logp_red=v(state.logp_red),
        logp_black=v(state.logp_black),
        # per-walker counters shard like the logp vectors — the hot loop's
        # counter update is purely local (no collective per step)
        accepted_red=v(state.accepted_red),
        accepted_black=v(state.accepted_black),
        step=r(state.step),
    )


class ShardedEnsembleSampler(EnsembleSampler):
    """EnsembleSampler whose walker axis is sharded over a device mesh.

    Everything about the API is inherited; only data placement changes.
    ``n_walkers/2`` must divide evenly by the mesh size so each device owns
    an equal static shard (the uniform-cost analogue of the reference's
    dynamic work stealing, RedBlkCtrlerSpinLock.h:119).
    """

    def __init__(self, *args, mesh=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.mesh = mesh if mesh is not None else make_walker_mesh()
        n_dev = self.mesh.size
        if (self.n_walkers // 2) % n_dev != 0:
            raise ValueError(
                f"n_walkers/2 = {self.n_walkers // 2} must be divisible by "
                f"mesh size {n_dev}"
            )
        self._half_sharding = walker_sharding(self.mesh)
        self._rep = replicated(self.mesh)
        self._rebuild_step_fn()

    def _rebuild_step_fn(self):
        super()._rebuild_step_fn()
        # mesh attributes exist only after __init__ progresses past the
        # parent constructor's first build
        if not hasattr(self, "_half_sharding"):
            return
        base_step = self._step_fn

        def sharded_step(state):
            return constrain_state(
                base_step(constrain_state(state, self._half_sharding, self._rep)),
                self._half_sharding,
                self._rep,
            )

        self._step_fn = sharded_step

    def set_initial_walker_pos(self, positions):
        positions = jnp.asarray(positions, self.dtype)
        if positions.shape != (self.n_walkers, self.n_params):
            raise ValueError(
                f"positions shape {positions.shape} != "
                f"({self.n_walkers}, {self.n_params})"
            )
        half = self.n_walkers // 2
        red = jax.device_put(positions[:half], self._half_sharding)
        black = jax.device_put(positions[half:], self._half_sharding)
        stacked = jnp.concatenate([red, black], axis=0)
        self.state = init_state(stacked, self._batched_logp)
        self.state = jax.jit(
            lambda s: constrain_state(s, self._half_sharding, self._rep)
        )(self.state)
        return self
