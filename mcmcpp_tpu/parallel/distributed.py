"""Multi-host initialization helpers.

The reference is single-process pthreads (SURVEY.md §5: no distributed
backend). Here multi-host runs are standard JAX SPMD: every host runs the
same program, ``initialize()`` wires them into one runtime, and the
samplers' walker mesh (``make_walker_mesh``) spans all devices — its
``hosts`` axis crosses the network, ``devices`` stays within a host.
Collectives inserted
by GSPMD (complementary-half gathers, acceptance psums) then ride the
correct fabric automatically.

Usage on each host::

    from mcmcpp_tpu.parallel import distributed
    distributed.initialize()     # SLURM / Open MPI / Kubernetes: discovered
    s = ShardedEnsembleSampler(logp, n_walkers=2**22, n_params=P)
    ...

Chain storage note: ``Chain`` holds only addressable (per-host) shards when
fetched under multi-host; use ``process_allgather`` (below) or write
per-host files via ``mcmcpp_tpu.io`` with a host-indexed name.
"""

import jax
import numpy as np


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               **kwargs):
    """Wire this process into the multi-host runtime.

    Under the cluster environments ``jax.distributed.initialize``
    detects (SLURM, Open MPI, Kubernetes, ...) all arguments are
    discovered (just call ``initialize()``); elsewhere pass
    coordinator/num/id explicitly (mirrors
    ``jax.distributed.initialize``). No-op if already
    initialized.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            **kwargs,
        )
    except RuntimeError as e:  # already initialized — keep idempotent
        if "already" not in str(e).lower():
            raise
    return jax.process_index(), jax.process_count()


def process_allgather(array):
    """Gather a walker-sharded array's global value onto every host (NumPy).

    Small results only (posterior summaries, acceptance stats) — chains
    should stay sharded / be written per-host.
    """
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(array))


def is_multihost():
    return jax.process_count() > 1
