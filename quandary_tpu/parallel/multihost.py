"""Multi-host execution helpers.

On a multi-host cluster, JAX runs one process per host; after
`initialize()` every process sees the global device set and the single-
controller programming model applies unchanged: build the mesh over
`jax.devices()` (all hosts), shard the problem, jit — GSPMD partitions
across hosts with ICI collectives inside a slice and DCN across slices.

The host-side optimizer loop (optim/driver.py) runs REPLICATED on every
process over the small design vector — the same strategy as the reference's
replicated TAO state (main.cpp:372-377, design vector is sequential on every
rank) — so no broadcast is needed as long as every process computes
identically (it does: same jitted function, same inputs).

Checklist for an N-host run:

    import quandary_tpu.parallel.multihost as mh
    mh.initialize()                       # once per process, before first op
    mesh = make_mesh(n_init, n_hilbert)   # over the GLOBAL device list
    shard_problem(problem, mesh, ...)
    # per-host input feeding for very large initial-condition batches:
    #   use jax.make_array_from_process_local_data with the same sharding
"""

from __future__ import annotations

from typing import Optional


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize. Clusters JAX detects (e.g. SLURM) need
    no arguments; elsewhere pass coordinator_address (host:port),
    num_processes and process_id."""
    import jax

    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def is_multihost() -> bool:
    import jax

    return jax.process_count() > 1


def sync_global_value(x):
    """Cross-process agreement on a host scalar (e.g. a stopping decision):
    psum over a trivial sharded computation."""
    import jax
    import jax.numpy as jnp

    if jax.process_count() == 1:
        return x
    from jax.experimental import multihost_utils

    return multihost_utils.broadcast_one_to_all(jnp.asarray(x))
