"""Device-mesh sharding: the JAX replacement for the reference's
3-way MPI communicator split (main.cpp:133-177).

Axes:
* ``init``    — data parallelism over initial conditions (comm_init). The
  propagation of different initial states is embarrassingly parallel; the
  objective/fidelity/gradient reductions become XLA `psum`s over this axis,
  inserted automatically by GSPMD from the sharding annotations.
* ``hilbert`` — state-dimension parallelism (comm_petsc, the reference's
  MPIAIJ row distribution, mastereq.cpp:192-655). Engine-dependent layout
  (Problem.state_sharding_spec):
    - DenseEngine:   state (B, N) sharded on N; Lindblad (B, N, N) on the
      last axis. The H(t) matmuls become distributed GEMMs.
    - GroupedEngine: flat (B, N) sharded on N = contiguous row blocks of the
      (m1, m2) matricization -> m1 is sharded. The right GEMM X @ H_R^T and
      the diagonal cross-Kerr mask stay fully LOCAL; only the left GEMM
      H_L @ X needs a collective (one all-gather/reduce-scatter of the state
      per RHS application, shared by all left products), riding ICI.
    - TensorEngine:  flat (B, N) sharded on N (round 3): GSPMD propagates
      the sharding through the (B, n1..nQ) reshape to the leading tensor
      factor and inserts the per-axis contractions' collectives.

Additionally the ENSEMBLE/candidate axis — the one carrying the headline
throughput metric — shards via shard_map
(Problem.build_ensemble_{value_and_grad,sweeps}(mesh=...)): each device
runs the full fused-Pallas program on its E/n slice (comm_init analog).

The reference's comm_optim (time parallelism) is stubbed at size 1 there
(main.cpp:140-143); here the associative-scan time-parallel path
(ops/propagator.py) realizes that axis when enabled, and the default time
loop stays sequential (lax.scan), as in the reference.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_init: int, n_hilbert: int = 1, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    need = n_init * n_hilbert
    assert len(devices) >= need, f"need {need} devices, have {len(devices)}"
    dev = np.asarray(devices[:need]).reshape(n_init, n_hilbert)
    return Mesh(dev, axis_names=("init", "hilbert"))


# engine-held big arrays; always replicated (they are O(K N) to O(K N^2)
# operator data, small next to the batched states)
ENGINE_ARRAYS = ("stack", "Ls", "stackL", "stackR", "cross_diag",
                 "crossA", "crossB", "jumpL", "jumpR",
                 "pallas_Sr", "pallas_Si")


def shard_problem(problem, mesh: Mesh, shard_hilbert: bool = False):
    """Configure a Problem for mesh execution and re-place its materialized
    device arrays.

    Sets ``problem.mesh`` / ``problem.shard_hilbert`` — consumed by
    ``Problem._wrap_with_data`` (big threaded arrays get placed with these
    shardings at materialization time) and ``Problem.state_sharding_spec``.
    Also immediately re-places the already-held arrays so that directly
    jitting ``problem.objective`` (closure-captured constants) partitions
    too: jit respects the committed sharding of captured device arrays.
    """
    problem.mesh = mesh
    problem.shard_hilbert = bool(shard_hilbert)
    if shard_hilbert and getattr(problem, "use_pallas", False):
        # the fused kernel is a single-device program; hilbert-axis runs
        # use the XLA engines, which GSPMD partitions
        problem.use_pallas = False

    if jax.process_count() > 1:
        # MULTI-PROCESS (multi-host): a jitted function may not close over
        # arrays spanning non-addressable devices, so the eager global
        # device_puts below are illegal. Keep everything host-side: small
        # arrays embed as by-value constants (legal on every process) and
        # get their mesh placement from the in-trace sharding constraints
        # (Problem._shard_state); big arrays are threaded as arguments with
        # mesh shardings by Problem._wrap_with_data — use the build_*
        # entry points, not a direct jit of problem.objective.
        return problem

    state_spec = problem.state_sharding_spec()
    problem.x0 = jax.device_put(problem.x0, NamedSharding(mesh, state_spec))
    if problem.target is not None:
        tspec = problem.state_sharding_spec(np.ndim(problem.target))
        problem.target = jax.device_put(problem.target,
                                        NamedSharding(mesh, tspec))
    init_spec = NamedSharding(mesh, P("init"))
    problem.weights = jax.device_put(problem.weights, init_spec)
    problem.purity = jax.device_put(problem.purity, init_spec)

    repl = NamedSharding(mesh, P())
    for name in ENGINE_ARRAYS:
        arr = getattr(problem.engine, name, None)
        if arr is not None:
            setattr(problem.engine, name, jax.device_put(arr, repl))
    return problem
