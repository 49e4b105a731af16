#!/usr/bin/env python
"""Measured reference-throughput anchor for bench.py's ``vs_baseline``.

The reference (LLNL/Quandary) publishes no absolute throughput numbers and
cannot be built here (PETSc + MPI are not in the image and there is no
network egress), so the anchor is MEASURED with the methodology below
instead of estimated:

1. Run THIS repo's f64 CPU path — plain ``lax.scan`` IMR with the same
   Neumann inner solve, no Pallas, no ensembling — on the exact flagship
   configuration (bench.py: 2-qubit CNOT, nlevels 4,4, T=200 ns,
   ntime=1221, 30 splines x 3 carriers, all penalties), pinned to ONE core
   (taskset + single-threaded XLA). XLA's compiled CPU code is an
   apples-to-apples stand-in for the reference's compiled C++ matrix-free
   RHS (docs/mkdocs/user_guide.md:361): both are cache-resident compiled
   loops over a 16-complex state, double precision.
2. A gradient sweep covers ninit=4 basis states. The reference runs this
   config with np=4 / comm_init=4 — one initial condition per rank — and
   its docs claim ideal scaling over the init axis
   (user_guide.md:422,433). Anchor = 4 x (single-core 4-init sweep rate),
   i.e. perfect 4-way strong scaling is GRANTED to the reference.

Biases are chosen to favor the reference: f64 (it cannot run f32), ideal
comm_init scaling (real MPI has reduction overhead), and batched B=4
propagation on our side is counted as if it cost the same per-init as
B=1 (batching helps us, the division by 1 sweep = 4 inits already includes
it).

Usage:  taskset -c 0 python scripts/perf/reference_anchor.py
Writes the measured numbers as JSON to stdout; paste the anchor into
bench.py REFERENCE_SWEEPS_PER_S and BASELINE.md.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

# single-threaded XLA CPU before jax import
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"
).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def main():
    from bench import build_problem

    import dataclasses

    from quandary_tpu.problem import Problem

    _, setup = build_problem(pallas=False)
    # double precision, like the reference's PETSc build
    setup_f64 = dataclasses.replace(setup, dtype=jnp.complex128)
    problem_f64 = Problem(setup_f64)

    vg = problem_f64.build_value_and_grad()
    params = jnp.asarray(np.random.default_rng(1234).uniform(
        -1, 1, setup_f64.nparams) * 0.005)

    (J, aux), g = vg(params, params)  # compile
    jax.block_until_ready(g)
    _ = float(J)

    n = 5
    t0 = time.perf_counter()
    for i in range(n):
        (J, aux), g = vg(params + 1e-6 * i, params)
        _ = float(J)
    per_sweep = (time.perf_counter() - t0) / n

    single_core_sweeps = 1.0 / per_sweep
    anchor = 4.0 * single_core_sweeps  # ideal np=4 comm_init scaling granted
    print(json.dumps({
        "single_core_f64_sweeps_per_s": round(single_core_sweeps, 3),
        "reference_anchor_np4_sweeps_per_s": round(anchor, 3),
        "per_sweep_s": round(per_sweep, 4),
        "dtype": str(setup_f64.dtype),
        "cpu_count_visible": os.cpu_count(),
        "method": "this repo's f64 single-core xla-scan sweep x 4 (ideal "
                  "comm_init scaling granted to the reference)",
    }))


if __name__ == "__main__":
    main()
