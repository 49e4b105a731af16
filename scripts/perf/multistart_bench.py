#!/usr/bin/env python
"""On-device multi-start optimization benchmark: E random control starts of
the CNOT flagship refined SIMULTANEOUSLY by the batched projected L-BFGS
(optim/batched_lbfgs.py) — the whole population optimization is ONE jit
call (lax.scan over iterations, speculative per-candidate line-search
scale), so the wall time is pure device time plus a single dispatch.

This is the optimizer counterpart of the ensemble-throughput headline: the
reference optimizes one candidate per TAO process; here a population rides
the same GEMMs. The measurement protocol itself lives in
bench.multistart_protocol (shared with the official bench's
delivered-optimization probe, so the two cannot drift).

    timeout 1800 python scripts/perf/multistart_bench.py [E] [iters]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np


def main(E=16, iters=60):
    import jax
    import jax.numpy as jnp


    from bench import multistart_protocol

    r = multistart_protocol(E, iters)
    warm, tr, fb = r["warm_wall_s"], r["tr"], r["fb"]
    nladder, nrejected = r["nladder"], r["nrejected"]

    # Delivered-throughput accounting: with the SPECULATIVE per-candidate
    # step scale, every post-warmup
    # L-BFGS iteration costs exactly ONE batched value_and_grad; only the
    # `nladder` warmup iterations run the 8-trial backtracking ladder
    # (8 forward programs each, on top of their gradient). A forward eval
    # costs ~1/3 of a gradient sweep, so the conservative aggregate counts
    # gradient sweeps alone and the equivalent adds the ladder work.
    grad_sweeps = E * (iters + 1)
    fwd_evals = E * 8 * nladder
    # time to best-so-far population minimum crossing 1e-3 objective
    best_so_far = np.minimum.accumulate(tr.min(axis=1))
    hit = np.argmax(best_so_far < 1e-3) if (best_so_far < 1e-3).any() else -1
    per_iter = warm / iters

    # infidelity of the best candidate (jitted: eager evaluation would run
    # thousands of tiny dispatches)
    problem = r["problem"]
    obj_c = problem.build_objective()
    (J, aux) = obj_c(jnp.asarray(r["xb"][int(np.argmin(fb))]),
                     jnp.zeros((r["setup"].nparams,), jnp.float32))
    print(json.dumps({
        "device": jax.devices()[0].platform, "E": E, "iters": iters,
        "compile_and_run_s": round(r["compile_and_run_s"], 1),
        "warm_wall_s": round(warm, 1),
        "agg_gradient_sweeps_per_s": round(grad_sweeps / warm, 1),
        "agg_sweep_equiv_per_s": round(
            (grad_sweeps + fwd_evals / 3.0) / warm, 1),
        "ladder_iters": nladder,
        "rejected_cand_iters": nrejected,
        "iters_to_obj_1e-3": int(hit),
        "time_to_obj_1e-3_s": (round(float(hit) * per_iter, 3)
                               if hit >= 0 else None),
        "best_objective": float(np.min(fb)),
        "best_infidelity": float(1.0 - float(aux["fidelity"])),
        "objectives_quartiles": [float(q) for q in
                                 np.percentile(fb, [0, 25, 50, 75, 100])],
    }))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 16,
         int(sys.argv[2]) if len(sys.argv) > 2 else 60)
