"""Single-problem (E=1) latency race on the flagship CNOT gradient sweep:
the fused GPU kernel (ops/fused_triton.py, sequential in time inside one
program) vs the time-parallel associative-scan propagator path
(ops/propagator.py) vs the plain lax.scan engine.

The time-parallel path replaces the 2*ntime-step chain with O(log ntime)
rounds of (ntime, N, N) batched GEMMs — the comm_optim axis the reference
stubs out (main.cpp:140-143), actually exercised. The fused kernel needs a
GPU.

Usage: python scripts/perf/e1_latency_bench.py [reps] [timed_calls] [engines]
engines: comma list of fused,tp,scan (default all)
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def measure(problem, setup, reps, n_timed):
    assert n_timed >= 1, "need at least one timed call"
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    Ps = jnp.asarray(rng.uniform(-1, 1, (reps, 1, setup.nparams)) * 0.005,
                     dtype=jnp.float32)
    params = jnp.zeros((setup.nparams,), jnp.float32)
    f = problem.build_ensemble_sweeps()
    t0 = time.perf_counter()
    _ = float(f(Ps, params))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n_timed):
        acc = float(f(Ps, params))
    dt = time.perf_counter() - t0
    return n_timed * reps / dt, compile_s, acc


def main(reps=64, n_timed=3, engines=("fused", "tp", "scan")):
    import dataclasses

    import jax

    from bench import build_problem
    from quandary_tpu.problem import Problem

    rows = []
    if "fused" in engines:
        # 1) fused GPU kernel, split stepper (the headline config)
        p, s = build_problem(pallas=True, linsolver="split", linsolve_iters=3)
        rate, comp, acc = measure(p, s, reps, n_timed)
        rows.append({"engine": "fused-triton-split3",
                     "sweeps_per_s": round(rate, 1),
                     "compile_s": round(comp, 1), "acc": acc})
        print(rows[-1], flush=True)

    # 2) time-parallel propagators (jacobi stage solve, reference-grade
    #    accuracy at iters=8)
    if "tp" in engines:
        p, s = build_problem(pallas=False, linsolver="jacobi",
                             linsolve_iters=8)
        s2 = dataclasses.replace(p.setup, time_parallel=True)
        p = Problem(s2)
        assert p.time_parallel, "time-parallel path not active"
        rate, comp, acc = measure(p, s, reps, n_timed)
        rows.append({"engine": "time-parallel-jacobi8",
                     "sweeps_per_s": round(rate, 1),
                     "compile_s": round(comp, 1), "acc": acc})
        print(rows[-1], flush=True)

    # 3) plain sequential scan, same solver
    if "scan" in engines:
        p, s = build_problem(pallas=False, linsolver="jacobi",
                             linsolve_iters=8)
        s3 = dataclasses.replace(p.setup, time_parallel=False)
        p = Problem(s3)
        assert not p.time_parallel and not p.use_pallas
        rate, comp, acc = measure(p, s, reps, n_timed)
        rows.append({"engine": "xla-scan-jacobi8",
                     "sweeps_per_s": round(rate, 1),
                     "compile_s": round(comp, 1), "acc": acc})
        print(rows[-1], flush=True)

    import jax
    print(json.dumps({"device": jax.devices()[0].platform, "E": 1,
                      "reps": reps, "rows": rows}))


if __name__ == "__main__":
    a = sys.argv[1:]
    main(int(a[0]) if a else 64, int(a[1]) if len(a) > 1 else 3,
         tuple(a[2].split(",")) if len(a) > 2 else ("fused", "tp", "scan"))
