"""Fused GPU time-loop kernel (ops/fused_triton.py) against XLA at the CNOT
flagship width (bench.build_problem: N=16, 1221 steps, 4 basis states,
complex64).

For each stage-solve configuration it checks the kernel against the XLA
engine the same Setup runs with pallas=False (the sequential scan, or the
time-parallel propagator where `time_parallel` selects it): J relative,
gradient relative L2. Then it times, in turns (xla, kernel, kernel, xla):
one value_and_grad at E=1, E=1 sweeps pipelined in one jit, and E=128
ensemble sweeps. Compile time is reported apart. Needs a GPU.

    python scripts/perf/fused_vs_scan.py [--quick] [config ...]

configs: split3, jacobi8 (time-parallel propagator on the XLA side),
jacobi8-scan (sequential scan on the XLA side); default all three.
--quick compiles and checks each configuration once and times nothing.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from bench import build_problem  # noqa: E402
from quandary_tpu.problem import Problem  # noqa: E402

CONFIGS = {"split3": ("split", 3, "auto"), "jacobi8": ("jacobi", 8, "auto"),
           "jacobi8-scan": ("jacobi", 8, False)}


def _timed(f, *a):
    t0 = time.perf_counter()
    out = jax.block_until_ready(f(*a))
    return out, time.perf_counter() - t0


def main():
    if jax.default_backend() != "gpu":
        sys.exit(f"needs a GPU; JAX backend is {jax.default_backend()!r}")
    quick = "--quick" in sys.argv
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    rng = np.random.default_rng(7)
    names = [a for a in sys.argv[1:] if not a.startswith("--")] or CONFIGS
    for cfg in names:
        solver, iters, tp = CONFIGS[cfg]
        probs = {}
        for name, flag in (("scan", False), ("fused", True)):
            prob, setup = build_problem(pallas=flag, linsolver=solver,
                                        linsolve_iters=iters)
            if tp != setup.time_parallel:
                prob = Problem(dataclasses.replace(setup, time_parallel=tp))
            probs[name] = (prob, prob.setup)
        setup = probs["scan"][1]
        assert probs["fused"][0].use_pallas and not probs["scan"][0].use_pallas
        n = setup.nparams
        p = jnp.asarray(rng.uniform(-1, 1, n) * 0.005, jnp.float32)
        Ps1 = jnp.asarray(rng.uniform(-1, 1, (12, 1, n)) * 0.005, jnp.float32)
        Ps = jnp.asarray(rng.uniform(-1, 1, (4, 128, n)) * 0.005, jnp.float32)
        fns, res = {}, {}
        for name, (prob, _) in probs.items():
            vg = prob.build_value_and_grad()
            ((J, _), g), t_vg = _timed(vg, p, p)
            rec = {"compile_vg_s": t_vg}
            if not quick:
                sw = prob.build_ensemble_sweeps()
                _, rec["compile_e1_s"] = _timed(sw, Ps1, p)
                _, rec["compile_e128_s"] = _timed(sw, Ps, p)
                fns[name] = (vg, sw)
            res[name] = (float(J), np.asarray(g), rec)
        Js, gs, _ = res["scan"]
        Jf, gf, _ = res["fused"]
        err = {"J_rel": abs(Jf - Js) / abs(Js),
               "grad_rel_l2": float(np.linalg.norm(gf - gs)
                                    / np.linalg.norm(gs))}
        out = {"config": cfg, "solver": solver, "iters": iters,
               "xla_engine": ("time-parallel" if probs["scan"][0].time_parallel
                              else "scan"), **err,
               **{f"{k}_{name}": v for name, r in res.items()
                  for k, v in r[2].items()}}
        if not quick:
            times = {k: [] for k in ("vg_s", "e1_sweeps_per_s",
                                     "e128_sweeps_per_s")}
            samples = {name: {k: [] for k in times} for name in fns}
            for name in ("scan", "fused", "fused", "scan"):
                vg, sw = fns[name]
                for _ in range(5):
                    _, t = _timed(vg, p, p)
                    samples[name]["vg_s"].append(t)
                _, t = _timed(sw, Ps1, p)
                samples[name]["e1_sweeps_per_s"].append(Ps1.shape[0] / t)
                _, t = _timed(sw, Ps, p)
                samples[name]["e128_sweeps_per_s"].append(
                    Ps.shape[0] * Ps.shape[1] / t)
            for name, d in samples.items():
                for k, v in d.items():
                    out[f"{k}_{name}_median"] = float(np.median(v))
                    out[f"{k}_{name}_all"] = v
            out["peak_bytes"] = jax.devices()[0].memory_stats().get(
                "peak_bytes_in_use")
        print(json.dumps(out))


if __name__ == "__main__":
    main()
