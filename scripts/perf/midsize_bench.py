#!/usr/bin/env python
"""Mid-size CLOSED-system benchmark of the XLA scan engine.

The reference's matrix-free kernels cover every size it supports
(mastereq.cpp:1280-3240, up to 5 oscillators / 20 levels). This probe
measures full gradient sweeps at N = 256, 512 or 1024 (two-oscillator qudit
systems, state-to-state or gate objective, stiff diagonal -> diagonally-
split stepper). The fused GPU kernel does not take these sizes (its
operator stacks must fit one block's shared memory), so the XLA scan runs:

    timeout 1200 python scripts/perf/midsize_bench.py 256 [pure|basis]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np


def build(N, initcond="pure"):
    import jax.numpy as jnp
    from quandary_tpu.models.hamiltonian import build_standard_model
    from quandary_tpu.problem import Setup
    from quandary_tpu.utils.splines import ControlSegment, OscillatorControl

    nlevels = {256: [16, 16], 512: [16, 32], 1024: [32, 32]}[N]
    freq01 = [4.80595, 4.8601]
    model = build_standard_model(
        nlevels=nlevels, freq01_ghz=freq01, rotfreq_ghz=freq01,
        selfkerr_ghz=[0.2198, 0.2252], jkl_ghz=[0.005], crosskerr_ghz=[],
        decay_time=[0.0, 0.0], dephase_time=[0.0, 0.0], lindblad=False)
    T, ntime = 100.0, 1000
    oscs = tuple(
        OscillatorControl(
            segments=(ControlSegment("spline", nsplines=30, tstart=0.0,
                                     tstop=T),),
            carrier_freqs=(0.0,),
        ) for _ in range(2))
    rng = np.random.default_rng(42)
    if initcond == "basis":
        # gate-class workload: all N basis initial states, random target
        # unitary (a Haar-ish QR factor) — the regime the reference's
        # nlevels_4_4_4_4 / spinchain_N8 performance tier exercises
        A = rng.normal(size=(N, N)) + 1j * rng.normal(size=(N, N))
        V, _ = np.linalg.qr(A)
        tgt_kw = dict(target_type="gate", target_gate_full=V)
    else:
        tgt = rng.normal(size=N) + 1j * rng.normal(size=N)
        tgt = tgt / np.linalg.norm(tgt)
        tgt_kw = dict(target_type="state", target_state_full=tgt)
    return Setup(
        model=model, nessential=tuple(nlevels), ntime=ntime, dt=T / ntime,
        oscillators=oscs,
        ground_freqs_radns=tuple(2 * np.pi * f for f in freq01),
        initcond_type=initcond,
        objective_type="Jtrace", gamma_tik=1e-4,
        dtype=jnp.complex64, linsolve_iters=4,
        time_parallel=False, **tgt_kw)


def main(N, initcond="pure"):
    import jax
    import jax.numpy as jnp
    from quandary_tpu.problem import Problem

    problem = Problem(build(N=N, initcond=initcond))
    setup = problem.setup
    vg = problem.build_value_and_grad()
    params = jnp.asarray(np.random.default_rng(1234).uniform(
        -1, 1, setup.nparams) * 0.005, dtype=jnp.float32)

    t0 = time.perf_counter()
    (J, aux), g = vg(params, params)
    _ = float(J)
    compile_s = time.perf_counter() - t0
    n = 5
    t0 = time.perf_counter()
    for i in range(n):
        (J, aux), g = vg(params + 1e-6 * i, params)
        _ = float(J)
    rate = n / (time.perf_counter() - t0)

    # pipelined: reps scanned inside one jit, one fetch (device rate)
    reps = int(os.environ.get("QTPU_BENCH_REPS", "4"))
    Ps = jnp.asarray(np.random.default_rng(7).uniform(
        -1, 1, (reps, 1, setup.nparams)) * 0.005, dtype=jnp.float32)
    freps = problem.build_ensemble_sweeps()
    _ = float(freps(Ps, params))
    t0 = time.perf_counter()
    for _i in range(3):
        _ = float(freps(Ps, params))
    rate_pipe = 3 * reps / (time.perf_counter() - t0)

    print(json.dumps({
        "device": jax.devices()[0].platform, "N": N,
        "ninit": problem.ninit, "linsolver": problem.linsolver,
        "compile_s": round(compile_s, 1),
        "gradient_sweeps_per_s": round(rate, 3),
        "pipelined_sweeps_per_s": round(rate_pipe, 3),
        "J": float(J), "gnorm": float(jnp.linalg.norm(g)),
    }))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 256,
         sys.argv[2] if len(sys.argv) > 2 else "pure")
