"""Benchmark: forward+adjoint gradient sweeps per second on the CNOT
flagship workload (the BASELINE.json headline metric), on one GPU.

One gradient sweep = value_and_grad of the full multi-initial-condition
objective: forward propagation of all basis initial states over the full
time horizon + discrete-adjoint backward pass + penalty integrals — the
exact per-iteration work of the reference's evalGradF
(optimproblem.cpp:342-538).

Workload: 2-qubit CNOT gate optimization, reference quality-anchor shape
(tests/python/test_example_cnot.py): T=200 ns, ntime=1221, 2 guard levels,
ninit=4 basis states, 2 carrier waves per qubit, all penalties on.

vs_baseline: ratio against a MEASURED 22.0 sweeps/s anchor for the MPI CPU
reference at its maximal parallelization of this configuration (np=4,
comm_init=4 — one rank per basis initial condition; comm_init cannot
exceed ninit=4 here). The reference publishes no absolute numbers and
cannot be built in this image (no PETSc/MPI, no egress), so the anchor is
measured by proxy: this repo's own f64 single-core plain-scan path timed
on the exact flagship config (5.50 sweeps/s), x4 ideal comm_init scaling
granted to the reference. Method + biases (all chosen in the reference's
favor): scripts/perf/reference_anchor.py; measured row in BASELINE.md.

Run:  python bench.py      (one process, one GPU; exits non-zero without)
The last line of output is one JSON record naming the device, the card and
its power limit.
"""

import json
import subprocess
import sys
import time

import numpy as np

# measured anchor: scripts/perf/reference_anchor.py (2026-08-17, 4-core host)
REFERENCE_SWEEPS_PER_S = 22.0


def useful_flops_per_sweep(ntime, N, B, iters):
    """Analytic USEFUL (physics) FLOPs of one gradient sweep — the flop
    count of the unpadded math, not what the padded kernel issues. Model:
    per time step the split/IMR stepper applies the off-diagonal
    Hamiltonian `iters` times in the stage solve plus ~2 more applications
    (RHS assembly + update); each application is a complex (N,N)@(N,B)
    product = 8*N^2*B real flops. The backward pass replays the stages and
    adds a plane-cotangent outer product of the same shape per step:
    total ~= 3x forward. Diagonal rotations, controls and penalties are
    O(N*B) per step — negligible. XLA's cost_analysis cannot be used here:
    it counts a lax.scan body ONCE, not x trip-count.

    At the flagship's N=16 this evaluates to ~0.15 GFLOP/sweep: the CNOT
    workload is bound by latency, not by arithmetic, so its metric is
    sweeps/s."""
    apps = iters + 2
    return 3.0 * ntime * apps * 8.0 * N * N * B


def build_problem(pallas="auto", linsolver=None, linsolve_iters=None):
    import jax.numpy as jnp
    from quandary_tpu.models import gates
    from quandary_tpu.models.hamiltonian import build_standard_model
    from quandary_tpu.problem import Problem, Setup
    from quandary_tpu.utils.splines import ControlSegment, OscillatorControl

    Ne = [2, 2]
    Ng = [2, 2]
    nlevels = [e + g for e, g in zip(Ne, Ng)]
    freq01 = [4.80595, 4.8601]
    selfkerr = [0.2198, 0.2252]
    model = build_standard_model(
        nlevels=nlevels, freq01_ghz=freq01, rotfreq_ghz=freq01,
        selfkerr_ghz=selfkerr, jkl_ghz=[0.005], crosskerr_ghz=[],
    )
    T, ntime = 200.0, 1221
    oscs = tuple(
        OscillatorControl(
            segments=(ControlSegment("spline", nsplines=30, tstart=0.0, tstop=T),),
            carrier_freqs=(0.0, 2 * np.pi * (freq01[1 - k] - freq01[k]),
                           -2 * np.pi * selfkerr[k]),
        ) for k in range(2)
    )
    V = gates.assemble_gate(gates.cnot(), nlevels, Ne, [0.0, 0.0], T)
    setup = Setup(
        model=model, nessential=tuple(Ne), ntime=ntime, dt=T / ntime,
        oscillators=oscs, ground_freqs_radns=tuple(2 * np.pi * f for f in freq01),
        initcond_type="basis", target_type="gate", target_gate_full=V,
        objective_type="Jtrace", gamma_tik=1e-4, gamma_penalty=0.1,
        gamma_penalty_energy=0.1, gamma_penalty_dpdm=0.01,
        dtype=jnp.complex64, linsolve_iters=linsolve_iters or 8,
        linsolver=linsolver or "neumann", pallas=pallas,
    )
    return Problem(setup), setup


def multistart_protocol(E, iters, seed=1234, init_scale=0.03):
    """The SHARED delivered-optimization protocol: E random CNOT starts
    refined by `iters` batched projected-L-BFGS iterations in ONE jit
    (speculative per-candidate line-search scale, 3-iteration classic
    warmup). Used by both the bench (main) and
    scripts/perf/multistart_bench.py so the two cannot drift.

    Returns dict with xb (E, n), fb (E,), tr (iters+1, E), nladder,
    nrejected, warm_wall_s, compile_and_run_s, problem, setup."""
    import jax
    import jax.numpy as jnp
    from quandary_tpu.optim.batched_lbfgs import batched_lbfgsb

    problem, setup = build_problem(pallas="auto", linsolver="split",
                                   linsolve_iters=3)
    ref = jnp.zeros((setup.nparams,), jnp.float32)

    def objective(x):
        J, _ = problem.objective(x, ref)
        return J

    # reference-style bound box (maxctrl ~15 MHz class)
    bound = 15e-3 * 2 * np.pi / np.sqrt(2.0) / 2.0 * 3.0
    lb = -bound * np.ones(setup.nparams, np.float32)
    ub = bound * np.ones(setup.nparams, np.float32)
    rng = np.random.default_rng(seed)
    x0s = jnp.asarray(rng.uniform(-1, 1, (E, setup.nparams)) * init_scale,
                      jnp.float32)
    run = problem._wrap_with_data(
        lambda xs: batched_lbfgsb(objective, jax.grad(objective), xs, lb,
                                  ub, iters=iters, ls_lengths=8,
                                  return_stats=True))
    t0 = time.time()
    xb, fb, tr, stats = run(x0s)
    fb = np.asarray(fb)                      # sync (includes compile)
    compile_and_run = time.time() - t0
    t0 = time.time()
    xb, fb, tr, stats = run(x0s)
    fb = np.asarray(fb)
    warm = time.time() - t0
    return dict(xb=xb, fb=fb, tr=np.asarray(tr),
                nladder=int(stats["ladder_iters"]),
                nrejected=int(stats["rejected"]),
                warm_wall_s=warm, compile_and_run_s=compile_and_run,
                problem=problem, setup=setup)


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main():
    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py needs a GPU; the JAX backend is "
                 f"{jax.default_backend()!r}")
    dev = jax.devices()[0]
    card_line = card()
    print(card_line)

    # split stepper, 3 stage iterations: the diagonally-split stepper
    # integrates the stiff guard-level diagonal exactly and solves only the
    # small off-diagonal remainder, where 3 Neumann iterations leave a
    # truncation of ~2.8e-9 per step (f64 ladder)
    problem, setup = build_problem(linsolver="split", linsolve_iters=3)
    engine = ("fused-triton" if problem.use_pallas else "xla-scan") + "-split"
    vg = problem.build_value_and_grad()
    rng = np.random.default_rng(7)
    params = jnp.asarray(rng.uniform(-1, 1, setup.nparams) * 0.005,
                         dtype=jnp.float32)

    t0 = time.perf_counter()
    (J, _aux), g = vg(params, params)
    jax.block_until_ready(g)
    compile_vg_s = time.perf_counter() - t0

    # single-problem LATENCY: one synchronous value_and_grad per call
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        p = jnp.asarray(rng.uniform(-1, 1, setup.nparams) * 0.005,
                        dtype=jnp.float32)
        (J, _aux), g = vg(p, p)
        float(J)
    single_latency_per_s = n / (time.perf_counter() - t0)

    # E=1 and E=128 sweeps, repetitions scanned inside one jit with a
    # single fetch: the device's gradient-sweep rate at each ensemble size
    sweeps = problem.build_ensemble_sweeps()
    rates = {}
    for E, reps in ((1, 12), (128, 6)):
        Ps = jnp.asarray(rng.uniform(-1, 1, (reps, E, setup.nparams)) * 0.005,
                         dtype=jnp.float32)
        float(sweeps(Ps, params))            # compile + warm
        t0 = time.perf_counter()
        for _ in range(3):
            float(sweeps(Ps, params))
        rates[E] = 3 * reps * E / (time.perf_counter() - t0)

    # delivered optimisation: 128 starts, 60 batched L-BFGS iterations
    ms = multistart_protocol(128, 60)
    warm = ms["warm_wall_s"]

    gflops = useful_flops_per_sweep(setup.ntime, problem.N, problem.ninit,
                                    setup.linsolve_iters) / 1e9
    print(json.dumps({
        "metric": "cnot_gradient_sweeps_per_s",
        "value": rates[128],
        "unit": "sweeps/s",
        "vs_baseline": rates[128] / REFERENCE_SWEEPS_PER_S,
        "ensemble_size": 128,
        "single_problem_sweeps_per_s": rates[1],
        "single_problem_latency_sweeps_per_s": single_latency_per_s,
        "compile_value_and_grad_s": compile_vg_s,
        "delivered_opt_E": 128, "delivered_opt_iters": 60,
        "delivered_opt_wall_s": warm,
        "delivered_opt_grad_sweeps_per_s": 128 * 61 / warm,
        "delivered_opt_best_objective": float(np.min(ms["fb"])),
        "useful_gflops_per_sweep": gflops,
        "engine": engine,
        "card": card_line,
        "peak_bytes_in_use": dev.memory_stats().get("peak_bytes_in_use"),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
