"""Smoke test of the main path on an NVIDIA GPU, through the entry points a
user calls, each workload compared with its plain reference.

    python chip_smoke.py           # one card, three workloads
    python chip_smoke.py --four    # four cards: the sharded paths only

One card:
  1. closed CNOT with guard levels (the flagship: nlevels 4,4, N=16,
     T=200 ns, 1221 steps, 4 basis states, all penalties, complex64):
     `Quandary(...).optimize()` for 10 L-BFGS iterations; value_and_grad
     and the E=128 ensemble gradient through `Problem`, against the same
     Setup on the host CPU (XLA scan engine);
  2. open CNOT under T1/T2 (same system, superoperator dimension 256,
     complex64): one value_and_grad against the host CPU;
  3. the upstream performance-suite register (nlevels 32,32,32,32,
     N = 2^20, 50 steps) through the .cfg CLI with runtype = gradient in
     complex128: norm drift over the 50 steps and a directional
     finite-difference check of the gradient.
Four cards (--four):
  the E=128 ensemble sweep sharded over 4 cards (make_mesh(4, 1)) and the
  2^20 register's gradient with its Hilbert axis sharded (make_mesh(1, 4)),
  each against one card.

Every phase prints what ran, its errors against their tolerances, wall time
with compile time apart, and peak device memory. The last line is one JSON
object naming the device; it is printed only if every phase passed. Without
a GPU the script exits non-zero before any phase.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORKDIR = os.path.join(HERE, "run_dir_smoke")

# complex64 against the CPU reference; complex128 checks of the register
TOL_J_C64, TOL_G_C64 = 1e-5, 1e-4
TOL_ENSEMBLE_SHARDED = 1e-5      # f32 sums in another order across cards
TOL_NORM_DRIFT_C128 = 1e-8       # |  ||psi(T)|| - 1 | over 50 steps
TOL_FD_C128 = 1e-5               # directional finite difference, relative
TOL_REGISTER_SHARDED = 1e-10     # complex128, Hilbert-sharded vs one card

failures = []


def log(phase, **fields):
    print(f"[{phase}] " + json.dumps(fields, default=float), flush=True)


def check(phase, name, value, tol):
    ok = bool(value <= tol)
    log(phase, check=name, value=float(value), tol=tol, ok=ok)
    if not ok:
        failures.append(f"{phase}: {name} = {value:.3e} > {tol:.1e}")


def rel(a, b):
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}     # None on a CPU
    return stats.get("peak_bytes_in_use")


def timed(f, *args):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(f(*args))
    return out, time.perf_counter() - t0


def twice(f, *args):
    """First call (compile + run) and second call (run): returns the
    output, the run time and the compile time (first minus second)."""
    _, t1 = timed(f, *args)
    out, t2 = timed(f, *args)
    return out, t2, max(t1 - t2, 0.0)


def on_cpu(build, *args):
    """Build and run a reference function on the host CPU."""
    import jax
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        return jax.block_until_ready(build()(*jax.device_put(args, cpu)))


def cnot_setup(lindblad=False):
    from bench import build_problem
    _, setup = build_problem(pallas=False, linsolver="split",
                             linsolve_iters=3)
    if not lindblad:
        return setup
    from quandary_tpu.models.hamiltonian import build_standard_model
    model = build_standard_model(
        nlevels=[4, 4], freq01_ghz=[4.80595, 4.8601],
        rotfreq_ghz=[4.80595, 4.8601], selfkerr_ghz=[0.2198, 0.2252],
        jkl_ghz=[0.005], crosskerr_ghz=[], decay_time=[56.0, 62.0],
        dephase_time=[28.0, 31.0], lindblad=True)
    return dataclasses.replace(setup, model=model, gamma_penalty_dpdm=0.0)


def phase_closed_cnot():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from quandary_tpu import Quandary
    from quandary_tpu.models import gates
    from quandary_tpu.problem import Problem

    ph = "closed-cnot"
    # 1a. the API's optimiser on the GPU (device driver, fused kernel)
    f01, kerr = [4.80595, 4.8601], [0.2198, 0.2252]
    q = Quandary(Ne=[2, 2], Ng=[2, 2], freq01=f01, selfkerr=kerr,
                 Jkl=[0.005], rotfreq=f01, T=200.0, dT=200.0 / 1221,
                 carrier_frequency=[[0.0, f01[1 - k] - f01[k], -kerr[k]]
                                    for k in range(2)],
                 targetgate=gates.cnot().tolist(), precision="single",
                 maxiter=10, rand_seed=1234, verbose=False)
    t0 = time.perf_counter()
    q.optimize(datadir=os.path.join(WORKDIR, "cnot_opt"))
    wall = time.perf_counter() - t0
    cost = np.asarray(q.optim_hist["Cost"])
    log(ph, step="Quandary.optimize", N=16, nsteps=q.nsteps,
        dtype="complex64", iterations=int(len(cost) - 1),
        cost_first=cost[0], cost_last=cost[-1], wall_s=wall,
        peak_bytes=peak_bytes())
    if not (np.all(np.isfinite(cost)) and cost[-1] < cost[0]):
        failures.append(f"{ph}: optimisation made no progress {cost}")

    # 1b. value_and_grad and the E=128 ensemble through Problem, GPU vs CPU
    setup = cnot_setup()
    gpu = Problem(dataclasses.replace(setup, pallas="auto"))
    ref = Problem(setup)
    rng = np.random.default_rng(7)
    n = setup.nparams
    p = jnp.asarray(rng.uniform(-1, 1, n) * 0.005, jnp.float32)
    vg = gpu.build_value_and_grad()
    ((J, _), g), t_run, t_comp = twice(vg, p, p)
    (Jr, _), gr = on_cpu(ref.build_value_and_grad, p, p)
    log(ph, step="value_and_grad", engine="fused-triton" if gpu.use_pallas
        else "xla-scan", solver=gpu.linsolver, E=1, run_s=t_run,
        compile_s=t_comp, peak_bytes=peak_bytes())
    check(ph, "J_rel_vs_cpu", abs(float(J) - float(Jr)) / abs(float(Jr)),
          TOL_J_C64)
    check(ph, "grad_rel_l2_vs_cpu", rel(g, gr), TOL_G_C64)

    E = 128
    Ps = jnp.asarray(rng.uniform(-1, 1, (E, n)) * 0.005, jnp.float32)
    evg = gpu.build_ensemble_value_and_grad()
    ((Je, _), ge), t_run, t_comp = twice(evg, Ps, p)
    (Jer, _), ger = on_cpu(ref.build_ensemble_value_and_grad, Ps, p)
    sweeps = gpu.build_ensemble_sweeps()
    reps = jnp.stack([Ps] * 4)
    _, t_sw, t_swc = twice(sweeps, reps, p)
    log(ph, step="ensemble value_and_grad", E=E, run_s=t_run,
        compile_s=t_comp, sweeps_per_s=4 * E / t_sw, sweeps_compile_s=t_swc,
        peak_bytes=peak_bytes())
    check(ph, "ensemble_J_max_rel_vs_cpu",
          float(np.max(np.abs(np.asarray(Je) - np.asarray(Jer))
                       / np.abs(np.asarray(Jer)))), TOL_J_C64)
    check(ph, "ensemble_grad_rel_l2_vs_cpu", rel(ge, ger), TOL_G_C64)


def phase_open_cnot():
    import jax.numpy as jnp
    import numpy as np
    from quandary_tpu.problem import Problem

    ph = "open-cnot"
    setup = cnot_setup(lindblad=True)
    gpu = Problem(dataclasses.replace(setup, pallas="auto"))
    ref = Problem(setup)
    n = setup.nparams
    p = jnp.asarray(np.random.default_rng(8).uniform(-1, 1, n) * 0.005,
                    jnp.float32)
    ((J, _), g), t_run, t_comp = twice(gpu.build_value_and_grad(), p, p)
    (Jr, _), gr = on_cpu(ref.build_value_and_grad, p, p)
    log(ph, step="value_and_grad", superop_dim=gpu.N ** 2, dtype="complex64",
        engine="fused-triton" if gpu.use_pallas else "xla-scan",
        solver=gpu.linsolver, run_s=t_run, compile_s=t_comp,
        peak_bytes=peak_bytes())
    check(ph, "J_rel_vs_cpu", abs(float(J) - float(Jr)) / abs(float(Jr)),
          TOL_J_C64)
    check(ph, "grad_rel_l2_vs_cpu", rel(g, gr), TOL_G_C64)


def register_cfg():
    """A copy of the performance-suite cfg with runtype = gradient."""
    src = os.path.join(HERE, "scripts", "perf", "nlevels_32_32_32_32.cfg")
    os.makedirs(WORKDIR, exist_ok=True)
    dst = os.path.join(WORKDIR, "nlevels_32_32_32_32_gradient.cfg")
    with open(src) as f:
        lines = [ln for ln in f if not ln.replace(" ", "").startswith(
            ("runtype=", "datadir="))]
    with open(dst, "w") as f:
        f.writelines(lines + ["runtype = gradient\n",
                              "datadir = ./register_out\n"])
    return dst


def register_problem(cfg_path):
    import jax.numpy as jnp
    from quandary_tpu.io.configfile import Config, setup_from_config
    from quandary_tpu.problem import Problem
    setup, spec = setup_from_config(Config.read(cfg_path), WORKDIR)
    setup = dataclasses.replace(setup, dtype=jnp.complex128)
    return Problem(setup), setup, spec


def phase_register():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from quandary_tpu import cli

    ph = "register-2^20"
    jax.config.update("jax_enable_x64", True)
    cfg = register_cfg()
    t0 = time.perf_counter()
    res = cli.run(cfg, quiet=True)
    wall = time.perf_counter() - t0
    g = np.asarray(res["gradient"])
    prob, setup, spec = register_problem(cfg)
    log(ph, step="cli gradient", N=prob.N, ntime=setup.ntime,
        engine=type(prob.engine).__name__, solver=prob.linsolver,
        dtype="complex128", objective=res["objective"], wall_s=wall,
        peak_bytes=peak_bytes())
    if not (np.isfinite(res["objective"]) and np.all(np.isfinite(g))):
        failures.append(f"{ph}: non-finite objective or gradient")

    p0 = jnp.asarray(spec.params0, jnp.float64)
    xT, t_run, t_comp = twice(prob.build_propagate_final(), p0)
    drift = float(np.max(np.abs(np.linalg.norm(
        np.asarray(xT).reshape(xT.shape[0], -1), axis=1) - 1.0)))
    log(ph, step="forward", run_s=t_run, compile_s=t_comp,
        peak_bytes=peak_bytes())
    check(ph, "norm_drift_50_steps", drift, TOL_NORM_DRIFT_C128)

    obj = prob.build_objective()
    d = g / np.linalg.norm(g)       # along the gradient: the largest signal
    eps = 1e-4 * float(np.max(np.abs(spec.params0)))
    Jp = float(obj(p0 + eps * d, p0)[0])
    Jm = float(obj(p0 - eps * d, p0)[0])
    fd = (Jp - Jm) / (2 * eps)
    ad = float(g @ d)
    log(ph, step="directional FD", eps=eps, fd=fd, adjoint=ad)
    check(ph, "fd_rel_error", abs(fd - ad) / max(abs(fd), 1e-300),
          TOL_FD_C128)


def phase_four():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from quandary_tpu.parallel.mesh import make_mesh, shard_problem
    from quandary_tpu.problem import Problem

    if len(jax.devices()) < 4:
        sys.exit(f"--four needs 4 GPUs, found {len(jax.devices())}")
    ph = "four-ensemble"
    setup = cnot_setup()
    prob = Problem(dataclasses.replace(setup, pallas="auto"))
    rng = np.random.default_rng(7)
    n = setup.nparams
    p = jnp.asarray(rng.uniform(-1, 1, n) * 0.005, jnp.float32)
    Ps = jnp.asarray(rng.uniform(-1, 1, (4, 128, n)) * 0.005, jnp.float32)
    one, t1, c1 = twice(prob.build_ensemble_sweeps(), Ps, p)
    mesh = make_mesh(4, 1)
    with mesh:
        four, t4, c4 = twice(prob.build_ensemble_sweeps(mesh=mesh), Ps, p)
        (J4, _), g4 = prob.build_ensemble_value_and_grad(mesh=mesh)(Ps[0], p)
    (J1, _), g1 = prob.build_ensemble_value_and_grad()(Ps[0], p)
    log(ph, E=128, engine="fused-triton" if prob.use_pallas else "xla-scan",
        one_card_sweeps_per_s=4 * 128 / t1, four_card_sweeps_per_s=4 * 128 / t4,
        compile_one_s=c1, compile_four_s=c4, peak_bytes=peak_bytes())
    check(ph, "sweeps_scalar_rel", abs(float(four) - float(one))
          / abs(float(one)), TOL_ENSEMBLE_SHARDED)
    check(ph, "J_rel", rel(J4, J1), TOL_ENSEMBLE_SHARDED)
    check(ph, "grad_rel_l2", rel(g4, g1), TOL_ENSEMBLE_SHARDED)

    ph = "four-register"
    jax.config.update("jax_enable_x64", True)
    cfg = register_cfg()
    prob1, setup, spec = register_problem(cfg)
    p0 = jnp.asarray(spec.params0, jnp.float64)
    ((J1, _), g1), t1, c1 = twice(prob1.build_value_and_grad(), p0, p0)
    prob4, _, _ = register_problem(cfg)
    mesh = make_mesh(1, 4)
    shard_problem(prob4, mesh, shard_hilbert=True)
    with mesh:
        ((J4, _), g4), t4, c4 = twice(prob4.build_value_and_grad(), p0, p0)
    log(ph, N=prob1.N, dtype="complex128", one_card_s=t1, four_card_s=t4,
        compile_one_s=c1, compile_four_s=c4, peak_bytes=peak_bytes())
    check(ph, "J_rel", abs(float(J4) - float(J1)) / abs(float(J1)),
          TOL_REGISTER_SHARDED)
    check(ph, "grad_rel_l2", rel(g4, g1), TOL_REGISTER_SHARDED)


def main():
    four = "--four" in sys.argv[1:]
    # the CPU backend hosts the references; keep it beside the GPU
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax
    if jax.default_backend() != "gpu":
        sys.exit(f"chip_smoke.py needs a GPU; the JAX backend is "
                 f"{jax.default_backend()!r}")
    sys.path.insert(0, HERE)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    shutil.rmtree(WORKDIR, ignore_errors=True)
    if four:
        phase_four()
    else:
        phase_closed_cnot()
        phase_open_cnot()
        phase_register()
    print(card)
    if failures:
        sys.exit("FAILED: " + "; ".join(failures))
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
