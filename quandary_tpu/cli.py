"""Command-line driver: run a reference-format .cfg end to end.

    python -m quandary_tpu <config.cfg> [--quiet]

Replicates the reference binary's runtype dispatch (main.cpp:400-447) and
output files, so the golden-file regression harness works against this
driver. No MPI — the batch of initial conditions and the state dimension live
on the accelerator; process counts in the reference configs are irrelevant.
"""

from __future__ import annotations

import os
import sys
import time as _time
from typing import List

import numpy as np

from .io import output as out_io
from .io.configfile import Config, RunSpec, setup_from_config
from .optim.driver import OptimHistoryRow, build_bounds, run_optimization
from .problem import Problem, Setup


def _write_trajectories(problem: Problem, setup: Setup, spec: RunSpec,
                        datadir: str, params) -> None:
    import jax.numpy as jnp
    from .ops import solvers as slv

    if not any(o and o != ["none"] for o in spec.outputs):
        return

    traj = np.asarray(problem.build_propagate_trajectory()(jnp.asarray(params)))
    ts = problem.ts_out
    lind = problem.lindblad
    dims = setup.model.dims
    freq = spec.output_frequency
    pop_full = np.asarray(slv.population_full(jnp.asarray(traj), lind))

    want_exp = [("expectedEnergy" in o) for o in spec.outputs]
    want_pop = [("population" in o) for o in spec.outputs]
    want_exp_c = any("expectedEnergyComposite" in o for o in spec.outputs)
    want_pop_c = any("populationComposite" in o for o in spec.outputs)
    want_full = any("fullstate" in o for o in spec.outputs)

    for iosc in range(len(dims)):
        if not (want_exp[iosc] or want_pop[iosc]):
            continue
        import jax.numpy as jnp2
        red = np.asarray(slv.reduced_population(jnp2.asarray(pop_full), dims, iosc))
        lv = np.arange(dims[iosc])
        for b, initid in enumerate(problem.initids):
            if want_exp[iosc]:
                out_io.write_expected_energy(datadir, iosc, initid, ts,
                                             red[:, b, :] @ lv, freq)
            if want_pop[iosc]:
                out_io.write_population(datadir, iosc, initid, ts, red[:, b, :], freq)
    if want_exp_c or want_pop_c:
        import jax.numpy as jnp2
        for b, initid in enumerate(problem.initids):
            if want_exp_c:
                vals = np.asarray(slv.expected_energy_composite(
                    jnp2.asarray(pop_full[:, b]), dims))
                out_io.write_expected_energy(datadir, 0, initid, ts, vals, freq,
                                             composite=True)
            if want_pop_c:
                out_io.write_population(datadir, 0, initid, ts, pop_full[:, b], freq,
                                        composite=True)
    if want_full:
        for b, initid in enumerate(problem.initids):
            out_io.write_fullstate(datadir, initid, ts, traj[:, b], lind, freq)


def _write_controls(problem: Problem, datadir: str, params,
                    output_frequency: int = 1) -> None:
    import jax.numpy as jnp
    ts, p, q, f = problem.controls_on_output_grid(jnp.asarray(params))
    out_io.write_controls(datadir, ts, p, q, f, output_frequency)


def run(config_path: str, quiet: bool = True, datadir_override: str = None) -> dict:
    t_start = _time.time()
    workdir = os.path.dirname(os.path.abspath(config_path)) or "."
    cfg = Config.read(config_path)
    setup, spec = setup_from_config(cfg, workdir)
    datadir = datadir_override or spec.datadir
    if not os.path.isabs(datadir):
        datadir = os.path.join(workdir, datadir)
    os.makedirs(datadir, exist_ok=True)

    import jax.numpy as jnp
    problem = Problem(setup)
    params0 = spec.params0
    runtype = spec.runtype

    # config_log.dat: record of all consumed configuration values
    # (main.cpp:382-393 / config.hpp:141 export_param)
    out_io.write_config_log(os.path.join(datadir, "config_log.dat"),
                            sorted(cfg.items()))

    result = {"runtype": runtype, "datadir": datadir}

    if runtype in ("simulation", "gradient"):
        _write_controls(problem, datadir, params0, spec.output_frequency)
        out_io.write_params(os.path.join(datadir, "params.dat"), params0)
        gnorm = 0.0
        if runtype == "gradient":
            vg = problem.build_value_and_grad()
            (J, aux), g = vg(jnp.asarray(params0), jnp.asarray(params0))
            g = np.asarray(g)
            gnorm = float(np.linalg.norm(g))
            out_io.write_gradient(os.path.join(datadir, "grad.dat"), g)
            result["gradient"] = g
        else:
            obj = problem.build_objective()
            J, aux = obj(jnp.asarray(params0), jnp.asarray(params0))
        row = OptimHistoryRow(
            iter=0, objective=float(J), gnorm=gnorm, step=0.0,
            fidelity=float(aux["fidelity"]), cost=float(aux["obj_cost"]),
            tikhonov=float(aux["obj_regul"]), penalty=float(aux["obj_penal"]),
            penalty_dpdm=float(aux["obj_penal_dpdm"]),
            penalty_energy=float(aux["obj_penal_energy"]),
            penalty_variation=float(aux["obj_penal_variation"]))
        out_io.write_optim_history(os.path.join(datadir, "optim_history.dat"), [row])
        _write_trajectories(problem, setup, spec, datadir, params0)
        result["objective"] = float(J)
        result["fidelity"] = float(aux["fidelity"])

    elif runtype == "optimization":
        _write_controls(problem, datadir, params0, spec.output_frequency)
        # durable run: optim_history.dat streamed row-by-row, params.dat +
        # control<k>.dat + optim_state.npz rewritten every monitor interval
        # (driver.run_optimization); a killed run resumes from the
        # checkpoint via resume=True.
        from .backend import optimizer_driver
        use_device = optimizer_driver(spec.optim_driver) == "device"
        driver_kw = dict(
            maxiter=spec.maxiter, gatol=spec.gatol, grtol=spec.grtol,
            fatol=spec.fatol, inftol=spec.inftol,
            monitor_freq=spec.optim_monitor_freq, verbose=not quiet,
            datadir=datadir, output_frequency=spec.output_frequency)
        bounds = build_bounds(setup.oscillators, spec.control_bounds)
        if use_device:
            from .optim.device_driver import run_optimization_device
            res = run_optimization_device(problem, params0, *bounds,
                                          **driver_kw)
        else:
            res = run_optimization(problem, params0, *bounds,
                                   resume=spec.warmstart, **driver_kw)
        out_io.write_params(os.path.join(datadir, "params.dat"), res.params)
        _write_controls(problem, datadir, res.params, spec.output_frequency)
        _write_trajectories(problem, setup, spec, datadir, res.params)
        result["objective"] = res.objective
        result["infidelity"] = res.infidelity
        result["params"] = res.params

    elif runtype == "evalcontrols":
        out_io.write_params(os.path.join(datadir, "params.dat"), params0)
        _write_controls(problem, datadir, params0, spec.output_frequency)
    else:
        raise ValueError(f"unknown runtype {runtype}")

    used = _time.time() - t_start
    with open(os.path.join(datadir, "timing.dat"), "w") as f:
        f.write("%d  %1.8e\n" % (1, used))
    if not quiet:
        print(f" Used Time: {used:.2f} seconds")
    return result


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    quiet = "--quiet" in argv
    paths = [a for a in argv if not a.startswith("--")]
    if not paths:
        print("usage: python -m quandary_tpu <config.cfg> [--quiet]")
        return 1
    run(paths[0], quiet=quiet)
    return 0


if __name__ == "__main__":
    sys.exit(main())
