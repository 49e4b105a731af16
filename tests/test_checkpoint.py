"""Optimizer durability: streamed optim_history.dat, periodic params.dat /
control<k>.dat rewrites, L-BFGS state checkpointing, and kill-and-resume
(reference anchors: writeOptimFile streaming
output.cpp:80-86; params/controls at monitor points optimproblem.cpp:573,646;
params-only warm start via control_initialization = file,
optimproblem.cpp:167-175 — our optim_state.npz additionally restores the
curvature memory, so a resumed run continues the EXACT uninterrupted
trajectory)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, ".")

from quandary_tpu.optim.driver import run_optimization


def _small_problem():
    from __graft_entry__ import _build_problem
    prob, setup = _build_problem(ntime=12, T=2.0, dtype=jnp.complex128)
    rng = np.random.default_rng(42)
    params0 = rng.normal(size=setup.nparams) * 0.02
    lb = np.full(setup.nparams, -1.0)
    ub = np.full(setup.nparams, 1.0)
    return prob, params0, lb, ub


def _read_history(path):
    return np.atleast_2d(np.loadtxt(path))


def test_kill_and_resume_reproduces_uninterrupted_run(tmp_path):
    prob, params0, lb, ub = _small_problem()
    kw = dict(maxiter=8, gatol=1e-14, grtol=1e-30, inftol=1e-12,
              fatol=1e-14, monitor_freq=2, verbose=False)

    # A: uninterrupted
    dA = str(tmp_path / "A")
    resA = run_optimization(prob, params0, lb, ub, datadir=dA, **kw)

    # B: killed after 3 iterations (checkpoint_every = monitor_freq = 2,
    # so the last durable state is the global iterate it=2), then resumed
    dB = str(tmp_path / "B")
    kwB = dict(kw, maxiter=3)
    run_optimization(prob, params0, lb, ub, datadir=dB, **kwB)
    for fname in ("optim_state.npz", "optim_history.dat", "params.dat",
                  "control0.dat", "control1.dat"):
        assert os.path.exists(os.path.join(dB, fname)), fname

    kwR = dict(kw, maxiter=6)
    resB = run_optimization(prob, params0, lb, ub, datadir=dB, resume=True,
                            **kwR)

    # the resumed trajectory ends at the SAME iterate as the uninterrupted
    # run (curvature memory restored -> identical L-BFGS directions)
    np.testing.assert_allclose(resB.params, resA.params, rtol=1e-12,
                               atol=1e-14)
    assert abs(resB.objective - resA.objective) < 1e-12

    # iteration numbering continued across the restart
    assert resB.history[0].iter == 2
    assert resB.history[-1].iter == resA.history[-1].iter == 8

    # the history FILE contains the union of both segments' monitored rows,
    # with matching values against the uninterrupted run at each iter
    hA = _read_history(os.path.join(dA, "optim_history.dat"))
    hB = _read_history(os.path.join(dB, "optim_history.dat"))
    rowsA = {int(r[0]): r for r in hA}
    rowsB = {int(r[0]): r for r in hB}
    assert set(rowsA) == {0, 2, 4, 6, 8}
    # B additionally carries iter 3 — the last completed iterate of the
    # killed segment (its lastIter write); every monitored iter is present
    assert set(rowsA) <= set(rowsB)
    for it in rowsA:
        np.testing.assert_allclose(rowsB[it], rowsA[it], rtol=1e-10,
                                   atol=1e-14, err_msg=f"iter {it}")


def test_intermediate_files_track_current_iterate(tmp_path):
    """params.dat is rewritten at every monitor interval with the CURRENT
    iterate (crash safety), not only at convergence."""
    prob, params0, lb, ub = _small_problem()
    d = str(tmp_path / "out")

    seen = []

    real_write = None

    from quandary_tpu.io import output as out_io
    real_write = out_io.write_params

    def spy(path, params):
        real_write(path, params)
        if path.endswith("params.dat"):
            seen.append(np.asarray(params).copy())

    out_io.write_params = spy
    try:
        run_optimization(prob, params0, lb, ub, maxiter=4, monitor_freq=2,
                         gatol=1e-14, grtol=1e-30, inftol=1e-12,
                         fatol=1e-14, verbose=False, datadir=d)
    finally:
        out_io.write_params = real_write

    assert len(seen) >= 2
    # successive snapshots differ (the optimizer moved between writes)
    assert np.abs(seen[0] - seen[-1]).max() > 0
    # the final file holds the final iterate
    final = np.loadtxt(os.path.join(d, "params.dat"))
    np.testing.assert_allclose(final, seen[-1], rtol=0, atol=1e-15)


def test_cli_resume_via_config(tmp_path):
    """End-to-end CLI: a run killed at maxiter, restarted with
    optim_resume = true, appends to optim_history.dat and continues from
    the checkpointed state."""
    from quandary_tpu.cli import run as cli_run

    cfg = """
nlevels = 2, 2
nessential = 2, 2
ntime = 20
dt = 0.1
transfreq = 4.10595, 4.81
rotfreq = 4.10595, 4.81
selfkerr = 0.2198, 0.2252
Jkl = 0.005
carrier_frequency0 = 0.0
carrier_frequency1 = 0.0
control_segments0 = spline, 5
control_segments1 = spline, 5
control_initialization0 = constant, 0.002
control_initialization1 = constant, 0.002
control_bounds0 = 0.008
control_bounds1 = 0.008
initialcondition = basis
optim_target = gate, cnot
optim_objective = Jtrace
gamma_tik0 = 1e-4
optim_maxiter = {maxiter}
optim_atol = 1e-14
optim_rtol = 1e-30
optim_ftol = 1e-14
optim_inftol = 1e-12
optim_monitor_frequency = 2
optim_resume = {resume}
datadir = {datadir}
runtype = optimization
"""
    dfull = str(tmp_path / "full")
    pfull = tmp_path / "full.cfg"
    pfull.write_text(cfg.format(maxiter=6, resume="false", datadir=dfull))
    cli_run(str(pfull), quiet=True)
    params_full = np.loadtxt(os.path.join(dfull, "params.dat"))

    dres = str(tmp_path / "resumed")
    p1 = tmp_path / "part1.cfg"
    p1.write_text(cfg.format(maxiter=2, resume="false", datadir=dres))
    cli_run(str(p1), quiet=True)
    p2 = tmp_path / "part2.cfg"
    p2.write_text(cfg.format(maxiter=4, resume="true", datadir=dres))
    cli_run(str(p2), quiet=True)

    params_res = np.loadtxt(os.path.join(dres, "params.dat"))
    np.testing.assert_allclose(params_res, params_full, rtol=1e-10,
                               atol=1e-13)
    h = _read_history(os.path.join(dres, "optim_history.dat"))
    assert int(h[-1, 0]) == 6        # numbering continued across restart
