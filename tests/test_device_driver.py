"""On-device chunked L-BFGS-B (optim/device_driver.py): quality parity with
the host Wolfe driver, stopping-test semantics, bounds, and durable output.
This is the production driver for chip execution — the whole iteration runs
inside jit and the host fetches one (chunk x 11) row block per chunk
(TaoSolve's no-per-iteration-churn analog, optimproblem.cpp:540)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from quandary_tpu.optim.device_driver import run_optimization_device
from quandary_tpu.optim.driver import run_optimization


def _problem(dtype=jnp.complex128):
    from __graft_entry__ import _build_problem
    prob, setup = _build_problem(ntime=12, T=2.0, dtype=dtype)
    rng = np.random.default_rng(42)
    params0 = rng.normal(size=setup.nparams) * 0.02
    return prob, setup, params0


def test_device_driver_matches_host_quality():
    prob, setup, params0 = _problem()
    lb = np.full(setup.nparams, -1.0)
    ub = np.full(setup.nparams, 1.0)
    kw = dict(maxiter=25, gatol=1e-14, grtol=1e-30, inftol=1e-12,
              fatol=1e-14, verbose=False)
    resH = run_optimization(prob, params0, lb, ub, **kw)
    resD = run_optimization_device(prob, params0, lb, ub, chunk=8, **kw)
    # different line searches (host strong-Wolfe vs device parallel
    # backtracking) -> same optimum class, not identical iterates
    assert resD.objective <= resH.objective * 1.05 + 1e-10
    assert resD.niter == 25 and resD.history[-1].iter == 25
    # strict progress from the initial point
    assert resD.history[-1].objective < resD.history[0].objective
    # bounds respected
    assert np.all(resD.params >= lb - 1e-12)
    assert np.all(resD.params <= ub + 1e-12)


def test_device_driver_stops_inside_chunk():
    """A reachable infidelity tolerance must stop the loop mid-chunk: no
    trailing rows, niter < maxiter, correct reason. Workload: 1-qubit
    state flip over 80 ns (converges to ~1e-4 in a few tens of
    iterations)."""
    from quandary_tpu.models.hamiltonian import build_standard_model
    from quandary_tpu.problem import Problem, Setup
    from quandary_tpu.utils.splines import ControlSegment, OscillatorControl

    T, ntime = 80.0, 160
    model = build_standard_model(
        nlevels=[2], freq01_ghz=[4.10595], rotfreq_ghz=[4.10595],
        selfkerr_ghz=[0.2198], jkl_ghz=[], crosskerr_ghz=[])
    oscs = (OscillatorControl(
        segments=(ControlSegment("spline", nsplines=10, tstart=0.0,
                                 tstop=T),),
        carrier_freqs=(0.0,)),)
    setup = Setup(
        model=model, nessential=(2,), ntime=ntime, dt=T / ntime,
        oscillators=oscs, ground_freqs_radns=(2 * np.pi * 4.10595,),
        initcond_type="pure", pure_levels=(0,),
        target_type="pure", pure_target_levels=(1,),
        objective_type="Jtrace", gamma_tik=1e-6,
        dtype=jnp.complex128, linsolve_iters=10)
    prob = Problem(setup)
    rng = np.random.default_rng(5)
    params0 = rng.normal(size=setup.nparams) * 0.01
    lb = np.full(setup.nparams, -0.06)
    ub = np.full(setup.nparams, 0.06)
    resD = run_optimization_device(
        prob, params0, lb, ub, maxiter=100, chunk=16, inftol=1e-3,
        gatol=1e-14, grtol=1e-30, fatol=1e-14, verbose=False)
    assert resD.reason == "converged: small infidelity", resD.reason
    assert resD.infidelity <= 1e-3
    assert resD.niter < 100
    # rows end exactly at the stopping iteration
    assert resD.history[-1].iter == resD.niter


def test_device_driver_durable_output(tmp_path):
    prob, setup, params0 = _problem()
    lb = np.full(setup.nparams, -1.0)
    ub = np.full(setup.nparams, 1.0)
    d = str(tmp_path / "dev")
    resD = run_optimization_device(
        prob, params0, lb, ub, maxiter=6, chunk=3, inftol=1e-12,
        gatol=1e-14, grtol=1e-30, fatol=1e-14, verbose=False, datadir=d)
    h = np.atleast_2d(np.loadtxt(os.path.join(d, "optim_history.dat")))
    assert int(h[-1, 0]) == resD.niter
    p = np.loadtxt(os.path.join(d, "params.dat"))
    np.testing.assert_allclose(p, resD.params, rtol=0, atol=1e-13)
    assert os.path.exists(os.path.join(d, "control0.dat"))


def test_device_driver_maxiter_respected():
    """maxiter lands exactly even when it is not a chunk multiple (the
    device loop freezes at maxiter rather than overshooting to the chunk
    boundary)."""
    prob, setup, params0 = _problem()
    lb = np.full(setup.nparams, -1.0)
    ub = np.full(setup.nparams, 1.0)
    res = run_optimization_device(
        prob, params0, lb, ub, maxiter=7, chunk=5, inftol=1e-12,
        gatol=1e-14, grtol=1e-30, fatol=1e-14, verbose=False)
    assert res.niter == 7
    assert res.history[-1].iter == 7
    # the returned params are the it=7 iterate: re-evaluating the
    # objective there reproduces the last row
    J, _ = prob.build_objective()(jnp.asarray(res.params),
                                  jnp.asarray(np.asarray(params0)))
    np.testing.assert_allclose(float(J), res.history[-1].objective,
                               rtol=1e-9, atol=1e-12)


def test_cli_optim_driver_device(tmp_path):
    """optim_driver = device config key routes the CLI optimization
    through the on-device chunked loop, producing the standard durable
    outputs."""
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
optim_maxiter = 6
optim_monitor_frequency = 2
optim_driver = device
datadir = {datadir}
runtype = optimization
"""
    d = str(tmp_path / "dev_cli")
    p = tmp_path / "dev.cfg"
    p.write_text(cfg.format(datadir=d))
    res = cli_run(str(p), quiet=True)
    h = np.atleast_2d(np.loadtxt(os.path.join(d, "optim_history.dat")))
    assert int(h[-1, 0]) == 6
    assert os.path.exists(os.path.join(d, "params.dat"))
    assert res["objective"] < h[0, 1] + 1e-12   # made progress (or equal)


def test_device_driver_packed_speculative_line_search(fused_on_cpu):
    """On the fused GPU kernel (here in the Pallas interpreter) the device
    driver's batched line search runs the kernel once per trial length as
    one more grid axis. Must deliver the same optimum class as the host
    driver on the same fused problem."""
    import dataclasses

    from __graft_entry__ import _build_problem
    from quandary_tpu.problem import Problem

    _, setup = _build_problem(ntime=12, T=2.0)
    prob = Problem(dataclasses.replace(setup, pallas=True,
                                       dtype=jnp.complex64))
    assert prob.use_pallas
    rng = np.random.default_rng(42)
    params0 = rng.normal(size=setup.nparams) * 0.02
    lb = np.full(setup.nparams, -1.0)
    ub = np.full(setup.nparams, 1.0)
    kw = dict(maxiter=12, gatol=1e-14, grtol=1e-30, inftol=1e-12,
              fatol=1e-14, verbose=False)
    resH = run_optimization(prob, params0, lb, ub, **kw)
    resD = run_optimization_device(prob, params0, lb, ub, chunk=6, **kw)
    assert resD.objective <= resH.objective * 1.05 + 1e-10
    assert resD.history[-1].objective < resD.history[0].objective
    # history rows carry real aux columns
    assert 0.0 <= resD.history[-1].fidelity <= 1.0 + 1e-6


def test_device_driver_window_shift_recovers():
    """Round 5: the adaptive line-search window must SHIFT below its
    smallest trial on a fully rejected row and retry, not terminate — at
    ls_lengths=1 every backtrack requires a window shift, so convergence
    of this run pins the retry semantics (the pre-fix behavior terminated
    on the first rejected row with 'line search failed')."""
    prob, setup, params0 = _problem()
    lb = np.full(setup.nparams, -1.0)
    ub = np.full(setup.nparams, 1.0)
    res = run_optimization_device(
        prob, params0, lb, ub, chunk=8, ls_lengths=1, maxiter=40,
        gatol=1e-14, grtol=1e-30, inftol=1e-12, fatol=1e-14, verbose=False)
    # ran to maxiter with real progress (gnorm down ~50x, monotone
    # objective, accepted steps) instead of stopping on a rejected row
    assert res.history[-1].objective < res.history[0].objective
    assert res.history[-1].gnorm < 0.05 * res.history[0].gnorm, res.history[-1]
    assert res.niter == 40, res.reason
    assert "line search failed" not in res.reason
    assert np.all(res.params >= lb - 1e-12)
    assert np.all(res.params <= ub + 1e-12)
