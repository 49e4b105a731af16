"""Plotting helpers and the Richardson time-step estimator
(quandary_tpu/plots.py <- reference quandary.py:1202-1409).

The plot functions run headless (Agg) against a real simulate() result;
the Richardson estimator must report errors that SHRINK by ~2^order per
refinement on a smooth problem and stop once below tolerance."""

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest

from quandary_tpu import Quandary


@pytest.fixture(scope="module")
def qres():
    q = Quandary(Ne=[2], freq01=[4.10595], rotfreq=[4.10595],
                 selfkerr=[0.2198], T=30.0, nsteps=60,
                 initialcondition="pure, 0", targetstate=[0.0, 1.0],
                 initctrl_MHz=[2.0], rand_seed=7, verbose=False)
    t, pt, qt, inf, energy, pop = q.simulate(datadir="/tmp/qtpu_plot_test")
    return q, t, pt, qt, inf, energy, pop


def test_plot_helpers_run_headless(qres):
    from quandary_tpu import plots

    q, t, pt, qt, inf, energy, pop = qres
    assert plots.plot_pulse(q.Ne, t, pt, qt) is None or True
    assert plots.plot_expectedEnergy(q.Ne, t, energy) is None or True
    assert plots.plot_population(q.Ne, t, pop) is None or True
    plots.plot_results_1osc(q, pt[0], qt[0], energy[0], pop[0])


def test_richardson_estimator_converges(qres, capsys):
    from quandary_tpu.plots import timestep_richardson_est

    q = Quandary(Ne=[2], freq01=[4.10595], rotfreq=[4.10595],
                 selfkerr=[0.2198], T=30.0, nsteps=30,
                 initialcondition="pure, 0", targetstate=[0.0, 1.0],
                 initctrl_MHz=[2.0], rand_seed=7, verbose=False)
    errs_J, errs_u, dts = timestep_richardson_est(
        q, tol=1e-10, order=2, datadir="/tmp/qtpu_rich_test",
        max_refinements=4)
    assert len(errs_u) >= 3
    # IMR is second order: each refinement shrinks the estimate ~4x
    # (allow slack for f32/solver noise)
    ratios = [errs_u[i] / max(errs_u[i + 1], 1e-300)
              for i in range(len(errs_u) - 1)]
    assert all(r > 2.0 for r in ratios), (errs_u, ratios)
    # each refinement halves dt (the requested nsteps may be raised by
    # the sampling-theorem estimate in __post_init__, so pin the RATIO)
    assert dts[1] == pytest.approx(dts[0] / 2)
    assert dts[2] == pytest.approx(dts[0] / 4)
