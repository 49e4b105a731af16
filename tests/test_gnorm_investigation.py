"""The golden-history gnorm question, SOLVED by
reproduction: TAO's bounded-solver ||Pr(grad)|| column is the
FISCHER-BURMEISTER complementarity residual (PETSc VecFischer),
w_i = phi(x_i - l_i, phi(u_i - x_i, -g_i)), phi(a, b) = sqrt(a^2+b^2)-a-b —
NOT the projected-gradient norm.

Evidence pinned here, in pure numpy + one f64 objective/grad evaluation per
case:

* cnot (x0 fully bound-clipped: constant 0.005 GHz init exceeds the
  0.008/(sqrt(2)*3) per-coefficient bound, TAO projects all 1800
  coefficients to ub): golden gnorm 2.68105544743858e-01 = our
  ||VecFischer|| to 5e-10, while the exact-mask projected gradient is 7.4%
  off and the projected step 8.1% off. Our objective at the same projected
  iterate matches the golden objective to 1e-10 and our gradient is
  FD-exact (directional, rel 1e-9).
* xgate (interior iterate): golden 2.839373057878e-01 = ours to 4.4e-13 —
  the round-2 "4% reference history inaccuracy" theory is dead: it was a
  definitional difference.
* state-to-state_spline0: 2.6e-3 residual gap, IDENTICAL under every
  definition — a genuine (tiny) gradient-level deviation, consistent with
  the reference's 1e-10-abstol stage solves (timestepper.cpp:535).

Our optimizers now report and converge on the same residual
(lbfgsb.bounded_residual / device_driver.fb_residual), making history
files and gatol/grtol semantics TAO-comparable; the golden iter-0 gnorm
comparison is asserted at rtol 5e-3 (test_golden_regression._check_iter0_row).
"""

import os
import shutil
import sys

import numpy as np
import pytest

sys.path.insert(0, ".")

REF = "/root/reference/tests/regression"

pytestmark = pytest.mark.skipif(not os.path.isdir(REF),
                                reason="reference checkout not available")


def _setup_case(tmp_path, case):
    import jax
    import jax.numpy as jnp

    from quandary_tpu.io.configfile import Config, setup_from_config
    from quandary_tpu.optim.driver import build_bounds
    from quandary_tpu.problem import Problem

    src = os.path.join(REF, case)
    work = tmp_path / case
    shutil.copytree(src, work, ignore=shutil.ignore_patterns("base"))
    cfgs = [f for f in os.listdir(work) if f.endswith(".cfg")]
    cfg = Config.read(str(work / cfgs[0]))
    setup, spec = setup_from_config(cfg, str(work))
    problem = Problem(setup)
    lb, ub = build_bounds(setup.oscillators, spec.control_bounds)
    p0 = np.asarray(spec.params0, float)
    x0 = np.clip(p0, lb, ub)
    (J, aux), g = jax.value_and_grad(problem.objective, has_aux=True)(
        jnp.asarray(x0), jnp.asarray(p0))
    gold = np.loadtxt(os.path.join(src, "base", "optim_history.dat"))
    gold0 = gold[0] if gold.ndim == 2 else gold
    return problem, p0, x0, lb, ub, float(J), np.asarray(g, float), gold0


def test_cnot_gnorm_is_fischer_burmeister(tmp_path):
    from quandary_tpu.optim.lbfgsb import bounded_residual

    problem, p0, x0, lb, ub, J, g, gold0 = _setup_case(tmp_path, "cnot")
    assert np.all(x0 >= ub - 1e-15)          # fully bound-clipped start

    # same J function, same point
    np.testing.assert_allclose(J, gold0[1], rtol=1e-9)

    # our gradient is FD-exact there
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    d = rng.standard_normal(g.shape)
    d /= np.linalg.norm(d)

    def obj(v):
        return float(problem.objective(jnp.asarray(v), jnp.asarray(p0))[0])

    eps = 1e-6
    fd = (obj(x0 + eps * d) - obj(x0 - eps * d)) / (2 * eps)
    np.testing.assert_allclose(np.dot(g, d), fd, rtol=1e-7)

    # the Fischer-Burmeister residual reproduces the golden EXACTLY
    fb = np.linalg.norm(bounded_residual(x0, g, lb, ub))
    np.testing.assert_allclose(fb, gold0[2], rtol=1e-8)

    # ... while the projected-gradient family does not (7-8% off): the
    # golden column is NOT a projected-gradient norm
    masked = np.linalg.norm(np.where((x0 >= ub - 1e-12) & (g < 0), 0.0, g))
    projstep = np.linalg.norm(np.clip(x0 - g, lb, ub) - x0)
    assert abs(masked - gold0[2]) / gold0[2] > 0.05
    assert abs(projstep - gold0[2]) / gold0[2] > 0.05


def test_xgate_gnorm_is_fischer_burmeister(tmp_path):
    from quandary_tpu.optim.lbfgsb import bounded_residual

    problem, p0, x0, lb, ub, J, g, gold0 = _setup_case(tmp_path, "xgate")
    np.testing.assert_allclose(J, gold0[1], rtol=1e-8)
    fb = np.linalg.norm(bounded_residual(x0, g, lb, ub))
    np.testing.assert_allclose(fb, gold0[2], rtol=1e-9)
