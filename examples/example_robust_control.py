"""Robust ensemble control: one pulse optimized against an ensemble of
Hamiltonian realizations (here: qubit frequency uncertainty of +-10 MHz).

The ensemble average objective and its exact gradient evaluate in ONE jit;
compare the worst-case infidelity of the robust pulse vs the nominal one.
"""

import jax
import jax.numpy as jnp
import numpy as np

from quandary_tpu.optim.driver import build_bounds
from quandary_tpu.optim.lbfgsb import minimize_lbfgsb
from quandary_tpu.optim.robust import (build_robust_objective,
                                       sample_standard_models)
from quandary_tpu.utils.splines import ControlSegment, OscillatorControl

T, ntime = 60.0, 300
osc = OscillatorControl(
    segments=(ControlSegment("spline", nsplines=10, tstart=0.0, tstop=T),),
    carrier_freqs=(0.0,))
setup_kwargs = dict(
    nessential=(2,), ntime=ntime, dt=T / ntime, oscillators=(osc,),
    ground_freqs_radns=(2 * np.pi * 4.1,),
    initcond_type="pure", pure_levels=(0,),
    target_type="pure", pure_target_levels=(1,),
    objective_type="Jtrace", gamma_tik=1e-6)

deltas = [-0.010, -0.005, 0.0, 0.005, 0.010]     # GHz
problems = sample_standard_models(
    dict(nlevels=[2], freq01_ghz=[4.1], rotfreq_ghz=[4.1], selfkerr_ghz=[0.2]),
    [{"freq01_ghz": [4.1 + d]} for d in deltas],
    setup_kwargs)
nominal = problems[len(deltas) // 2]

rng = np.random.default_rng(1)
x0 = rng.uniform(-1, 1, nominal.setup.nparams) * 0.01
# 50 MHz amplitude bound: physical transmon-scale drive, and it keeps
# ||dt/2 H_ctrl|| << 1 so the 10-iteration Neumann stage solve stays at
# roundoff (an unphysical ~GHz bound lets the optimizer park on amplitudes
# where the truncated stage solve is ~1% off and "fidelities" drift above 1)
lb, ub = build_bounds(nominal.setup.oscillators, [[0.05]])


def make_fg(obj):
    vg = jax.jit(jax.value_and_grad(obj, has_aux=True))

    def fg(x):
        (f, aux), g = vg(jnp.asarray(x), jnp.zeros_like(jnp.asarray(x)))
        return float(f), np.asarray(g, dtype=np.float64), aux
    return fg


def worst_infid(x):
    return max(1.0 - float(p.objective(jnp.asarray(x),
                                       jnp.zeros(p.setup.nparams))[1]["fidelity"])
               for p in problems)


obj_robust = build_robust_objective(problems)

res_nom = minimize_lbfgsb(make_fg(nominal.objective), x0, lb, ub, maxiter=80)
res_rob = minimize_lbfgsb(make_fg(obj_robust), x0, lb, ub, maxiter=80)
print(f"nominal pulse: worst-case infidelity {worst_infid(res_nom.x):.3e}")
print(f"robust pulse:  worst-case infidelity {worst_infid(res_rob.x):.3e}")
