"""Ensemble multi-start optimization — an axis beyond the reference:
propagate gradient sweeps for MANY control candidates at once with one
vmapped call, then L-BFGS the best candidate.

On an accelerator the candidates run side by side: the per-step matmuls
batch over (ensemble x initial-conditions), and on a GPU the fused kernel
runs one program per candidate."""

import jax
import jax.numpy as jnp
import numpy as np

from quandary_tpu.models import gates
from quandary_tpu.models.hamiltonian import build_standard_model
from quandary_tpu.optim.driver import build_bounds, run_optimization
from quandary_tpu.problem import Problem, Setup
from quandary_tpu.utils.splines import ControlSegment, OscillatorControl

freq01 = [4.80595, 4.8601]
Ne = [2, 2]
T, ntime = 120.0, 1200

model = build_standard_model(
    nlevels=Ne, freq01_ghz=freq01, rotfreq_ghz=freq01,
    selfkerr_ghz=[0.2198, 0.2252], jkl_ghz=[0.005],
)
oscs = tuple(
    OscillatorControl(
        segments=(ControlSegment("spline", nsplines=20, tstart=0.0, tstop=T),),
        carrier_freqs=(0.0, 2 * np.pi * (freq01[1 - k] - freq01[k])),
    ) for k in range(2)
)
setup = Setup(
    model=model, nessential=tuple(Ne), ntime=ntime, dt=T / ntime,
    oscillators=oscs, ground_freqs_radns=tuple(2 * np.pi * f for f in freq01),
    initcond_type="basis", target_type="gate",
    target_gate_full=gates.assemble_gate(gates.cnot(), Ne, Ne, [0, 0], T),
    objective_type="Jtrace", gamma_tik=1e-4,
)
problem = Problem(setup)

# Score 32 random starting points in ONE call
E = 32
rng = np.random.default_rng(0)
cands = jnp.asarray(rng.uniform(-1, 1, (E, setup.nparams)) * 0.02)
evg = problem.build_ensemble_value_and_grad()
(Js, aux), grads = evg(cands, jnp.zeros(setup.nparams))
best = int(jnp.argmin(Js))
print("candidate objectives:", np.round(np.asarray(Js), 4))
print("best start:", best, float(Js[best]))

# Refine the winner with L-BFGS-B
lb, ub = build_bounds(setup.oscillators, [[0.05], [0.05]])
res = run_optimization(problem, np.asarray(cands[best]), lb, ub,
                       maxiter=100, inftol=1e-4, verbose=True)
print("final objective:", res.objective, "infidelity:", res.infidelity)
