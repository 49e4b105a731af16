"""Large-N OPEN-SYSTEM performance: two 32-level oscillators under decay +
dephasing — N = 1024, rho = N^2 = 2^20 complex elements — on one device via
the GroupedLindbladEngine (ops/grouped_lindblad.py).

The reference runs this size by distributing the N^2 vectorized rho over
MPI ranks with sparse matvecs (mastereq.cpp:546-614); here every term is a
group GEMM (contraction rank 32) or an elementwise mask over the rank-4
rho view, and the whole step stays on one device.

Usage: python scripts/perf/lindblad_large_n.py [ntime]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax
import jax.numpy as jnp
import numpy as np

from quandary_tpu.ops.tensor_rhs import build_structured_model
from quandary_tpu.problem import Problem, Setup
from quandary_tpu.utils.splines import ControlSegment, OscillatorControl


def main():
    ntime = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    T, dt = ntime * 0.01, 0.01
    freqs = [4.1, 4.2]
    model = build_structured_model(
        nlevels=[32, 32], freq01_ghz=freqs, rotfreq_ghz=freqs,
        selfkerr_ghz=[0.2, 0.2], crosskerr_ghz=[0.001], jkl_ghz=[0.001],
        decay_time=[100.0, 120.0], dephase_time=[50.0, 60.0], lindblad=True)
    oscs = tuple(
        OscillatorControl(
            segments=(ControlSegment("spline", nsplines=10, tstart=0.0,
                                     tstop=T),),
            carrier_freqs=(0.0, -0.2 * 2 * np.pi),
        ) for _ in range(2))
    setup = Setup(
        model=model, nessential=(32, 32), ntime=ntime, dt=dt,
        oscillators=oscs,
        ground_freqs_radns=tuple(2 * np.pi * f for f in freqs),
        initcond_type="pure", pure_levels=(1, 0),
        target_type="pure", pure_target_levels=(0, 0),
        objective_type="Jtrace", dtype=jnp.complex64,
        linsolve_iters=int(os.environ.get("QTPU_LINSOLVE_ITERS", 8)),
    )
    prob = Problem(setup)
    eng = prob.engine
    print(f"engine {type(eng).__name__}  N = {eng.N}  rho elements "
          f"{eng.N**2}  groups {eng.m1} x {eng.m2}  device "
          f"{jax.devices()[0].platform}  linsolver {prob.linsolver}")

    fwd = prob.build_propagate_final()
    params = jnp.zeros((setup.nparams,), jnp.float32)
    t0 = time.time()
    xT = fwd(params)
    tr = float(jnp.real(jnp.trace(xT[0])))
    print(f"forward compile+run {time.time() - t0:.1f} s  trace {tr:.6f}")
    t0 = time.time()
    xT = fwd(params)
    tr = float(jnp.real(jnp.trace(xT[0])))
    dt_run = time.time() - t0
    print(f"forward sweep: {dt_run:.3f} s ({dt_run / ntime * 1e3:.2f} "
          f"ms/step)  trace {tr:.6f}")

    vg = prob.build_value_and_grad()
    # nonzero controls: at alpha = 0 this configuration's exact first-order
    # derivative vanishes (diagonal rho under pure decay/dephasing; control
    # perturbations are off-diagonal at first order), which would make
    # |g|max useless as a correctness signal
    params = jnp.asarray(np.random.default_rng(3).uniform(
        -1, 1, setup.nparams) * 0.02, jnp.float32)
    t0 = time.time()
    (J, aux), g = vg(params, params)
    print(f"gradient compile+run {time.time() - t0:.1f} s  J {float(J):.6f}")
    t0 = time.time()
    (J, aux), g = vg(params, params)
    float(J)
    dt_run = time.time() - t0
    print(f"gradient sweep: {dt_run:.3f} s ({dt_run / ntime * 1e3:.2f} "
          f"ms/step fwd+adj)  |g|max {float(jnp.abs(g).max()):.3e}")


if __name__ == "__main__":
    main()
