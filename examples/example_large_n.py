"""Large Hilbert spaces on one accelerator: nlevels 32,32,32,32 (N = 2^20).

The reference needs a distributed MPI allocation with PETSc row-partitioned
states for this size (its 32^4 perf-CI case runs np=32); here the grouped
(matricized) engine runs it on one device — the state is a (1024, 1024)
matrix, the Hamiltonian application is two square GEMMs plus cheap
cross terms, the stiff Kerr diagonal is integrated exactly by the
diagonally-split stepper (auto-selected), and the gradient runs a
hand-written solve-based adjoint at ~2x forward cost.

On the CPU this example still runs, just slowly — shrink nlev for a quick
look.

Usage: python examples/example_large_n.py [nlev] [ntime]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from quandary_tpu.ops.tensor_rhs import build_structured_model
from quandary_tpu.problem import Problem, Setup
from quandary_tpu.utils.splines import ControlSegment, OscillatorControl


def main(nlev=32, ntime=50):
    Q = 4
    nlevels = [nlev] * Q
    freqs = [4.1, 4.2, 4.3, 4.4]
    T = ntime * 0.01

    # StructuredModel: operators stay in per-axis factorized form — nothing
    # of size N x N is ever assembled on the host.
    model = build_structured_model(
        nlevels=nlevels, freq01_ghz=freqs, rotfreq_ghz=freqs,
        selfkerr_ghz=[0.2] * Q, crosskerr_ghz=[0.001] * 6,
        jkl_ghz=[0.001] * 6)
    oscs = tuple(
        OscillatorControl(
            segments=(ControlSegment("spline", nsplines=10, tstart=0.0,
                                     tstop=T),),
            carrier_freqs=(0.0, -0.2 * 2 * np.pi),
        ) for _ in range(Q))
    setup = Setup(
        model=model, nessential=tuple(nlevels), ntime=ntime, dt=T / ntime,
        oscillators=oscs,
        ground_freqs_radns=tuple(2 * np.pi * f for f in freqs),
        initcond_type="basis", initcond_ids=(0,),   # B = nlev basis states
        target_type="pure", pure_target_levels=(0,) * Q,
        objective_type="Jtrace", gamma_tik=1e-4,
        dtype=jnp.complex64, linsolve_iters=4,
    )
    prob = Problem(setup)
    print(f"N = {prob.N:,}  engine {type(prob.engine).__name__}  "
          f"linsolver {prob.linsolver}  device {jax.devices()[0].platform}")

    # full gradient sweep: forward + reversible hand-written adjoint.
    # Operator stacks are assembled ON DEVICE (device_builders) — host
    # traffic stays at kilobytes regardless of N.
    vg = prob.build_value_and_grad()
    params = jnp.asarray(
        np.random.default_rng(0).uniform(-1, 1, setup.nparams) * 0.02,
        jnp.float32)
    t0 = time.time()
    (J, aux), g = vg(params, params)
    print(f"compile+run {time.time() - t0:.1f} s  J = {float(J):.6f}")
    t0 = time.time()
    (J, aux), g = vg(params, params)
    float(J)
    dt_run = time.time() - t0
    print(f"gradient sweep {dt_run:.2f} s "
          f"({dt_run / ntime * 1e3:.1f} ms/step)  "
          f"|g|max {float(jnp.abs(g).max()):.3e}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 32,
         int(sys.argv[2]) if len(sys.argv) > 2 else 50)
