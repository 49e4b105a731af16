"""Large-N performance probe: nlevels 32,32,32,32 (N = 2^20) on one device.

Measures:
  1. forward sweep with the all-real grouped Jacobi-IMR step inside
     lax.scan,
  2. full gradient sweep through Problem.build_value_and_grad (reversible
     O(1)-memory adjoint over the same step, ntime=50).

All big operands are materialized on device (GroupedEngine.device_builders
via Problem._wrap_with_data); host<->device traffic is KB-scale.

Usage:  python scripts/perf/large_n_bench.py

Set QTPU_MATMUL_PRECISION=default|high|highest to A/B the f32 GEMM
precision (on a GPU: TF32 / 3xTF32 / full f32) against the package
default (highest); the printed norm drift is the accuracy side of that
tradeoff.
"""

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax

_prec = os.environ.get("QTPU_MATMUL_PRECISION")
if _prec:  # must precede the quandary_tpu import (which sets the default)
    jax.config.update("jax_default_matmul_precision", _prec)
import jax.numpy as jnp
import numpy as np

from quandary_tpu.io.configfile import Config, setup_from_config
from quandary_tpu.ops.grouped_rhs import make_real_imr_step
from quandary_tpu.problem import Problem

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    from quandary_tpu.ops.grouped_rhs import make_real_split_step

    cfg = Config.read(os.path.join(HERE, "nlevels_32_32_32_32.cfg"))
    setup, spec = setup_from_config(cfg, HERE)
    setup = dataclasses.replace(setup, dtype=jnp.complex64)
    iters_env = os.environ.get("QTPU_LINSOLVE_ITERS")
    if iters_env:
        setup = dataclasses.replace(setup, linsolve_iters=int(iters_env))
    solver_env = os.environ.get("QTPU_LINSOLVER")   # jacobi|split|auto
    if solver_env and solver_env != "auto":
        setup = dataclasses.replace(setup, linsolver=solver_env)
    prob = Problem(setup)
    eng = prob.engine
    print(f"N = {eng.N}  groups {eng.m1} x {eng.m2}  device "
          f"{jax.devices()[0].platform}  matmul_precision "
          f"{jax.config.jax_default_matmul_precision}  linsolver "
          f"{prob.linsolver}  iters {setup.linsolve_iters}")

    # 1) forward sweep, all-real step in a scan. level0 = ground corner;
    # level7 = a high Kerr-rotated basis state (the f32 drift worst case,
    # PERF.md 'Precision')
    if prob.linsolver == "split":
        step = make_real_split_step(eng, setup.dt, setup.linsolve_iters)
    else:
        step = make_real_imr_step(eng, setup.dt, setup.linsolve_iters)
    C = np.asarray(jax.device_get(prob.coeff_rows_mid(
        jnp.asarray(spec.params0, dtype=jnp.float32))))[:, 0, :]
    hi = 7 * 33 if eng.m1 >= 256 else eng.m1 - 1   # levels (7,7) per group
    Xr = jax.jit(lambda: jnp.zeros((2, eng.m1, eng.m2), jnp.float32)
                 .at[0, 0, 0].set(1.0)
                 .at[1, min(hi, eng.m1 - 1), min(hi, eng.m2 - 1)]
                 .set(1.0))()
    Xi = jax.jit(lambda: jnp.zeros((2, eng.m1, eng.m2), jnp.float32))()

    def sweep(Xr, Xi, Cs):
        def body(carry, c):
            return step(carry[0], carry[1], c), ()
        (xr, xi), _ = jax.lax.scan(body, (Xr, Xi), Cs)
        return xr, xi

    f = prob._wrap_with_data(sweep)
    Cs = jnp.asarray(C)
    t0 = time.time()
    ar, ai = f(Xr, Xi, Cs)
    float(jnp.sum(ar[0, :2, :2]))
    print(f"forward compile+run {time.time() - t0:.1f} s")
    t0 = time.time()
    ar, ai = f(Xr, Xi, Cs)
    float(jnp.sum(ar[0, :2, :2] ** 2))
    dt = time.time() - t0
    norms = [float(jnp.sum(ar[b] ** 2 + ai[b] ** 2)) for b in (0, 1)]
    print(f"forward sweep: {dt:.3f} s ({dt / setup.ntime * 1e3:.2f} ms/step"
          f" x2 states)  norm drift ground {norms[0] - 1.0:+.2e}"
          f"  level7 {norms[1] - 1.0:+.2e}")

    # 2) full gradient sweep (reversible adjoint)
    vg = prob.build_value_and_grad()
    params = jnp.asarray(spec.params0, dtype=jnp.float64)
    t0 = time.time()
    (J, aux), g = vg(params, params)
    float(J)
    print(f"gradient compile+run {time.time() - t0:.1f} s")
    t0 = time.time()
    (J, aux), g = vg(params, params)
    float(J)
    dt = time.time() - t0
    print(f"gradient sweep: {dt:.2f} s ({dt / setup.ntime * 1e3:.1f} ms/step"
          f" fwd+adj)  |g|max {float(jnp.abs(g).max()):.3e}")


if __name__ == "__main__":
    main()
