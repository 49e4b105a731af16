#!/usr/bin/env python
"""Mesh scaling study — the counterpart of the reference's
submit_scalingstudy.py (SLURM strong-scaling driver): measures gradient-sweep
throughput across ('init' x 'hilbert') mesh shapes on the available devices.

Run on the attached GPUs, or on a virtual CPU mesh:
    QUANDARY_SCALING_CPU=8 python scripts/scaling_study.py
"""

import os
import sys
import time

sys.path.insert(0, ".")

import jax

_ncpu = os.environ.get("QUANDARY_SCALING_CPU")
if _ncpu:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", int(_ncpu))
import jax.numpy as jnp
import numpy as np


def _time_sweeps(problem, setup, mesh, n=10):
    vg = jax.jit(jax.value_and_grad(problem.objective, has_aux=True))
    params = jnp.zeros((setup.nparams,), dtype=jnp.float32)
    with mesh:
        (J, aux), g = vg(params, params)
        jax.block_until_ready(g)
        t0 = time.perf_counter()
        for i in range(n):
            (J, aux), g = vg(params + 1e-6 * i, params)
            _ = float(J)
        dt = (time.perf_counter() - t0) / n
    return 1.0 / dt


def _report(name, results):
    base = results[0][2]
    print(f"\n{name} speedup vs (1,1):")
    for ni, nh, r in results:
        print(f"  ({ni},{nh}): {r/base:.2f}x")


def main():
    from __graft_entry__ import _build_grouped_problem, _build_problem
    from quandary_tpu.parallel.mesh import make_mesh, shard_problem

    ndev = len(jax.devices())
    print(f"devices: {ndev}")
    shapes = []
    for ninit in [1, 2, 4, 8]:
        for nh in [1, 2]:
            if ninit * nh <= ndev:
                shapes.append((ninit, nh))

    # Dense Lindblad flagship: B = N^2 inits over 'init', rho columns over
    # 'hilbert'.
    dense = []
    for (ni, nh) in shapes:
        problem, setup = _build_problem(ntime=64, T=4.0, lindblad=True)
        mesh = make_mesh(ni, nh)
        shard_problem(problem, mesh, shard_hilbert=(nh > 1))
        r = _time_sweeps(problem, setup, mesh)
        dense.append((ni, nh, r))
        print(f"dense   mesh init={ni} hilbert={nh}: {r:.2f} sweeps/s")

    # Grouped large-N-class engine (the comm_petsc analog): state (B, m1, m2)
    # with the m1 row-group axis over 'hilbert'. B=nlev inits over 'init'.
    grouped = []
    for (ni, nh) in shapes:
        if ni > 4:
            continue  # B = nlev = 4 initial states: init axis caps at 4
        problem, setup = _build_grouped_problem(nlev=4, ntime=24, T=2.4)
        mesh = make_mesh(ni, nh)
        shard_problem(problem, mesh, shard_hilbert=(nh > 1))
        r = _time_sweeps(problem, setup, mesh)
        grouped.append((ni, nh, r))
        print(f"grouped mesh init={ni} hilbert={nh}: {r:.2f} sweeps/s")

    _report("dense", dense)
    _report("grouped", grouped)

    # ENSEMBLE axis (the headline-metric axis): E candidates shard_map'ed
    # over an (n, 1) mesh, fused Pallas kernels per shard. Two protocols:
    # * fixed TOTAL work (E=16 over n devices) — overhead probe: on shared
    #   CPU cores the wall time should not grow with n (collectives are one
    #   scalar psum);
    # * fixed PER-DEVICE work (E=2n) — weak scaling: wall time should stay
    #   ~flat as devices (and total candidates) grow, when real cores back
    #   the devices.
    from quandary_tpu.problem import Problem

    _, esetup = _build_problem(ntime=64, T=4.0)
    eproblem = Problem(esetup)     # the fused kernel where the GPU takes it
    params = jnp.zeros((esetup.nparams,), dtype=jnp.float32)
    rng = np.random.default_rng(0)

    def _time_ens(E, mesh, reps=2, n=3):
        Ps = jnp.asarray(rng.normal(size=(reps, E, esetup.nparams)) * 0.02,
                         dtype=jnp.float32)
        f = (eproblem.build_ensemble_sweeps(mesh=mesh) if mesh is not None
             else eproblem.build_ensemble_sweeps())
        ctx = mesh if mesh is not None else _nullctx()
        with ctx:
            _ = float(f(Ps, params))
            t0 = time.perf_counter()
            for _i in range(n):
                _ = float(f(Ps, params))
            return n * reps * E / (time.perf_counter() - t0)

    class _nullctx:
        def __enter__(self):
            return None

        def __exit__(self, *a):
            return False

    print("\nensemble axis (fused kernels, shard_map over 'init'):")
    r1 = _time_ens(16, None)
    print(f"  unsharded E=16:            {r1:8.2f} sweeps/s")
    rows = []
    for n in [2, 4, 8]:
        if n > ndev:
            continue
        mesh = make_mesh(n, 1)
        rf = _time_ens(16, mesh)             # fixed total work
        rw = _time_ens(2 * n, mesh)          # fixed per-device work
        rows.append((n, rf, rw))
        print(f"  n={n}: fixed-total E=16 {rf:8.2f} sweeps/s "
              f"(x{rf / r1:.2f})   weak E={2 * n} {rw:8.2f} sweeps/s")
    print("\nmarkdown:")
    print("| devices | fixed-total E=16 sweeps/s | vs 1 dev | "
          "weak-scaling E=2n sweeps/s |")
    print("|---|---|---|---|")
    print(f"| 1 | {r1:.2f} | 1.00x | {_time_ens(2, None):.2f} |")
    for n, rf, rw in rows:
        print(f"| {n} | {rf:.2f} | {rf / r1:.2f}x | {rw:.2f} |")


if __name__ == "__main__":
    main()
