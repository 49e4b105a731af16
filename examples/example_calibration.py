#!/usr/bin/env python
"""Hamiltonian calibration from trajectory data — differentiating the
propagator with respect to the OPERATOR STACK itself.

The XLA scan engine is plain JAX, so automatic differentiation delivers
cotangents with respect to any array the step closes over, the operator
stack included: a Hamiltonian whose coefficients are unknown can be FIT to
measured trajectories by gradient descent through the propagator. This is a
capability the reference does not have (its adjoint differentiates only
control parameters, mastereq.cpp:925-1277). (The fused GPU kernel,
ops/fused_triton.py, returns zero stack cotangents by contract; calibration
runs the scan.)

Model: a single transmon qudit (4 levels) in the rotating frame with an
uncertain self-Kerr coefficient xi,

    H(t; xi) = -xi/2 (a^dag a)(a^dag a - 1) + p(t)(a + a^dag)/sqrt2
                                            + i q(t)(a - a^dag)/sqrt2.

We synthesize "measured" states from the true xi*, then recover xi from
a perturbed initial guess by minimizing the trajectory misfit.

Run:  python examples/example_calibration.py        (CPU or GPU)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def build_parts(n=4):
    """Constant operator parts: (kerr_op, re-drive, im-drive) and the
    coefficient layout [1 (drift slot), p(t), q(t)]."""
    a = np.diag(np.sqrt(np.arange(1, n)), 1)
    num = a.conj().T @ a
    kerr = -0.5 * (num @ (num - np.eye(n)))
    re_drive = (a + a.conj().T) / np.sqrt(2.0)
    im_drive = 1j * (a - a.conj().T) / np.sqrt(2.0)
    return kerr, re_drive, im_drive


def main():
    import jax
    import jax.numpy as jnp
    from quandary_tpu.ops.steppers import make_step_fn

    n, ntime, dt = 4, 200, 0.05
    xi_true = 0.2198 * 2 * np.pi
    kerr, re_drive, im_drive = build_parts(n)

    # control series (known during calibration)
    ts = (np.arange(ntime) + 0.5) * dt
    pt = 0.02 * np.cos(0.8 * ts) + 0.01 * np.sin(2.3 * ts)
    qt = 0.015 * np.sin(1.1 * ts)
    C = np.stack([np.ones(ntime), pt, qt], axis=1).astype(np.float32)

    def stack_of(xi):
        return jnp.stack([
            xi * jnp.asarray(kerr, jnp.complex64),
            jnp.asarray(re_drive, jnp.complex64),
            jnp.asarray(im_drive, jnp.complex64)])

    x0 = np.zeros((2, n), np.complex64)
    x0[0, 0] = 1.0
    x0[1, :2] = [1 / np.sqrt(2), 1 / np.sqrt(2)]

    def trajectory(xi):
        stack = stack_of(xi)

        def rhs(c, x):                      # dx/dt = -i H(t) x, batched
            return -1j * (x @ jnp.tensordot(c.astype(x.dtype), stack, 1).T)

        step = make_step_fn(rhs, dt, "IMR", 6, "neumann")

        def body(x, c):
            x = step(x, c[None])
            return x, x

        _, hist = jax.lax.scan(body, jnp.asarray(x0), jnp.asarray(C))
        return hist[::10]                     # sampled "measurements"

    data = jax.jit(trajectory)(jnp.float32(xi_true))

    def loss(xi):
        h = trajectory(xi)
        return jnp.sum(jnp.abs(h - data) ** 2)

    g = jax.jit(jax.grad(loss))

    # calibrate: secant iteration on the misfit gradient (the loss is
    # locally quadratic in xi, so this is Newton with an FD Hessian)
    xi_prev = xi_true * 1.07     # 7% miscalibration
    xi = xi_prev * 0.999
    g_prev = float(g(jnp.float32(xi_prev)))
    it = 0
    for it in range(30):
        gi = float(g(jnp.float32(xi)))
        if abs(gi) < 1e-9 or gi == g_prev:
            break
        xi, xi_prev, g_prev = (xi - gi * (xi - xi_prev) / (gi - g_prev),
                               xi, gi)
    err = abs(xi - xi_true) / xi_true
    print(f"true xi/2pi = {xi_true / 2 / np.pi:.6f} GHz, "
          f"recovered {xi / 2 / np.pi:.6f} GHz, rel err {err:.2e}, "
          f"iters {it + 1}")
    assert err < 1e-4, err
    return xi


if __name__ == "__main__":
    main()
