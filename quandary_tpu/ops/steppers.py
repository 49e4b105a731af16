"""Time-stepping schemes: IMR (default), IMR4, IMR8, explicit Euler.

The implicit midpoint rule (user_guide.md:308-335):
    x_{n+1} = x_n + dt * k,   (I - dt/2 M^{n+1/2}) k = M^{n+1/2} x_n

The linear solve uses a fixed-iteration Neumann series
    k <- b + (dt/2) M k,  b = M x_n
(timestepper.cpp:697-727) — branch-free, batched GEMMs, which is what an
accelerator wants. With ||dt/2 M|| ~ pi/Pmin << 1 at the recommended resolution, a dozen
iterations reach machine precision. A GMRES option exists for parity checks.

The compositional schemes IMR4 (3 stages, Yoshida) and IMR8 (15 stages)
perform IMR sub-steps with scaled step sizes gamma_i*dt
(timestepper.cpp:731-802). All stage midpoint TIMES are known statically, so
control coefficients for every stage of every step are precomputed as one
(nsteps, nstages, K) tensor before the `lax.scan` — there is no per-step
control evaluation on the device.

Gradients: the whole propagation is differentiated with JAX AD; each step is
wrapped in `jax.checkpoint` so the backward pass recomputes the Neumann
iterates instead of storing them. This reproduces the reference's discrete
adjoint (timestepper.cpp:631-694) exactly — AD through the converged Neumann
recursion IS the transposed-solve adjoint, with the same storage profile as
storeFWD (one state per step).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

# Compositional coefficients (timestepper.cpp:736-757)
GAMMA_IMR4 = np.array([
    1.0 / (2.0 - 2.0 ** (1.0 / 3.0)),
    -(2.0 ** (1.0 / 3.0)) / (2.0 - 2.0 ** (1.0 / 3.0)),
    1.0 / (2.0 - 2.0 ** (1.0 / 3.0)),
])
GAMMA_IMR8 = np.array([
    0.74167036435061295344822780,
    -0.40910082580003159399730010,
    0.19075471029623837995387626,
    -0.57386247111608226665638773,
    0.29906418130365592384446354,
    0.33462491824529818378495798,
    0.31529309239676659663205666,
    -0.79688793935291635401978884,
    0.31529309239676659663205666,
    0.33462491824529818378495798,
    0.29906418130365592384446354,
    -0.57386247111608226665638773,
    0.19075471029623837995387626,
    -0.40910082580003159399730010,
    0.74167036435061295344822780,
])


def stage_gammas(timestepper: str) -> np.ndarray:
    t = timestepper.upper()
    if t == "IMR":
        return np.array([1.0])
    if t == "IMR4":
        return GAMMA_IMR4
    if t == "IMR8":
        return GAMMA_IMR8
    if t == "EE":
        return np.array([1.0])
    raise ValueError(f"unknown timestepper {timestepper}")


def stage_midpoint_times(ntime: int, dt: float, timestepper: str) -> np.ndarray:
    """(ntime, nstages) array of the times at which the RHS is evaluated.

    IMR evaluates at sub-interval midpoints t_cur + gamma_i*dt/2 where t_cur
    accumulates the previous stages' gamma*dt (timestepper.cpp:784-800).
    Explicit Euler evaluates at the interval start.
    """
    g = stage_gammas(timestepper)
    starts = np.concatenate([[0.0], np.cumsum(g)[:-1]])
    if timestepper.upper() == "EE":
        offs = starts * dt
    else:
        offs = (starts + g / 2.0) * dt
    t0 = np.arange(ntime)[:, None] * dt
    return t0 + offs[None, :]


def neumann_solve(matvec: Callable, b, half_dt, iters: int):
    """Solve (I - half_dt*M) k = b by the fixed-iteration Neumann recursion
    k <- b + half_dt * M k (timestepper.cpp:697-727, without the early-exit
    tolerance branch, which XLA cannot use anyway). Rolled with fori_loop to
    keep the compiled graph small (one RHS application, looped)."""
    return jax.lax.fori_loop(
        0, iters, lambda _, k: b + half_dt * matvec(k), b)


def gmres_solve(matvec: Callable, b, half_dt, iters: int):
    """GMRES stage solve (parity with linearsolver_type=gmres,
    timestepper.cpp:541-550): ONE Krylov cycle of `iters` inner iterations —
    the reference's KSP maxits semantics. jax's `maxiter` counts RESTART
    cycles, so restart=iters, maxiter=1."""
    import jax.scipy.sparse.linalg as jsp

    op = lambda y: y - half_dt * matvec(y)
    k, _ = jsp.gmres(op, b, x0=b, tol=1e-12, atol=1e-12,
                     restart=iters, maxiter=1, solve_method="batched")
    return k


def jacobi_neumann_solve(matvec: Callable, diag, b, half_dt, iters: int):
    """Jacobi-preconditioned Neumann iteration for (I - half_dt*M) k = b.

    The generator's elementwise diagonal D (the Kerr/detuning drift, which is
    TIME-INDEPENDENT in the rotating frame) carries essentially all of the
    spectral radius; the off-diagonal part O = M - D (controls, couplings,
    decay jumps) is small. Iterating

        k <- (I - a D)^{-1} (b + a (M - D) k),   a = half_dt

    contracts at rate ~ a*||O|| REGARDLESS of the diagonal stiffness (the
    elementwise |1 - a d| >= 1 for imaginary-dominated d), so a handful of
    iterations reach machine precision even where the plain Neumann series
    (timestepper.cpp:697-727) diverges and the reference falls back to its
    GMRES warning regime."""
    Minv = 1.0 / (1.0 - half_dt * diag)

    def body(_, k):
        return Minv * (b + half_dt * (matvec(k) - diag * k))

    return jax.lax.fori_loop(0, iters, body, Minv * b)


def make_step_fn(rhs: Callable, dt: float, timestepper: str = "IMR",
                 linsolve_iters: int = 10, linsolver: str = "neumann",
                 gen_diag=None):
    """Build the one-step update x_n -> x_{n+1}.

    rhs(c, x): applies M(t) given the coefficient row c.
    gen_diag: optional elementwise diagonal of the generator (state-shaped,
        no batch axis) enabling the Jacobi-preconditioned solve and the
        diagonal-split stepper.
    linsolver: 'neumann' | 'jacobi' | 'gmres' | 'split'. 'split' is not a
        solver for the IMR stage equation but a diagonally-split STEPPER:
        per stage,  x -> E_{h/2} . IMR_V(h) . E_{h/2} x  with the stiff
        generator diagonal D = diag(gen_diag) integrated EXACTLY by the
        elementwise factor E_s = exp(s*D) (Strang composition; 2nd order
        like IMR, time-symmetric, norm-preserving to elementwise rounding)
        and only the small off-diagonal remainder V = M - D solved
        implicitly — where plain Neumann converges at rate ~h/2*||V||
        regardless of the diagonal stiffness. Removes both failure modes of
        the stiff diagonal at once: the solve truncation blow-up and the
        f32 phase-rotation rounding drift (the dominant phases are applied
        as unit-modulus factors computed in f64 on the host).
    Returns step(x, c_stages) with c_stages of shape (nstages, K).
    """
    gammas = stage_gammas(timestepper)
    explicit = timestepper.upper() == "EE"
    split = linsolver == "split"
    if linsolver == "jacobi" and gen_diag is None:
        # fail loudly: silently dropping to plain Neumann would reintroduce
        # exactly the stiff-mode blow-up the caller asked to avoid
        raise ValueError("linsolver='jacobi' requires gen_diag")
    if split:
        if gen_diag is None:
            raise ValueError("linsolver='split' requires gen_diag")
        # unit-modulus (closed) / exact-decay (Lindblad diagonal) factors,
        # computed in f64 and cast: one (state-shaped) constant per distinct
        # stage length
        d64 = np.asarray(gen_diag, dtype=np.complex128)
        E_half = {float(g): np.exp((float(g) * float(dt) / 2.0) * d64)
                  for g in dict.fromkeys(float(g) for g in gammas)}

    def step(x, c_stages):
        for i, g in enumerate(gammas):
            # python float: numpy scalars are strong-typed and would upcast
            # complex64 states to complex128 under jax_enable_x64
            h = float(g) * float(dt)
            c = c_stages[i]
            if explicit:
                x = x + h * rhs(c, x)
            elif split:
                d = jnp.asarray(gen_diag)[None].astype(x.dtype)
                E = jnp.asarray(E_half[float(g)])[None].astype(x.dtype)
                mv = lambda y, c=c, d=d: rhs(c, y) - d * y
                x = E * x
                b = mv(x)
                k = neumann_solve(mv, b, h / 2.0, linsolve_iters)
                x = E * (x + h * k)
            else:
                mv = lambda y, c=c: rhs(c, y)
                b = mv(x)
                if linsolver == "gmres":
                    k = gmres_solve(mv, b, h / 2.0, linsolve_iters)
                elif linsolver == "jacobi" and gen_diag is not None:
                    d = jnp.asarray(gen_diag)[None]
                    k = jacobi_neumann_solve(mv, d.astype(x.dtype), b,
                                             h / 2.0, linsolve_iters)
                else:
                    k = neumann_solve(mv, b, h / 2.0, linsolve_iters)
                x = x + h * k
        return x

    return step
