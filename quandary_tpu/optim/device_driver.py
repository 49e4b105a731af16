"""On-device production optimizer: the L-BFGS-B loop runs INSIDE jit, in
chunks of iterations, so a real optimization proceeds at (near-)bench
throughput instead of paying a host round-trip per iteration.

The host driver (driver.run_optimization) fetches (f, g, aux) synchronously
every iteration — correct, but each fetch is a device-to-host round trip
that leaves the device idle between sweeps. Here the whole iteration —
two-loop direction, parallel backtracking line search, curvature update,
stopping tests — is traced into one jit that advances `chunk` iterations per
call and returns only the per-iteration scalar rows (chunk x 11 floats) plus
a done flag; the parameter vector and curvature memory stay device-resident
between calls. One fetch per chunk instead of ~3 per iteration.

The reference's optimizer loop also runs without per-iteration host<->device
churn (TaoSolve, optimproblem.cpp:540); this is its on-device equivalent —
and the same machinery vmaps over candidates (optim/batched_lbfgs.py) when a
population is optimized instead of one problem.

Line search: parallel Armijo backtracking — all `ls_lengths` trial steps are
evaluated in ONE batched objective call (they ride the same batched
GEMMs), and the first satisfying length is selected. This replaces the host
driver's sequential strong-Wolfe bracket; quality parity on the flagship is
pinned by tests (same optimum class, same stopping semantics).
"""

from __future__ import annotations

import os
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..io import output as out_io
from .driver import OptimHistoryRow, OptimResult

AUX_KEYS = ("fidelity", "obj_cost", "obj_regul", "obj_penal",
            "obj_penal_dpdm", "obj_penal_energy", "obj_penal_variation")


def _two_loop(g, S, Y, rho, count, m):
    """L-BFGS two-loop recursion over a circular (m, n) history buffer."""
    q = g
    alphas = []
    for j in range(m):
        idx = (count - 1 - j) % m
        valid = j < count
        a = jnp.where(valid, rho[idx] * jnp.dot(S[idx], q), 0.0)
        q = q - a * Y[idx]
        alphas.append((idx, valid, a))
    newest = (count - 1) % m
    sy = jnp.dot(S[newest], Y[newest])
    yy = jnp.dot(Y[newest], Y[newest])
    gamma = jnp.where(count > 0, sy / jnp.maximum(yy, 1e-30), 1.0)
    q = q * gamma
    for idx, valid, a in reversed(alphas):
        b = jnp.where(valid, rho[idx] * jnp.dot(Y[idx], q), 0.0)
        q = q + jnp.where(valid, a - b, 0.0) * S[idx]
    return q


def build_device_optimizer(problem, lb, ub, *, chunk=10, history=8,
                           ls_lengths=8, c1=1e-4, maxiter=200,
                           gatol=1e-8, grtol=1e-4, fatol=1e-8, inftol=1e-5):
    """Returns (init_fn, chunk_fn):
    state = init_fn(params0, params_ref); state, rows, done = chunk_fn(state).
    rows is (chunk, 11): [valid, f, gnorm, step, fidelity, cost, tik,
    penalty, dpdm, energy, variation]. Both are wrapped with the problem's
    big-array threading and jitted."""
    rdtype = problem.rdtype
    lb = jnp.asarray(lb, rdtype)
    ub = jnp.asarray(ub, rdtype)
    m = int(history)
    ts = (0.5 ** jnp.arange(ls_lengths)).astype(rdtype)

    vg = jax.value_and_grad(problem.objective, has_aux=True)

    def obj_only(x, ref):
        J, _ = problem.objective(x, ref)
        return J

    def project(x):
        return jnp.clip(x, lb, ub)

    def pgrad(x, g):
        at_lb = (x <= lb + 1e-12) & (g > 0)
        at_ub = (x >= ub - 1e-12) & (g < 0)
        return jnp.where(at_lb | at_ub, 0.0, g)

    def fb_residual(x, g):
        # TAO's Fischer-Burmeister bounded residual (lbfgsb.bounded_residual
        # — reproduces the reference's ||Pr(grad)|| column exactly)
        def phi(a, b):
            return jnp.sqrt(a * a + b * b) - a - b
        return phi(x - lb, phi(ub - x, -g))

    def aux_vec(aux):
        return jnp.stack([jnp.asarray(aux[k], rdtype) for k in AUX_KEYS])

    def init(params0, params_ref):
        x = project(jnp.asarray(params0, rdtype))
        (f, aux), g = vg(x, params_ref)
        n = x.shape[0]
        gnorm0 = jnp.linalg.norm(fb_residual(x, g))
        return dict(
            x=x, f=jnp.asarray(f, rdtype), g=g, aux=aux_vec(aux),
            ref=jnp.asarray(params_ref, rdtype),
            S=jnp.zeros((m, n), rdtype), Y=jnp.zeros((m, n), rdtype),
            rho=jnp.zeros((m,), rdtype), count=jnp.zeros((), jnp.int32),
            it=jnp.zeros((), jnp.int32), gnorm0=gnorm0,
            done=jnp.zeros((), jnp.bool_), step=jnp.zeros((), rdtype),
            tscale=jnp.ones((), rdtype),
        )

    def one_iteration(st):
        x, f, g = st["x"], st["f"], st["g"]
        pg = pgrad(x, g)
        d = -_two_loop(g, st["S"], st["Y"], st["rho"], st["count"], m)
        desc = jnp.dot(d, pg)
        d = jnp.where(desc < 0, d, -pg)
        # first-step cap (lbfgsb._first_step_cap): an unscaled -g first
        # direction can dwarf the box; cap so the unit step crosses at most
        # a quarter of it
        width = jnp.where(ub - lb < 1e9, ub - lb, jnp.inf)
        dmax = jnp.max(jnp.abs(d) / jnp.maximum(width, 1e-30))
        cap = jnp.minimum(1.0, 0.25 / jnp.maximum(dmax, 1e-30))
        d = jnp.where(st["count"] == 0, cap * d, d)

        # parallel Armijo backtracking: all trial lengths in one batched
        # call, in the adaptive window tscale * {1, 1/2, ..., 1/2^(L-1)}
        ts_row = st["tscale"] * ts
        xc = jax.vmap(project)(x[None, :] + ts_row[:, None] * d[None, :])
        fc = jax.vmap(obj_only, in_axes=(0, None))(xc, st["ref"])  # (L,)
        dx = xc - x[None, :]
        armijo = fc <= f + c1 * (dx @ g)
        any_ok = jnp.any(armijo)
        pick = jnp.where(any_ok, jnp.argmax(armijo), 0)
        x_new = jnp.where(any_ok, xc[pick], x)
        step = jnp.where(any_ok, ts_row[pick], 0.0).astype(rdtype)
        # remember the accepted length, grown back toward the unit step;
        # on TOTAL rejection shift the window below the smallest tried
        # length and retry next iteration (the static 12-rung ladder could
        # reach 1/2048 in one shot; the adaptive window reaches it across
        # iterations instead of terminating)
        tscale = jnp.where(any_ok,
                           jnp.minimum(1.0, 2.0 * ts_row[pick]),
                           ts_row[-1] * 0.5).astype(rdtype)

        (f_new, aux_new), g_new = vg(x_new, st["ref"])
        f_new = jnp.asarray(f_new, rdtype)
        av_new = aux_vec(aux_new)

        s = x_new - x
        y = g_new - g
        sy = jnp.dot(s, y)
        good = any_ok & (sy > 1e-12)
        slot = st["count"] % m
        S = jnp.where(good, st["S"].at[slot].set(s), st["S"])
        Y = jnp.where(good, st["Y"].at[slot].set(y), st["Y"])
        rho = jnp.where(good,
                        st["rho"].at[slot].set(1.0 / jnp.where(good, sy, 1.0)),
                        st["rho"])
        count = st["count"] + good.astype(jnp.int32)

        gnorm = jnp.linalg.norm(fb_residual(x_new, g_new))
        av = av_new
        # stopping tests (driver.run_optimization / optimproblem.cpp:607-624).
        # A rejected window alone is NOT failure — the shrunken window
        # retries next iteration; the line search has genuinely failed only
        # once the window has collapsed to f32-negligible steps.
        done = ((1.0 - av[0] <= inftol) | (av[1] <= fatol)
                | (gnorm < gatol) | (gnorm / st["gnorm0"] < grtol)
                | (~any_ok & (tscale < 1e-7))
                | (st["it"] + 1 >= maxiter))

        return dict(st, x=x_new, f=f_new, g=g_new, aux=av, S=S, Y=Y,
                    rho=rho, count=count, it=st["it"] + 1, done=done,
                    step=step, tscale=tscale)

    def chunk_fn(st):
        def body(st, _):
            nxt = one_iteration(st)
            # freeze once done: later iterations in the chunk are no-ops
            st2 = jax.tree.map(
                lambda a, b: jnp.where(st["done"], a, b), st, nxt)
            res = fb_residual(st2["x"], st2["g"])
            row = jnp.concatenate([
                jnp.stack([jnp.where(st["done"], 0.0, 1.0).astype(rdtype),
                           st2["f"], jnp.linalg.norm(res).astype(rdtype),
                           st2["step"]]), st2["aux"]])
            return st2, row
        st, rows = jax.lax.scan(body, st, None, length=chunk)
        return st, rows, st["done"]

    return (problem._wrap_with_data(init), problem._wrap_with_data(chunk_fn))


def run_optimization_device(
    problem,
    params0: np.ndarray,
    lb: np.ndarray,
    ub: np.ndarray,
    *,
    maxiter: int = 200,
    gatol: float = 1e-8,
    grtol: float = 1e-4,
    fatol: float = 1e-8,
    inftol: float = 1e-5,
    monitor_freq: int = 1,
    verbose: bool = True,
    chunk: int = 10,
    history: int = 8,
    ls_lengths: int = 8,
    datadir: Optional[str] = None,
    output_frequency: int = 1,
) -> OptimResult:
    """Drop-in alternative to driver.run_optimization that keeps the whole
    loop on-device (one host fetch per `chunk` iterations). History rows are
    produced for every iteration; durability writes land once per chunk.

    The traced/jitted (init_fn, chunk_fn) pair is memoized on the problem:
    re-running the same problem (restarts, warm campaigns, parameter
    sweeps) skips the re-trace — tracing the chunk program costs seconds
    while a warm chunk call costs milliseconds, so without the memo the
    'optimizer wall clock' of a repeat run is ~all tracing."""
    # The memo key covers the driver scalars AND the attributes of the
    # problem that change the traced objective (engine identity, pallas
    # routing, stepper); a dict (not a single slot) so alternating configs
    # don't re-trace each other out of the cache. The Problem's physics
    # (model operators, setup) must not be mutated between calls with an
    # unchanged key — mutating those re-uses a stale traced program.
    key = (np.ascontiguousarray(lb, dtype=np.float64).tobytes(),
           np.ascontiguousarray(ub, dtype=np.float64).tobytes(),
           chunk, history, ls_lengths, maxiter,
           float(gatol), float(grtol), float(fatol), float(inftol),
           type(problem).__name__, id(problem.engine),
           bool(problem.use_pallas),
           str(problem.linsolver), int(problem.setup.linsolve_iters),
           int(problem.setup.ntime), float(problem.setup.dt))
    cache = getattr(problem, "_device_opt_cache", None)
    if not isinstance(cache, dict):
        cache = {}
        problem._device_opt_cache = cache
    if key not in cache:
        if len(cache) >= 8:     # bound growth across long sweeps
            cache.pop(next(iter(cache)))
        cache[key] = build_device_optimizer(
            problem, lb, ub, chunk=chunk, history=history,
            ls_lengths=ls_lengths, gatol=gatol, grtol=grtol, fatol=fatol,
            inftol=inftol, maxiter=maxiter)
    init_fn, chunk_fn = cache[key]

    params_ref = np.asarray(params0, dtype=np.float64)
    st = init_fn(jnp.asarray(params0), jnp.asarray(params_ref))

    hist_writer = None
    if datadir is not None:
        os.makedirs(datadir, exist_ok=True)
        hist_writer = out_io.OptimHistoryWriter(
            os.path.join(datadir, "optim_history.dat"))

    def make_row(it, vals):
        f, gnorm, step = float(vals[1]), float(vals[2]), float(vals[3])
        a = [float(v) for v in vals[4:]]
        return OptimHistoryRow(
            iter=it, objective=f, gnorm=gnorm, step=step, fidelity=a[0],
            cost=a[1], tikhonov=a[2], penalty=a[3], penalty_dpdm=a[4],
            penalty_energy=a[5], penalty_variation=a[6])

    history_rows: List[OptimHistoryRow] = []
    # iteration-0 row from the init state
    from .lbfgsb import bounded_residual
    g0 = np.asarray(st["g"], dtype=np.float64)
    x0h = np.asarray(st["x"], dtype=np.float64)
    res0 = bounded_residual(x0h, g0, np.asarray(lb, float),
                            np.asarray(ub, float))
    row0 = OptimHistoryRow(
        iter=0, objective=float(st["f"]), gnorm=float(np.linalg.norm(res0)),
        step=0.0, fidelity=float(st["aux"][0]), cost=float(st["aux"][1]),
        tikhonov=float(st["aux"][2]), penalty=float(st["aux"][3]),
        penalty_dpdm=float(st["aux"][4]), penalty_energy=float(st["aux"][5]),
        penalty_variation=float(st["aux"][6]))
    history_rows.append(row0)
    if hist_writer is not None:
        hist_writer.write_row(row0)
    if verbose:
        print(f"0  Objective {row0.objective:.14e}  Fidelity "
              f"{row0.fidelity:.8f}  ||Pr(grad)|| {row0.gnorm:.6e}")

    # iteration-0 stopping tests (an already-converged start never enters
    # the device loop)
    done_host = (1.0 - row0.fidelity <= inftol or row0.cost <= fatol
                 or row0.gnorm < gatol)
    reason = "converged at initial point" if done_host else "maxiter reached"

    it = 0
    while not done_host and it < maxiter:
        st, rows, done = chunk_fn(st)
        rows = np.asarray(rows, dtype=np.float64)   # ONE fetch per chunk
        for r in rows:
            if r[0] < 0.5 or it >= maxiter:
                break
            it += 1
            row = make_row(it, r)
            history_rows.append(row)
            if verbose and it % monitor_freq == 0:
                print(f"{it}  Objective {row.objective:.14e}  Fidelity "
                      f"{row.fidelity:.8f}  ||Pr(grad)|| {row.gnorm:.6e}")
            if hist_writer is not None and it % monitor_freq == 0:
                hist_writer.write_row(row)
        done_host = bool(done) or it >= maxiter

    last = history_rows[-1]
    if 1.0 - last.fidelity <= inftol:
        reason = "converged: small infidelity"
    elif last.cost <= fatol:
        reason = "converged: small final time cost"
    elif last.gnorm < gatol:
        reason = "converged: small projected gradient norm (atol)"
    elif it >= maxiter:
        reason = "maxiter reached"
    else:
        reason = "line search failed or gradient reduction reached"

    x_final = np.asarray(st["x"], dtype=np.float64)
    if datadir is not None:
        out_io.write_params(os.path.join(datadir, "params.dat"), x_final)
        ts_o, p, q, flab = problem.controls_on_output_grid(
            jnp.asarray(x_final))
        out_io.write_controls(datadir, ts_o, p, q, flab, output_frequency)
        if hist_writer is not None:
            hist_writer.close()

    return OptimResult(
        params=x_final, objective=last.objective,
        infidelity=1.0 - last.fidelity, history=history_rows,
        reason=reason, niter=it)
