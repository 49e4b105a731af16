"""Fully on-device batched L-BFGS-B: optimize MANY control candidates in
parallel, entirely inside one jit — no host round-trips per iteration.

This is the optimizer counterpart of the ensemble axis: multi-start
optimization where E candidates each run a projected L-BFGS with fixed
iteration count, vmapped over the ensemble. The line search is itself
parallel: all backtracking step lengths are evaluated in ONE batched
objective call and the first Armijo-satisfying one is selected — on an
accelerator the extra candidates ride along in the same batched GEMMs.

The reference has no analog (its TAO loop is host-side and single-problem);
this is how a population of pulse candidates is refined at device speed.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Tuple

import jax
import jax.numpy as jnp


def _two_loop(g, S, Y, rho, count, m):
    """L-BFGS two-loop for one candidate with a circular (m, n) history.
    Slot (count-1-j) % m is the j-th newest pair; slots j >= count masked."""
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
    gamma = jnp.where(count > 0, sy / jnp.maximum(yy, 1e-300), 1.0)
    q = q * gamma
    for idx, valid, a in reversed(alphas):
        b = jnp.where(valid, rho[idx] * jnp.dot(Y[idx], q), 0.0)
        q = q + jnp.where(valid, a - b, 0.0) * S[idx]
    return q


def batched_lbfgsb(
    objective: Callable,
    grad: Callable,
    x0s,                       # (E, n)
    lb, ub,                    # (n,)
    *,
    iters: int = 50,
    history: int = 8,
    ls_lengths: int = 10,
    c1: float = 1e-4,
    objective_batch: Callable = None,
    grad_batch: Callable = None,
    vg_batch: Callable = None,
    speculative: bool = True,
    ls_warmup: int = 3,
    return_stats: bool = False,
):
    """Run `iters` projected L-BFGS iterations for every candidate.

    objective(x) -> scalar; grad(x) -> (n,). Both are vmapped internally —
    unless `objective_batch(xs (E, n)) -> (E,)` / `grad_batch(xs) -> (E, n)`
    are supplied, which REPLACE the vmaps (Problem.sharded_batch_fns uses
    them to shard the population over a device mesh).

    speculative (default): after `ls_warmup` classic backtracking
    iterations, the line search switches to a SPECULATIVE per-candidate
    step scale: one batched value_and_grad at each candidate's remembered
    scale (`vg_batch(xs) -> ((E,), (E, n))`, derived from `objective` if
    not supplied) is the ENTIRE iteration cost — Armijo acceptors move and
    grow their scale back toward the unit step, rejectors stay and halve
    it (a rejection costs one iteration, not an 8-forward ladder for the
    whole population). The warmup ladder initializes each scale at the
    first accepted trial length. This trades the classic guarantee (every
    iteration moves if ANY trial length passes) for a ~(1 + L/3)x cheaper
    steady-state iteration — measured on the E=128 CNOT population, the
    all-or-nothing variant is useless because SOME candidate rejects the
    unit step in every single iteration.

    Returns (x_best (E, n), f_best (E,), f_trace (iters+1, E)); with
    return_stats=True appends a dict: 'ladder_iters' (iterations that ran
    the classic ladder), 'rejected' (total rejected candidate-iterations,
    counting BOTH ladder iterations whose whole trial row failed and
    speculative-phase rejections).

    Cost note: the one-value_and_grad-per-iteration steady state requires
    either no batch hooks at all (vg_b is derived from `objective`) or the
    full hook triple INCLUDING `vg_batch` (Problem.sharded_batch_fns
    supplies all three). Passing only objective_batch/grad_batch falls
    back to a forward + a separate gradient per iteration (~1.3x a fused
    value_and_grad).
    """
    lb = jnp.asarray(lb)
    ub = jnp.asarray(ub)
    m = history
    E, n = x0s.shape

    obj_b = objective_batch if objective_batch is not None \
        else jax.vmap(objective)
    grad_b = grad_batch if grad_batch is not None else jax.vmap(grad)
    if vg_batch is not None:
        vg_b = vg_batch
    elif objective_batch is None and grad_batch is None:
        vg_b = jax.vmap(jax.value_and_grad(objective))
    else:
        vg_b = lambda xs: (obj_b(xs), grad_b(xs))
    ts = (0.5 ** jnp.arange(ls_lengths)).astype(x0s.dtype)   # (L,)

    def project(x):
        return jnp.clip(x, lb, ub)

    def pg_one(x, g):
        at_lb = (x <= lb + 1e-12) & (g > 0)
        at_ub = (x >= ub - 1e-12) & (g < 0)
        return jnp.where(at_lb | at_ub, 0.0, g)

    x = jax.vmap(project)(x0s)
    f, g = vg_b(x)
    S = jnp.zeros((E, m, n), x.dtype)
    Y = jnp.zeros((E, m, n), x.dtype)
    rho = jnp.zeros((E, m), x.dtype)
    count = jnp.zeros((E,), jnp.int32)
    xbest, fbest = x, f
    tscale = jnp.ones((E,), x.dtype)
    nrej = jnp.zeros((), jnp.int32)

    def iteration(state, use_ladder):
        x, f, g, S, Y, rho, count, xbest, fbest, tscale, nrej = state

        pg = jax.vmap(pg_one)(x, g)
        d = -jax.vmap(_two_loop, in_axes=(0, 0, 0, 0, 0, None))(
            g, S, Y, rho, count, m)
        # descent safeguard: fall back to -pg
        desc = jnp.einsum("en,en->e", d, pg)
        d = jnp.where((desc < 0)[:, None], d, -pg)
        # first-step cap (lbfgsb._first_step_cap semantics): with no
        # curvature memory d = -g is unscaled; if it dwarfs the box, every
        # backtracked trial projects onto the same corner, Armijo never
        # holds, and the candidate silently never moves. Cap the direction
        # so the unit trial step crosses at most a quarter of the box.
        width = jnp.where(ub - lb < 1e9, ub - lb, jnp.inf)
        dmax = jnp.max(jnp.abs(d) / jnp.maximum(width, 1e-300)[None, :],
                       axis=1)
        cap = jnp.minimum(1.0, 0.25 / jnp.maximum(dmax, 1e-300))
        d = jnp.where((count == 0)[:, None], cap[:, None] * d, d)

        def ladder(_):
            # classic parallel backtracking: every candidate's step lengths
            # evaluated in a batched objective, SEQUENCED over the
            # step-length axis with lax.map — peak memory scales with E,
            # not E*L (the fused-kernel objective materializes
            # O(ntime * N^2) Hamiltonian planes per batched call, so the
            # flat E*L vmap exhausts HBM at production sizes)
            xc = jax.vmap(project)(
                x[:, None, :] + ts[None, :, None] * d[:, None, :])
            fc = jax.lax.map(obj_b, xc.transpose(1, 0, 2)).T   # (E, L)
            dx = xc - x[:, None, :]
            armijo = fc <= f[:, None] + c1 * jnp.einsum("en,eln->el", g, dx)
            any_ok = jnp.any(armijo, axis=1)
            first = jnp.argmax(armijo, axis=1)        # first True (or 0)
            pick = jnp.where(any_ok, first, 0)
            x_new = jnp.where(any_ok[:, None],
                              jnp.take_along_axis(xc, pick[:, None, None],
                                                  axis=1)[:, 0, :], x)
            f_new = jnp.where(any_ok,
                              jnp.take_along_axis(fc, pick[:, None],
                                                  axis=1)[:, 0], f)
            g_new = grad_b(x_new)
            # remember the accepted trial length as the candidate's scale
            # for the speculative phase; total rejection halves it
            t_new = jnp.where(any_ok, ts[pick], tscale * 0.5)
            return x_new, f_new, g_new, t_new, jnp.sum(~any_ok)

        def adaptive(_):
            # speculative per-candidate scale: ONE batched value_and_grad
            # at each candidate's remembered step scale is the whole
            # iteration. Acceptors move and grow the scale back toward the
            # unit step; rejectors stay put and halve it.
            x1 = jax.vmap(project)(x + tscale[:, None] * d)
            f1, g1 = vg_b(x1)
            ok = f1 <= f + c1 * jnp.einsum("en,en->e", g, x1 - x)
            x_new = jnp.where(ok[:, None], x1, x)
            f_new = jnp.where(ok, f1, f)
            g_new = jnp.where(ok[:, None], g1, g)
            t_new = jnp.where(ok, jnp.minimum(1.0, tscale * 2.0),
                              tscale * 0.5)
            return x_new, f_new, g_new, t_new, jnp.sum(~ok)

        if speculative:
            x_new, f_new, g_new, tscale, rej = jax.lax.cond(
                use_ladder, ladder, adaptive, None)
        else:
            x_new, f_new, g_new, tscale, rej = ladder(None)
        nrej_new = nrej + rej.astype(jnp.int32)

        s = x_new - x
        y = g_new - g
        sy = jnp.einsum("en,en->e", s, y)
        # non-acceptors keep x (s = 0, so sy = 0); the curvature guard
        # alone filters them
        good = sy > 1e-12
        slot = count % m
        S = jnp.where(good[:, None, None],
                      S.at[jnp.arange(E), slot].set(s), S)
        Y = jnp.where(good[:, None, None],
                      Y.at[jnp.arange(E), slot].set(y), Y)
        rho = jnp.where(good[:, None],
                        rho.at[jnp.arange(E), slot].set(
                            1.0 / jnp.where(good, sy, 1.0)), rho)
        count = count + good.astype(jnp.int32)

        better = f_new < fbest
        xbest = jnp.where(better[:, None], x_new, xbest)
        fbest = jnp.where(better, f_new, fbest)
        return (x_new, f_new, g_new, S, Y, rho, count, xbest, fbest,
                tscale, nrej_new), f_new

    nwarm = min(ls_warmup, iters) if speculative else iters
    use_ladder = jnp.arange(iters) < nwarm
    state0 = (x, f, g, S, Y, rho, count, xbest, fbest, tscale, nrej)
    (x, f, g, S, Y, rho, count, xbest, fbest, tscale, nrej), ftrace = \
        jax.lax.scan(iteration, state0, use_ladder, length=iters)
    ftrace = jnp.concatenate([state0[1][None], ftrace], axis=0)
    if return_stats:
        return xbest, fbest, ftrace, {
            "ladder_iters": jnp.asarray(nwarm, jnp.int32),
            "rejected": nrej}
    return xbest, fbest, ftrace
