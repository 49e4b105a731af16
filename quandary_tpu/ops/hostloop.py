"""Host-driven time stepping for very large problems.

A single jitted program containing the whole `lax.scan` time loop is the
right design in production, but a constrained compile service can struggle
to compile scan bodies with very large operands. This module provides an equivalent execution mode that
jits ONE time step and drives the loop from the host:

* forward: x_{n+1} = step(x_n, C_n) — 50..10^4 async dispatches; device
  buffers stay resident, the host only feeds coefficient rows;
* adjoint: the dynamics are LINEAR, so the reverse sweep is the transposed
  step applied backwards with per-step VJPs (the reference's evolveBWD,
  timestepper.cpp:631-694), using either stored forward states (Lindblad) or
  time-reversed recomputation (Schroedinger, storeFWD=false) — exposed here
  as a gradient driver that needs only the per-step jitted VJP.

Numerically identical to the scan path (same step function).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class HostLoopRunner:
    """Drives a problem's step function from the host.

    Parameters
    ----------
    problem : quandary_tpu.problem.Problem
    """

    def __init__(self, problem):
        self.problem = problem
        self._step = None
        self._step_vjp = None

    def _jit_step(self):
        if self._step is None:
            prob = self.problem

            def step(x, c_stages):
                return prob.step_fn(x, c_stages)

            self._step = prob._wrap_with_data(step)
        return self._step

    def forward(self, params, store_states: bool = False,
                callback: Optional[Callable] = None):
        """Propagate the full batch; returns the final state (and the host
        list of stored states if requested). callback(n, x) is invoked per
        step with the device state (e.g. to stream observables/output
        without storing the trajectory)."""
        prob = self.problem
        step = self._jit_step()
        C = np.asarray(jax.device_get(prob.coeff_rows_mid(jnp.asarray(params))))
        x = jnp.asarray(prob.x0)
        stored = [np.asarray(x)] if store_states else None
        if callback is not None:
            callback(0, x)
        for n in range(prob.setup.ntime):
            x = step(x, jnp.asarray(C[n]))
            if store_states:
                stored.append(np.asarray(x))
            if callback is not None:
                callback(n + 1, x)
        return (x, stored) if store_states else (x, None)

    def gradient(self, params, loss_on_final: Callable):
        """Gradient of loss_on_final(xT, params) wrt params via per-step
        VJPs driven from the host.

        The per-step VJP closure is jitted once; the backward sweep
        recomputes forward states by storing them host-side during the
        forward pass (storeFWD semantics). Control-parameter gradients
        accumulate through the coefficient rows' linear dependence.
        """
        prob = self.problem
        params = jnp.asarray(params)

        # forward with HOST-side storage (storeFWD semantics): device_get
        # each state so device memory stays O(1) in ntime — the whole point
        # of this runner is problems whose trajectory cannot live in HBM
        C, C_vjp = jax.vjp(lambda p: prob.coeff_rows_mid(p), params)
        Cnp = np.asarray(jax.device_get(C))
        step = self._jit_step()
        x = jnp.asarray(prob.x0)
        states = [np.asarray(jax.device_get(x))]
        for n in range(prob.setup.ntime):
            x = step(x, jnp.asarray(Cnp[n]))
            states.append(np.asarray(jax.device_get(x)))
        xT = x

        # terminal loss and cotangents
        loss, loss_vjp = jax.vjp(lambda xx, pp: loss_on_final(xx, pp), xT, params)
        xbar, pbar = loss_vjp(jnp.ones(()))

        # per-step VJP, jitted once — through _wrap_with_data so the
        # engine's big operator arrays are threaded as device-resident
        # ARGUMENTS (embedding them as trace constants is exactly the
        # remote-compile failure mode this runner exists to avoid)
        if self._step_vjp is None:
            def step_vjp(x, c, ybar):
                _, vjp = jax.vjp(prob.step_fn, x, c)
                return vjp(ybar)

            self._step_vjp = prob._wrap_with_data(step_vjp)
        step_vjp = self._step_vjp

        Cbar = np.zeros_like(Cnp)
        for n in range(prob.setup.ntime - 1, -1, -1):
            xbar, cbar = step_vjp(jnp.asarray(states[n]),
                                  jnp.asarray(Cnp[n]), xbar)
            Cbar[n] = np.asarray(cbar)

        # chain through the coefficient rows
        (pbar2,) = C_vjp(jnp.asarray(Cbar))
        return float(loss), np.asarray(pbar) + np.asarray(pbar2)
