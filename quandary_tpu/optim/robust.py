"""Robust (ensemble) optimal control: one pulse, many system realizations.

Optimizes the weighted average objective over an ensemble of Hamiltonian
samples (parameter uncertainty in detunings, Kerr coefficients, coupling
strengths, T1/T2, ...):

    J_robust(alpha) = sum_s w_s J_s(alpha)

Each sample is a full Problem (its own operator stack / dissipators); the
samples propagate INDEPENDENTLY and in parallel inside one jit, and AD
delivers the exact ensemble gradient. This is the "ensemble robust control"
configuration of BASELINE.json; the reference has no built-in analog (its
ENSEMBLE initial condition is a different concept — a single averaged
initial state).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np


def build_robust_objective(problems: Sequence, weights: Optional[Sequence[float]] = None):
    """objective(params, params_ref) -> (J_robust, aux) averaging over the
    sample Problems. aux carries per-sample fidelities and the weighted
    penalty/cost terms."""
    S = len(problems)
    w = np.asarray(weights if weights is not None else np.full(S, 1.0 / S), dtype=float)
    w = w / w.sum()

    def objective(params, params_ref):
        J_total = 0.0
        fids = []
        terms = None
        for p, ws in zip(problems, w):
            J, aux = p.objective(params, params_ref)
            J_total = J_total + ws * J
            fids.append(aux["fidelity"])
            if terms is None:
                terms = {k: ws * v for k, v in aux.items() if k != "fidelity"}
            else:
                for k in terms:
                    terms[k] = terms[k] + ws * aux[k]
        aux_out = dict(terms)
        aux_out["fidelity"] = jnp.min(jnp.stack(fids))      # worst case
        aux_out["fidelity_mean"] = jnp.sum(jnp.stack(fids) * jnp.asarray(w))
        aux_out["fidelity_per_sample"] = jnp.stack(fids)
        return J_total, aux_out

    return objective


def build_robust_value_and_grad(problems, weights=None):
    return jax.jit(jax.value_and_grad(
        build_robust_objective(problems, weights), has_aux=True))


def sample_standard_models(base_kwargs: dict, param_samples: Sequence[dict],
                           setup_kwargs: dict):
    """Convenience: build one Problem per Hamiltonian sample.

    base_kwargs: arguments of build_standard_model common to all samples;
    param_samples: per-sample overrides (e.g. {'freq01_ghz': [...]});
    setup_kwargs: the common Setup fields (everything but `model`).
    """
    from ..models.hamiltonian import build_standard_model
    from ..problem import Problem, Setup

    problems = []
    for over in param_samples:
        kw = dict(base_kwargs)
        kw.update(over)
        model = build_standard_model(**kw)
        problems.append(Problem(Setup(model=model, **setup_kwargs)))
    return problems

