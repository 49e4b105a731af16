"""quandary_tpu — a JAX framework for simulation and optimal control of
closed (Schroedinger) and open (Lindblad) quantum systems.

This is a from-scratch JAX/XLA re-design of the capabilities of LLNL/Quandary
(reference: C++17/MPI/PETSc, see /root/reference). It is NOT a port: the
compute path is built on batched complex linear algebra (batched GEMMs), per-axis
tensor contractions for large Hilbert spaces, `lax.scan` time stepping,
automatic differentiation for the discrete adjoint, and `jax.sharding` meshes
in place of MPI communicator splits.

Public API (mirrors the reference's Python front end, quandary.py):

    from quandary_tpu import Quandary
    q = Quandary(Ne=[2,2], freq01=[4.8,4.9], ..., targetgate=CNOT)
    t, pt, qt, infidelity, expectedEnergy, population = q.optimize()

Everything runs in-process on a GPU or the CPU — no config files, no subprocesses, no
MPI. A config-file compatibility layer (`quandary_tpu.io`) reads/writes the
reference's .cfg and .dat formats for golden-file testing and migration.
"""

__version__ = "0.1.0"

import jax as _jax

# GPU matmuls on f32 operands may run in TF32 (~10-bit mantissa): each
# product then carries ~1e-3 relative error, which compounds over a
# 1000+-step sequential integrator (CPU f32 is unaffected). The reference
# runs f64 throughout; full f32 ("highest") is this framework's accuracy
# floor. Respect an explicit user/app override.
if _jax.config.jax_default_matmul_precision is None:
    _jax.config.update("jax_default_matmul_precision", "highest")

from .api import Quandary
from .utils.operators import (
    lowering,
    number,
    hamiltonians,
)
from .utils.resonances import (
    estimate_timesteps,
    get_resonances,
    eigen_and_reorder,
)
from .models import gates

__all__ = [
    "Quandary",
    "lowering",
    "number",
    "hamiltonians",
    "estimate_timesteps",
    "get_resonances",
    "eigen_and_reorder",
    "gates",
]
