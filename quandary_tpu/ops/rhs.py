"""RHS engines: apply the time-dependent generator to a batch of states.

Two engines share one interface ``rhs(c, x) -> dx/dt``:

* :class:`DenseEngine` — assembles H(t) = sum_j c_j O_j as a dense (N, N)
  matrix per evaluation and applies it to the whole state batch with a single
  matmul. Meant for N up to a few thousand. This subsumes both of the
  reference's paths (sparse MPIAIJ MatMult, mastereq.cpp:743-922, and the
  matrix-free template kernels, 1280-3240): a dense batched matmul at these
  sizes keeps the accelerator's matrix units busy where a sparse format would
  not, and XLA fuses the (K, N, N) stack contraction into the step.

* :class:`TensorEngine` (ops/tensor_rhs.py) — for large N, per-axis tensor
  contractions of the rank-Q state; see that module.

States are complex: Schroedinger psi (B, N); Lindblad rho (B, N, N). The
real-valued blocked formulation of the reference (u, v stacking,
user_guide.md:269-306) is unnecessary here — complex arithmetic lowers to the
same real multiply-adds inside XLA.

Lindblad in matrix form: dx/dt = -i (Heff rho - rho Heff^dag) + sum_c L_c rho L_c^dag
with Heff = H(t) - (i/2) sum_c L_c^dag L_c. The constant -i/2 sum L^dag L term
is folded into the constant slot of the operator stack (coefficient 1).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.hamiltonian import HamiltonianModel


class DenseEngine:
    """Dense operator-stack engine.

    Parameters
    ----------
    model : HamiltonianModel
    dtype : complex dtype for device arrays (complex128 for validation,
        complex64 for speed).
    """

    def __init__(self, model: HamiltonianModel, dtype=jnp.complex128):
        self.model = model
        self.dtype = dtype
        self.lindblad = model.lindblad
        self.N = model.N
        stack = np.array(model.stack, dtype=np.complex128)
        if self.lindblad and len(model.collapse_ops) > 0:
            G = np.zeros((model.N, model.N), dtype=np.complex128)
            for L in model.collapse_ops:
                G += L.conj().T @ L
            stack = stack.copy()
            stack[0] = stack[0] - 0.5j * G
        # Arrays are kept HOST-side (numpy): jit lowering embeds them as
        # constants directly from host memory; big ones are threaded as
        # arguments (Problem._wrap_with_data).
        self.stack = stack.astype(np.complex64 if dtype == jnp.complex64 else np.complex128)
        if self.lindblad and len(model.collapse_ops) > 0:
            self.Ls = np.stack(model.collapse_ops).astype(self.stack.dtype)
        else:
            self.Ls = None

    def gen_diag(self):
        """Elementwise diagonal of the generator (state-shaped, no batch):
        Schroedinger -i h_i; Lindblad -i(h_i - conj(h_j)) plus the diagonal
        jump contribution sum_c L_ii conj(L_jj) (nonzero for dephasing).
        Used by the Jacobi-preconditioned stage solve."""
        h = np.diagonal(self.stack[0])
        if not self.lindblad:
            return (-1j * h).astype(self.stack.dtype)
        d = -1j * (h[:, None] - np.conj(h)[None, :])
        if self.Ls is not None:
            for L in self.Ls:
                dl = np.diagonal(L)
                d = d + dl[:, None] * np.conj(dl)[None, :]
        return d.astype(self.stack.dtype)

    def assemble(self, c):
        """H_eff(t) from the (K,) coefficient row."""
        return jnp.tensordot(c.astype(self.dtype), jnp.asarray(self.stack), axes=1)

    def rhs(self, c, x):
        """Apply the generator: c is the (K,) coefficient row; x is the state
        batch (B, N) [Schroedinger] or (B, N, N) [Lindblad]."""
        A = self.assemble(c)
        if not self.lindblad:
            # dpsi/dt = -i H psi  (batched over leading axis)
            return -1j * (x @ A.T)
        # drho/dt = -i(Heff rho - rho Heff^dag) + sum_c L rho L^dag
        out = -1j * (jnp.einsum("ij,bjk->bik", A, x)
                     - jnp.einsum("bij,jk->bik", x, A.conj().T))
        if self.Ls is not None:
            Ls = jnp.asarray(self.Ls)
            out = out + jnp.einsum("cij,bjl,ckl->bik", Ls, x, Ls.conj())
        return out


def state_population(x, lindblad: bool):
    """Real per-level population: |psi_i|^2 (Schroedinger) or Re(rho_ii)
    (Lindblad) — the quantities used by the observables and penalties
    (oscillator.cpp:430-566, timestepper.cpp:272-295)."""
    if lindblad:
        return jnp.real(jnp.diagonal(x, axis1=-2, axis2=-1))
    return jnp.abs(x) ** 2


