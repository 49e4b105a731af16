"""Grouped (matricized) RHS engine for large-N LINDBLAD systems.

The open-system analog of ops/grouped_rhs.py: oscillators split into Left /
Right groups with dims m1 x m2 ~ sqrt(N), the density matrix viewed as the
rank-4 tensor rho[b, r1, r2, c1, c2] (row multi-index (m1, m2), column
multi-index (m1, m2)). Every Hamiltonian commutator term becomes a GROUP
GEMM — (m, m) x (m, N^2/m) with contraction rank m ~ sqrt(N) instead of the
per-oscillator rank d of the TensorEngine — and every dissipator term is
either a group GEMM (the decay jump a rho a^dag) or a broadcast elementwise
mask (everything else: the reference's "diagonal" dissipator parts,
mastereq.cpp:546-614, which it distributes over MPI ranks; here they
partition over the mesh for free).

Same coefficient layout and physics conventions as TensorEngine — the two
engines agree to rounding (test_grouped_lindblad.py) — so this engine is a
drop-in for StructuredModel Lindblad problems at large N where rank-d
contractions underuse the matrix units.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.operators import coupling_pairs, embed, lowering
from .grouped_rhs import GroupedEngine, _embed_dev
from .tensor_rhs import StructuredModel


class GroupedLindbladEngine:
    """rhs(c, x) with x (B, N, N) density matrices; Lindblad only."""

    def __init__(self, model: StructuredModel, dtype=jnp.complex64):
        assert model.lindblad, "GroupedLindbladEngine is Lindblad-only"
        # reuse the closed-system group construction for the Hamiltonian
        # stacks, cross-diag mask, and cross-JC pair operators: the grouping
        # of H is identical; only the dissipators are new
        closed = StructuredModel(
            dims=model.dims, detune=model.detune, selfkerr=model.selfkerr,
            crosskerr=model.crosskerr, jkl=model.jkl, etas=model.etas,
            jc_pairs=model.jc_pairs,
            gamma_decay=(0.0,) * model.n_osc,
            gamma_dephase=(0.0,) * model.n_osc, lindblad=False)
        self._h = GroupedEngine(closed, dtype=dtype)
        self.model = model
        self.dtype = dtype
        self.lindblad = True
        self.N = model.N
        self.split = s = self._h.split
        self.m1, self.m2 = self._h.m1, self._h.m2
        self.K = model.K
        self.stackL = self._h.stackL
        self.stackR = self._h.stackR
        self.cross_diag = self._h.cross_diag
        self.crossA = self._h.crossA
        self.crossB = self._h.crossB
        self.cross_idx = self._h.cross_idx
        self.cross_J = self._h.cross_J

        dims = model.dims
        dimsL, dimsR = dims[:s], dims[s:]
        ndt = np.complex64 if dtype == jnp.complex64 else np.complex128
        rdt = np.float32 if dtype == jnp.complex64 else np.float64

        # decay jumps: sqrt(g1)-weighted group-embedded lowering ops, one
        # stack per side; (g1 a) rho a^dag is applied with the rate folded in
        # (per-jump bookkeeping lives in _jump_sides: (side, idx, g1, k))
        jL, jR = [], []
        self._jump_sides = []
        for k in range(model.n_osc):
            g1 = model.gamma_decay[k]
            if g1 <= 0.0:
                continue
            if k < s:
                jL.append(embed(lowering(dims[k]), k, dimsL).astype(ndt))
                self._jump_sides.append(("L", len(jL) - 1, g1, k))
            else:
                jR.append(embed(lowering(dims[k]), k - s, dimsR).astype(ndt))
                self._jump_sides.append(("R", len(jR) - 1, g1, k))
        self.jumpL = np.stack(jL) if jL else None
        self.jumpR = np.stack(jR) if jR else None

        # per-oscillator group-embedded level vectors for the elementwise
        # dissipator parts; (side, vector, g1, g2)
        self._levels = []
        for k in range(model.n_osc):
            g1, g2 = model.gamma_decay[k], model.gamma_dephase[k]
            if g1 <= 0.0 and g2 <= 0.0:
                continue
            if k < s:
                lv = np.diag(embed(np.diag(np.arange(dims[k], dtype=float)),
                                   k, dimsL)).astype(rdt)
                self._levels.append(("L", lv, g1, g2))
            else:
                lv = np.diag(embed(np.diag(np.arange(dims[k], dtype=float)),
                                   k - s, dimsR)).astype(rdt)
                self._levels.append(("R", lv, g1, g2))

    def device_builders(self):
        """On-device assembly of the big arrays (zero host->device transfer;
        see GroupedEngine.device_builders)."""
        out = self._h.device_builders()
        dims, s = self.model.dims, self.split
        dimsL, dimsR = dims[:s], dims[s:]
        ndt = jnp.complex64 if self.dtype == jnp.complex64 else jnp.complex128
        if self.jumpL is not None:
            ksL = [k for side, _i, _g, k in self._jump_sides if side == "L"]

            @jax.jit
            def buildJL():
                return jnp.stack([
                    _embed_dev(lowering(dims[k]), k, dimsL, ndt) for k in ksL])

            out["jumpL"] = buildJL
        if self.jumpR is not None:
            ksR = [k for side, _i, _g, k in self._jump_sides if side == "R"]

            @jax.jit
            def buildJR():
                return jnp.stack([
                    _embed_dev(lowering(dims[k]), k - s, dimsR, ndt)
                    for k in ksR])

            out["jumpR"] = buildJR
        return out

    def gen_diag(self):
        """Elementwise generator diagonal, (N, N) numpy — same formula as
        TensorEngine.gen_diag (drift commutator diagonal + all elementwise
        dissipator parts) for the Jacobi-preconditioned stage solve."""
        from .tensor_rhs import TensorEngine
        return TensorEngine(self.model, dtype=self.dtype).gen_diag()

    def _commutator_side(self, c, X, row: bool):
        """H rho (row=True) or rho H (row=False) on the rank-5 view."""
        cc = c.astype(self.dtype)
        SL = jnp.asarray(self.stackL).astype(self.dtype)
        SR = jnp.asarray(self.stackR).astype(self.dtype)
        HL = jnp.tensordot(cc, SL, axes=1)
        HR = jnp.tensordot(cc, SR, axes=1)

        if row:
            Y = jnp.einsum("ip,bpqlm->biqlm", HL, X) \
                + jnp.einsum("jq,bpqlm->bpjlm", HR, X)
        else:
            Y = jnp.einsum("pl,bijpq->bijlq", HL, X) \
                + jnp.einsum("qm,bijlq->bijlm", HR, X)

        if self.cross_diag is not None:
            D = jnp.asarray(self.cross_diag).astype(self.dtype)
            Y = Y + (X * D[None, :, :, None, None] if row
                     else X * D[None, None, None, :, :])

        Q = self.model.n_osc
        for i, j in enumerate(self.cross_idx):
            J = self.cross_J[i]
            A = jnp.asarray(self.crossA)[i].astype(self.dtype)
            Bm = jnp.asarray(self.crossB)[i].astype(self.dtype)
            z = (J * (c[1 + 2 * Q + j]
                      + 1j * c[1 + 2 * Q + self.model.n_jc + j])
                 ).astype(self.dtype)
            if row:
                # (z A (x) B + conj(z) A^T (x) B^T) rho on the row indices
                t1 = jnp.einsum("jq,bpqlm->bpjlm", Bm,
                                jnp.einsum("ip,bpqlm->biqlm", A, X))
                t2 = jnp.einsum("qj,bpqlm->bpjlm", Bm,
                                jnp.einsum("pi,bpqlm->biqlm", A, X))
            else:
                # rho (z A (x) B + conj(z) A^T (x) B^T) on the col indices
                t1 = jnp.einsum("qm,bijlq->bijlm", Bm,
                                jnp.einsum("pl,bijpq->bijlq", A, X))
                t2 = jnp.einsum("mq,bijlq->bijlm", Bm,
                                jnp.einsum("lp,bijpq->bijlq", A, X))
            Y = Y + z * t1 + jnp.conj(z) * t2
        return Y

    def rhs(self, c, x):
        B = x.shape[0]
        m1, m2 = self.m1, self.m2
        X = x.reshape(B, m1, m2, m1, m2)

        # -i (H rho - rho H)
        Y = -1j * (self._commutator_side(c, X, row=True)
                   - self._commutator_side(c, X, row=False))

        # elementwise dissipator parts
        for side, lv, g1, g2 in self._levels:
            lvj = jnp.asarray(lv)
            if side == "L":
                nr = lvj[None, :, None, None, None]
                nc = lvj[None, None, None, :, None]
            else:
                nr = lvj[None, None, :, None, None]
                nc = lvj[None, None, None, None, :]
            if g1 > 0.0:
                Y = Y - (g1 / 2.0) * X * (nr + nc).astype(self.dtype)
            if g2 > 0.0:
                Y = Y + g2 * X * (nr * nc - 0.5 * nr * nr
                                  - 0.5 * nc * nc).astype(self.dtype)

        # decay jumps g1 * a rho a^dag (group GEMM on each side's axis pair)
        for side, i, g1, _k in self._jump_sides:
            if side == "L":
                A = jnp.asarray(self.jumpL)[i].astype(self.dtype)
                Z = jnp.einsum("ip,bpqlm->biqlm", A, X)       # a rho
                Z = jnp.einsum("lp,bijpm->bijlm", A, Z)       # ... a^dag
            else:
                A = jnp.asarray(self.jumpR)[i].astype(self.dtype)
                Z = jnp.einsum("jq,bpqlm->bpjlm", A, X)
                Z = jnp.einsum("mq,bijlq->bijlm", A, Z)
            Y = Y + g1 * Z
        return Y.reshape(x.shape)
