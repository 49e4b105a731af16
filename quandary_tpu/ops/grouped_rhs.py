"""Grouped (matricized) RHS engine for large-N Schroedinger systems.

Partition the Q oscillators into a Left group (first axes) and a Right group
(remaining axes) with dims m1 x m2 ~ sqrt(N) each. The state becomes an
(m1, m2) MATRIX X, and the Hamiltonian splits as

    H = H_L (x) I + I (x) H_R + cross terms
    H x  <->  H_L @ X + X @ H_R^T + cross

where the group-local operators H_L(t), H_R(t) absorb every term that acts
only within one group (detuning, self-Kerr, within-group cross-Kerr and JC
coupling, and the p/q control terms of that group's oscillators), assembled
per time step from the same (K,) coefficient rows via small stack
contractions. The two GEMMs are m1 x m1 x m2 / m1 x m2 x m2 — exactly the
square-ish large matmuls that GEMM libraries run near peak, instead of
rank-32 contractions.

Cross-group terms stay cheap:
* cross-group cross-Kerr is DIAGONAL: one precomputed (m1, m2) mask,
  elementwise;
* cross-group JC coupling (a_k^dag a_l with k in L, l in R) is a two-sided
  product A @ X @ B^T with A, B group-embedded ladder operators — two more
  GEMMs per nonzero cross pair.

Per RHS application on 32^4 (N = 2^20): 2 GEMMs + 2 per cross-JC pair at
~8.6 GFLOP each — compute-bound GEMMs, versus the per-axis path's
transposes, which are bound by memory traffic.

Schroedinger only (rho would need the same trick on row/col groups; the
Lindblad dimension N^2 makes the dense-group matrices infeasible first).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.operators import coupling_pairs, embed, lowering, number
from .tensor_rhs import StructuredModel


def _split_axes(dims) -> int:
    """Split index: first `s` axes go Left, rest Right, balancing the dims."""
    best, best_ratio = 1, float("inf")
    total = float(np.prod(dims))
    for s in range(1, len(dims)):
        m1 = float(np.prod(dims[:s]))
        ratio = max(m1 * m1 / total, total / (m1 * m1))
        if ratio < best_ratio:
            best, best_ratio = s, ratio
    return best


class GroupedEngine:
    """rhs(c, x) with x flat (B, N); Schroedinger only."""

    def __init__(self, model: StructuredModel, dtype=jnp.complex64):
        assert not model.lindblad, "GroupedEngine is Schroedinger-only"
        self.model = model
        self.dtype = dtype
        self.lindblad = False
        self.N = model.N
        dims = model.dims
        Q = len(dims)
        s = _split_axes(dims)
        self.split = s
        dimsL, dimsR = dims[:s], dims[s:]
        m1 = int(np.prod(dimsL))
        m2 = int(np.prod(dimsR))
        self.m1, self.m2 = m1, m2
        K = model.K
        ndt = np.complex64 if dtype == jnp.complex64 else np.complex128

        def group_ops(dims_g, offset):
            """(K, m, m) stack of group-local operators with the global
            coefficient layout [1, p_0..p_{Q-1}, q.., cosJC.., sinJC..]."""
            m = int(np.prod(dims_g))
            Qg = len(dims_g)
            stack = np.zeros((K, m, m), dtype=np.complex128)
            a_g = [embed(lowering(dims_g[k]), k, dims_g) for k in range(Qg)]
            n_g = [embed(number(dims_g[k]), k, dims_g) for k in range(Qg)]
            # constant slot: detuning + self-Kerr (+ within-group crossKerr)
            for k in range(Qg):
                gk = offset + k
                nk = n_g[k]
                stack[0] += model.detune[gk] * nk \
                    - model.selfkerr[gk] / 2.0 * (nk @ nk - nk)
                # control slots
                stack[1 + gk] += a_g[k] + a_g[k].T
                stack[1 + Q + gk] += 1j * (a_g[k] - a_g[k].T)
            for idx, (k, l) in enumerate(coupling_pairs(Q)):
                both_in = (offset <= k < offset + Qg) and (offset <= l < offset + Qg)
                if both_in and idx < len(model.crosskerr) \
                        and abs(model.crosskerr[idx]) > 1e-14:
                    stack[0] -= model.crosskerr[idx] * (
                        n_g[k - offset] @ n_g[l - offset])
            for j, (k, l) in enumerate(model.jc_pairs):
                if (offset <= k < offset + Qg) and (offset <= l < offset + Qg):
                    akd_al = a_g[k - offset].T @ a_g[l - offset]
                    ak_ald = a_g[k - offset] @ a_g[l - offset].T
                    J = model.jkl[j]
                    stack[1 + 2 * Q + j] += J * (akd_al + ak_ald)
                    stack[1 + 2 * Q + model.n_jc + j] += J * 1j * (akd_al - ak_ald)
            return stack.astype(ndt)

        self.stackL = group_ops(dimsL, 0)           # (K, m1, m1)
        self.stackR = group_ops(dimsR, s)           # (K, m2, m2)

        # cross-group cross-Kerr: diagonal mask sum_c -xi_c nL_c (x) nR_c
        levelsL = [np.diag(embed(number(dimsL[k]), k, dimsL)) for k in range(len(dimsL))]
        levelsR = [np.diag(embed(number(dimsR[k]), k, dimsR)) for k in range(len(dimsR))]
        Dx = np.zeros((m1, m2))
        for idx, (k, l) in enumerate(coupling_pairs(Q)):
            if k < s <= l and idx < len(model.crosskerr) \
                    and abs(model.crosskerr[idx]) > 1e-14:
                Dx -= model.crosskerr[idx] * np.outer(levelsL[k], levelsR[l - s])
        self.cross_diag = Dx.astype(np.float32 if dtype == jnp.complex64 else np.float64) \
            if np.abs(Dx).max() > 0 else None

        # cross-group JC pairs: stacked A = a_k^dag (L), B = a_l (R)
        self.cross_idx = []
        self.cross_J = []
        As, Bs = [], []
        for j, (k, l) in enumerate(model.jc_pairs):
            if k < s <= l:
                As.append(embed(lowering(dims[k]), k, dimsL).T.astype(ndt))
                Bs.append(embed(lowering(dims[l]), l - s, dimsR).astype(ndt))
                self.cross_idx.append(j)
                self.cross_J.append(model.jkl[j])
        self.crossA = np.stack(As) if As else None
        self.crossB = np.stack(Bs) if Bs else None

        self.K = K

    def device_builders(self):
        """jit thunks that assemble this engine's big arrays ON DEVICE from
        KB-scale constants (see _group_ops_device). Used by
        Problem._wrap_with_data to avoid shipping the (K, m, m) stacks over
        the host->device link entirely."""
        model, dims, s = self.model, self.model.dims, self.split
        ndt = jnp.complex64 if self.dtype == jnp.complex64 else jnp.complex128
        dimsL, dimsR = dims[:s], dims[s:]
        out = {
            "stackL": _group_ops_device(model, dimsL, 0, ndt),
            "stackR": _group_ops_device(model, dimsR, s, ndt),
        }
        if self.crossA is not None:
            idxs = [(k, l) for (k, l) in
                    [model.jc_pairs[j] for j in self.cross_idx]]

            @jax.jit
            def buildA():
                return jnp.stack([
                    _embed_dev(lowering(dims[k]), k, dimsL, ndt).T
                    for k, _l in idxs])

            @jax.jit
            def buildB():
                return jnp.stack([
                    _embed_dev(lowering(dims[l]), l - s, dimsR, ndt)
                    for _k, l in idxs])

            out["crossA"] = buildA
            out["crossB"] = buildB
        if self.cross_diag is not None:
            rdt = jnp.float32 if self.dtype == jnp.complex64 else jnp.float64
            levelsL = [np.diag(embed(number(dimsL[k]), k, dimsL))
                       for k in range(len(dimsL))]
            levelsR = [np.diag(embed(number(dimsR[k]), k, dimsR))
                       for k in range(len(dimsR))]
            terms = [(-float(model.crosskerr[idx]), levelsL[k],
                      levelsR[l - s])
                     for idx, (k, l) in enumerate(coupling_pairs(model.n_osc))
                     if k < s <= l and idx < len(model.crosskerr)
                     and abs(model.crosskerr[idx]) > 1e-14]

            @jax.jit
            def buildD():
                D = jnp.zeros((self.m1, self.m2), rdt)
                for w, lv, rv in terms:
                    D = D + w * jnp.outer(jnp.asarray(lv, rdt),
                                          jnp.asarray(rv, rdt))
                return D

            out["cross_diag"] = buildD
        return out

    def gen_diag(self):
        """Elementwise generator diagonal -i*H_diag, flat (N,) numpy."""
        from ..utils.operators import drift_diagonal
        m = self.model
        d = drift_diagonal(m.dims, m.detune, m.selfkerr, m.crosskerr)
        ndt = np.complex64 if self.dtype == jnp.complex64 else np.complex128
        return (-1j * d).astype(ndt)

    def rhs(self, c, x):
        """x: (B, N) flat -> -i H x, via (B, m1, m2) matricization.

        REAL-arithmetic formulation: the state and operators are split into
        re/im planes and every product is an f32 (or f64) GEMM —
        (Hr + iHi)(Xr + iXi) = (Hr Xr - Hi Xi) + i(Hr Xi + Hi Xr). Explicit
        real GEMMs map cleanly onto the matrix units (and avoid backend gaps
        in large complex dots); the ladder operators A, B are real, so each cross-JC
        side costs 2 real GEMMs.
        """
        B = x.shape[0]
        rdt = jnp.float32 if self.dtype == jnp.complex64 else jnp.float64
        X = x.reshape(B, self.m1, self.m2)
        Xr = jnp.real(X).astype(rdt)
        Xi = jnp.imag(X).astype(rdt)
        Hx_r, Hx_i = self.apply_H_planes(c, Xr, Xi)
        # -i (Hx_r + i Hx_i) = Hx_i - i Hx_r
        return jax.lax.complex(Hx_i, -Hx_r).astype(self.dtype).reshape(x.shape)

    def apply_H_planes(self, c, Xr, Xi, include_cross_diag: bool = True):
        """H x in explicit re/im planes: Xr, Xi (B, m1, m2) real ->
        (Hx_r, Hx_i). The fully-real compute core. include_cross_diag=False
        skips the cross-group cross-Kerr diagonal mask (used by the split
        stepper, which removes the FULL drift diagonal: slot 0 + this mask)."""
        rdt = Xr.dtype
        cr = c.astype(rdt)

        SL = jnp.asarray(self.stackL)
        SR = jnp.asarray(self.stackR)
        HLr = jnp.tensordot(cr, jnp.real(SL).astype(rdt), axes=1)
        HLi = jnp.tensordot(cr, jnp.imag(SL).astype(rdt), axes=1)
        HRr = jnp.tensordot(cr, jnp.real(SR).astype(rdt), axes=1)
        HRi = jnp.tensordot(cr, jnp.imag(SR).astype(rdt), axes=1)

        def lm(M, V):      # left multiply (m1,m1) x (B,m1,m2)
            return jnp.einsum("ij,bjm->bim", M, V)

        def rm(V, M):      # right multiply (B,m1,m2) x (m2,m2)
            return jnp.einsum("bim,mn->bin", V, M)

        Yr = lm(HLr, Xr) - lm(HLi, Xi) + rm(Xr, HRr.T) - rm(Xi, HRi.T)
        Yi = lm(HLr, Xi) + lm(HLi, Xr) + rm(Xi, HRr.T) + rm(Xr, HRi.T)

        if self.cross_diag is not None and include_cross_diag:
            D = jnp.asarray(self.cross_diag).astype(rdt)[None, :, :]
            Yr = Yr + Xr * D
            Yi = Yi + Xi * D

        Q = self.model.n_osc
        for i, j in enumerate(self.cross_idx):
            J = self.cross_J[i]
            A = jnp.real(jnp.asarray(self.crossA)[i]).astype(rdt)   # real ladder ops
            Bm = jnp.real(jnp.asarray(self.crossB)[i]).astype(rdt)
            zr = (J * c[1 + 2 * Q + j]).astype(rdt)
            zi = (J * c[1 + 2 * Q + self.model.n_jc + j]).astype(rdt)
            # t1 = A X B^T (complex), coefficient z = zr + i zi
            AXr = lm(A, Xr)
            AXi = lm(A, Xi)
            t1r = rm(AXr, Bm.T)
            t1i = rm(AXi, Bm.T)
            # t2 = A^T X B, coefficient conj(z)
            AtXr = lm(A.T, Xr)
            AtXi = lm(A.T, Xi)
            t2r = rm(AtXr, Bm)
            t2i = rm(AtXi, Bm)
            Yr = Yr + zr * t1r - zi * t1i + zr * t2r + zi * t2i
            Yi = Yi + zr * t1i + zi * t1r + zr * t2i - zi * t2r
        return Yr, Yi


def _embed_dev(op, axis, dims, dtype):
    """Device-side embed: kron(I_before, op, I_after) with jnp.kron under jit.
    Inputs are tiny (d, d) matrices; the (m, m) result materializes in HBM
    without any host->device transfer."""
    M = jnp.asarray(op, dtype)
    nb = int(np.prod(dims[:axis])) if axis > 0 else 1
    na = int(np.prod(dims[axis + 1:])) if axis + 1 < len(dims) else 1
    if nb > 1:
        M = jnp.kron(jnp.eye(nb, dtype=dtype), M)
    if na > 1:
        M = jnp.kron(M, jnp.eye(na, dtype=dtype))
    return M


def _group_ops_device(model: StructuredModel, dims_g, offset, dtype):
    """jit-compiled on-device twin of GroupedEngine.group_ops: assembles the
    (K, m, m) group-local operator stack from (d, d) single-mode factors.
    Total host->device traffic is a few KB of small constants — the
    full-stack transfer (hundreds of MB at m ~ 1024) never happens."""
    Q = model.n_osc
    K = model.K
    Qg = len(dims_g)
    m = int(np.prod(dims_g))

    @jax.jit
    def build():
        a_g = [_embed_dev(lowering(dims_g[k]), k, dims_g, dtype)
               for k in range(Qg)]
        n_g = [_embed_dev(number(dims_g[k]), k, dims_g, dtype)
               for k in range(Qg)]
        slots = {}

        def add(idx, M):
            slots[idx] = slots.get(idx, 0) + M

        for k in range(Qg):
            gk = offset + k
            nk = n_g[k]
            # python-float scalars: numpy strong-typed scalars would upcast
            # the c64 stack to c128 under x64
            add(0, float(model.detune[gk]) * nk
                - float(model.selfkerr[gk]) / 2.0 * (nk @ nk - nk))
            add(1 + gk, a_g[k] + a_g[k].T)
            add(1 + Q + gk, 1j * (a_g[k] - a_g[k].T))
        for idx, (k, l) in enumerate(coupling_pairs(Q)):
            both = (offset <= k < offset + Qg) and (offset <= l < offset + Qg)
            if both and idx < len(model.crosskerr) \
                    and abs(model.crosskerr[idx]) > 1e-14:
                add(0, -float(model.crosskerr[idx])
                    * (n_g[k - offset] @ n_g[l - offset]))
        for j, (k, l) in enumerate(model.jc_pairs):
            if (offset <= k < offset + Qg) and (offset <= l < offset + Qg):
                akd_al = a_g[k - offset].T @ a_g[l - offset]
                ak_ald = a_g[k - offset] @ a_g[l - offset].T
                J = float(model.jkl[j])
                add(1 + 2 * Q + j, J * (akd_al + ak_ald))
                add(1 + 2 * Q + model.n_jc + j, J * 1j * (akd_al - ak_ald))

        zero = jnp.zeros((m, m), dtype)
        return jnp.stack([slots.get(k2, zero) for k2 in range(K)])

    return build


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def make_M_apply(engine: "GroupedEngine"):
    """(vr, vi, c) -> planes of M v with M = -i H(c)."""
    def M_apply(vr, vi, c):
        Hr, Hi = engine.apply_H_planes(c, vr, vi)
        return Hi, -Hr
    return M_apply


def make_jacobi_solver(engine: "GroupedEngine", g: float, iters: int):
    """Truncated Jacobi-preconditioned Neumann solve of (I - g M) k = b in
    real planes: M = -iH, generator diag d = -i h (h = real drift diagonal),
    Minv = 1/(1 - i g h) applied elementwise, off-diagonal correction
    iterated `iters` times.

    The iteration is the polynomial  P_g(M) = sum_j (g Minv (M - d))^j Minv;
    its real-plane TRANSPOSE is P_{-g}(M) (M^T = -M, d^T = -d,
    Minv^T = conj(Minv)) — the identity the hand-written adjoint in
    grouped_adjoint.py is built on.

    Returns solve(br, bi, c) -> (kr, ki).
    """
    import numpy as _np

    rdt = _np.float32 if engine.dtype == jnp.complex64 else _np.float64
    h = _np.asarray(-engine.gen_diag().imag, dtype=rdt)   # gen_diag = -i h
    h = h.reshape(engine.m1, engine.m2)
    den = 1.0 / (1.0 + (g * h) ** 2)
    Minv_r = _np.asarray(den, dtype=rdt)                  # Re(1/(1 + i g h))
    Minv_i = _np.asarray(-g * h * den, dtype=rdt)         # Im
    M_apply = make_M_apply(engine)

    def solve(br, bi, c):
        MR = jnp.asarray(Minv_r)[None]
        MI = jnp.asarray(Minv_i)[None]
        hh = jnp.asarray(h)[None]
        kr, ki = _cmul(MR, MI, br, bi)
        for _ in range(iters):
            mr, mi = M_apply(kr, ki, c)
            # subtract d*k with d = -i h: d*k = (h*ki, -h*kr)
            tr = mr - hh * ki
            ti = mi + hh * kr
            ur = br + g * tr
            ui = bi + g * ti
            kr, ki = _cmul(MR, MI, ur, ui)
        return kr, ki

    return solve


def device_rotation_planes(engine: "GroupedEngine", s: float):
    """Real (m1, m2) planes (er, ei) of the exact diagonal propagator
    E = exp(s * D) = exp(-i s h), with h the full drift diagonal, ASSEMBLED
    ON DEVICE from the model's scalar constants (per-axis level vectors +
    broadcasting) — KB of embedded constants instead of an (m1, m2) jit
    constant that would bloat the compiled program at 32^4 sizes.

    |er + i ei| = 1 to one ulp, so applying E preserves the state norm to
    elementwise rounding — unlike integrating the stiff diagonal through
    the IMR stage solve, where the f32 phase rounding compounds over the
    horizon (PERF.md 'f32 norm drift'). Call at trace time OUTSIDE the
    scan so the planes are loop-invariant scan constants."""
    m = engine.model
    rdt = jnp.float32 if engine.dtype == jnp.complex64 else jnp.float64
    dims = m.dims
    Q = len(dims)
    h = jnp.zeros((1,) * Q, rdt)
    grids = []
    for k, d in enumerate(dims):
        shape = (1,) * k + (d,) + (1,) * (Q - k - 1)
        grids.append(jnp.arange(d, dtype=rdt).reshape(shape))
    for k in range(Q):
        nk = grids[k]
        h = h + float(m.detune[k]) * nk \
            - float(m.selfkerr[k]) / 2.0 * nk * (nk - 1.0)
    for idx, (k, l) in enumerate(coupling_pairs(Q)):
        if idx < len(m.crosskerr) and abs(m.crosskerr[idx]) > 1e-14:
            h = h - float(m.crosskerr[idx]) * grids[k] * grids[l]
    ang = float(s) * jnp.broadcast_to(h, tuple(dims)).reshape(
        engine.m1, engine.m2)
    return jnp.cos(ang), -jnp.sin(ang)


def make_V_apply(engine: "GroupedEngine"):
    """(vr, vi, c) -> planes of V v with V = M - D the OFF-DIAGONAL part of
    the generator (M = -iH, D = -i h). The drift diagonal h lives entirely
    in coefficient slot 0 (detuning/self-Kerr/within-group cross-Kerr are
    diagonal group operators) plus the cross-group cross-Kerr mask, so V is
    the stack contraction with slot 0 zeroed and the mask skipped — no big
    diagonal array needed. ||V|| is the control/coupling scale, so a plain
    Neumann iteration in V contracts fast regardless of the diagonal
    stiffness."""

    def V_apply(vr, vi, c):
        c0 = c.at[0].set(0.0)
        hr, hi = engine.apply_H_planes(c0, vr, vi, include_cross_diag=False)
        return hi, -hr      # -i * (H_offdiag v)

    return V_apply


def make_v_neumann_solver(engine: "GroupedEngine", g: float, iters: int):
    """Truncated plain-Neumann solve of (I - g V) k = b in real planes,
    V = off-diagonal generator part (make_V_apply). Used by the split
    stepper, where the stiff diagonal has been removed analytically.
    P_g(V)^T = P_{-g}(V) (V^T = -V in the real-plane inner product), the
    identity the split adjoint in grouped_adjoint.py relies on."""
    V_apply = make_V_apply(engine)

    def solve(br, bi, c):
        kr, ki = br, bi
        for _ in range(iters):
            vr, vi = V_apply(kr, ki, c)
            kr = br + g * vr
            ki = bi + g * vi
        return kr, ki

    return solve


def make_real_split_step(engine: "GroupedEngine", dt: float, iters: int,
                         planes=None):
    """Diagonally-split IMR step in real planes (see steppers.make_step_fn
    linsolver='split'): x -> E_{dt/2} . IMR_V(dt) . E_{dt/2} x with the
    stiff drift diagonal integrated exactly by the elementwise rotation E
    and only the small off-diagonal remainder V solved by plain Neumann.
    Second order (Strang), time-symmetric (inverse = same scheme at -dt),
    and norm-preserving to elementwise f32 rounding.

    planes: optional precomputed device_rotation_planes(engine, dt/2) —
    pass them when the step runs inside a scan so the cos/sin assembly is a
    loop-invariant constant instead of per-step work."""
    a = float(dt) / 2.0
    solve = make_v_neumann_solver(engine, a, iters)
    V_apply = make_V_apply(engine)

    def step(Xr, Xi, c):
        er, ei = planes if planes is not None \
            else device_rotation_planes(engine, a)
        R, I = er[None], ei[None]
        xr, xi = R * Xr - I * Xi, R * Xi + I * Xr
        br, bi = V_apply(xr, xi, c)
        kr, ki = solve(br, bi, c)
        yr, yi = xr + dt * kr, xi + dt * ki
        return R * yr - I * yi, R * yi + I * yr

    return step


def make_real_imr_step(engine: "GroupedEngine", dt: float, iters: int):
    """Fully REAL-arithmetic Jacobi-preconditioned IMR step for the grouped
    engine: state carried as f32 planes (Xr, Xi) of shape (B, m1, m2); no
    complex dtype anywhere in the compiled program: every product is a
    real GEMM.

    x' = x + dt k,  (I - (dt/2) M) k = M x  via make_jacobi_solver.
    Returns step(Xr, Xi, c) -> (Xr', Xi').
    """
    a = float(dt) / 2.0
    solve = make_jacobi_solver(engine, a, iters)
    M_apply = make_M_apply(engine)

    def step(Xr, Xi, c):
        br, bi = M_apply(Xr, Xi, c)
        kr, ki = solve(br, bi, c)
        return Xr + dt * kr, Xi + dt * ki

    return step
