"""Fused IMR time loop for small dense systems on an NVIDIA GPU.

The XLA scan engine launches a handful of tiny kernels per time step; at the
CNOT flagship's N=16 and four initial states a 1221-step gradient sweep is
then bound by launch latency and idle gaps, not by its ~0.15 GFLOP. Here the
whole time loop runs inside ONE Pallas kernel per direction, compiled through
Triton (`backend="triton"`): a `lax.fori_loop` inside the kernel walks the
steps, the operator planes are read from the L1-resident (K, P, P) stacks,
each step reads its (K,) coefficient row and writes its history row. The grid
covers only independent work: the candidate axis that `jax.vmap` of the
`pallas_call` adds. No state crosses program boundaries.

The state is carried as row-major f32 (re, im) planes of shape (Bp, P): the
initial-condition batch padded to Bp rows, the flat state (closed psi, or the
column-major vec(rho) of an open system) padded to P lanes, both powers of
two >= 16 (Triton's block and dot constraints). Every dot asks for full f32
(IEEE) precision: the default on this route is TF32, whose ~10 mantissa bits
compound over a thousand sequential steps.

Stage solves match ops/steppers.py exactly:

* neumann -- k <- b + a T(k)   (timestepper.cpp:697-727);
* jacobi  -- k <- Minv (b + a (T(k) - d k)) with the static generator
  diagonal d and Minv = 1/(1 - a d) computed on the host in f64;
* split   -- the diagonally-split stepper: exact half-step rotations
  E = exp((dt/2) d) around a Neumann solve of the off-diagonal remainder
  (the diagonal is subtracted through one extra stack slot).

The backward kernel applies the exact real-arithmetic transpose of the
computed forward step (the reference's discrete adjoint, evolveBWD,
timestepper.cpp:631-694), replaying the stage iterates from the stored
pre-step state, and emits per-step coefficient cotangents. Cotangents with
respect to the operator stacks are not computed (zeros by contract):
control optimisation never differentiates them; Hamiltonian calibration
differentiates the XLA scan engine instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

# On-chip memory (shared memory / L1) one H100 block may use: the (Ke, P, P)
# re/im stacks must fit it so that every step's plane reads stay on chip.
_BLOCK_SMEM_BYTES = 227 * 1024
_MAX_ROWS = 64


def _pow2(n: int, floor: int = 16) -> int:
    return max(floor, 1 << max(0, int(n) - 1).bit_length())


def fused_shape(dim: int, ninit: int, K: int, linsolver: str):
    """(P, Bp, Ke): padded state width, padded batch rows and the number of
    stack slots the kernel contracts per step (one extra for the split
    stepper's diagonal)."""
    Ke = K + (1 if linsolver == "split" else 0)
    return _pow2(dim), _pow2(ninit), Ke


def fused_admits(dim: int, ninit: int, K: int, linsolver: str) -> bool:
    """Whether the kernel takes this size: both operator stacks fit one
    block's shared memory (2 Ke P^2 f32) and the batch fits one block."""
    P, Bp, Ke = fused_shape(dim, ninit, K, linsolver)
    return 2 * Ke * P * P * 4 <= _BLOCK_SMEM_BYTES and Bp <= _MAX_ROWS


def lindblad_prime_stack(stack, Ls):
    """(K, N^2, N^2) pseudo-Hamiltonian stack H' such that the kernels --
    which integrate dv/dt = -i H'(c) v -- propagate the vectorized Lindblad
    equation: with the column-major vec(rho) generator
    L(c) = -i A + i conj(B) + jump (ops/propagator.lindblad_superop_builder),
    set H' = i L, i.e. per slot  H'_j = I (x) O_j - conj(O_j) (x) I  and
    slot 0 += i * sum_l conj(L_l) (x) L_l. H' is not Hermitian (dissipation);
    the backward kernel applies the exact real transpose and never assumes
    Hermiticity."""
    stack = np.asarray(stack)
    K, N, _ = stack.shape
    eye = np.eye(N)
    Hp = np.stack([np.kron(eye, O) - np.kron(np.conj(O), eye)
                   for O in stack]).astype(np.complex128)
    if Ls is not None:
        Hp[0] += 1j * sum(np.kron(np.conj(np.asarray(L)), np.asarray(L))
                          for L in Ls)
    return Hp.astype(stack.dtype)


def plane_args(stack, P: int):
    """Zero-padded f32 (K, P, P) re/im planes of a complex operator stack."""
    stack = np.asarray(stack)
    K, N, _ = stack.shape
    Sr = np.zeros((K, P, P), dtype=np.float32)
    Si = np.zeros((K, P, P), dtype=np.float32)
    Sr[:, :N, :N] = stack.real
    Si[:, :N, :N] = stack.imag
    return Sr, Si


def _diag_rows(gen_diag, dt: float, N: int, P: int, linsolver: str):
    """Host-computed (f64, then f32) (1, P) rows of the stage solve:
    jacobi -> (dr, di, Minv_r, Minv_i), padding d = 0, Minv = 1;
    split  -> (Er, Ei) of E = exp((dt/2) d), padding E = 1."""
    if linsolver == "neumann":
        return ()
    if gen_diag is None:
        raise ValueError(f"linsolver={linsolver!r} requires gen_diag")
    d = np.zeros((P,), np.complex128)
    d[:N] = np.asarray(gen_diag, dtype=np.complex128).reshape(-1)
    if linsolver == "jacobi":
        m = 1.0 / (1.0 - 0.5 * dt * d)
        vals = (d.real, d.imag, m.real, m.imag)
    elif linsolver == "split":
        e = np.exp(0.5 * dt * d)
        vals = (e.real, e.imag)
    else:
        raise ValueError(
            f"fused kernel supports neumann/jacobi/split, got {linsolver!r}")
    return tuple(v.astype(np.float32)[None] for v in vals)


def _dot(a, b):
    """a @ b in full f32 (IEEE; never TF32)."""
    return jnp.dot(a, b, precision=lax.Precision.HIGHEST,
                   preferred_element_type=jnp.float32)


def _dot_bt(a, b):
    """a @ b^T in full f32."""
    return lax.dot_general(a, b, (((1,), (1,)), ((), ())),
                           precision=lax.Precision.HIGHEST,
                           preferred_element_type=jnp.float32)


def _dot_at(a, b):
    """a^T @ b in full f32."""
    return lax.dot_general(a, b, (((0,), (0,)), ((), ())),
                           precision=lax.Precision.HIGHEST,
                           preferred_element_type=jnp.float32)


def _loop(stop, body, init, start=0):
    """fori_loop over stage iterations: the kernel's code size, and so its
    Triton compile time, stays independent of the iteration count."""
    return lax.fori_loop(jnp.int32(start), jnp.int32(stop), body, init)


def _stage_fwd(T, xr, xi, *, dt, iters, jac, split):
    """One forward IMR step on (re, im) value planes; T(vr, vi) applies the
    generator -i H(t)."""
    a = dt / 2.0
    if split is not None:
        er, ei = split
        xr, xi = er * xr - ei * xi, er * xi + ei * xr
    br, bi = T(xr, xi)
    nxt = _next_iterate(T, br, bi, a, jac)
    k0 = (br, bi) if jac is None else _minv(jac, br, bi)
    kr, ki = _loop(iters, lambda _, k: nxt(*k), k0)
    xr, xi = xr + dt * kr, xi + dt * ki
    if split is not None:
        xr, xi = er * xr - ei * xi, er * xi + ei * xr
    return xr, xi


def _minv(jac, vr, vi):
    """Multiply by Minv = 1/(1 - a d) (Jacobi preconditioner)."""
    _, _, mr, mi = jac
    return mr * vr - mi * vi, mi * vr + mr * vi


def _next_iterate(T, br, bi, a, jac):
    """k -> b + a T(k) (neumann) or Minv (b + a (T(k) - d k)) (jacobi)."""
    if jac is None:
        def nxt(kr, ki):
            mr, mi = T(kr, ki)
            return br + a * mr, bi + a * mi
        return nxt
    dr, di, _, _ = jac

    def nxt(kr, ki):
        tr, ti = T(kr, ki)
        return _minv(jac, br + a * (tr - (dr * kr - di * ki)),
                     bi + a * (ti - (dr * ki + di * kr)))
    return nxt


def _stage_bwd(T, Tt, pair, ks, xpr, xpi, gr, gi, *, dt, iters, jac, split):
    """Exact real-arithmetic transpose of one _stage_fwd step. (gr, gi) is
    the cotangent of the post-step state, (xpr, xpi) the pre-step state.
    The stage iterates k_0..k_{iters-1} are replayed into the scratch
    (store, load, barrier) = ks. pair(c, u) maps a (cotangent at T's
    output, value at T's input) pair to its plane-cotangent contribution.
    Returns the cotangent of the pre-step state and the step's
    (P, P) re/im plane cotangent of H."""
    store, load, barrier = ks
    if split is not None:
        er, ei = split

        def rot_t(vr, vi):      # E^T: rotation by the negated angle
            return er * vr + ei * vi, er * vi - ei * vr

        gr, gi = rot_t(gr, gi)
        xpr, xpi = er * xpr - ei * xpi, er * xpi + ei * xpr
    a = dt / 2.0
    br, bi = T(xpr, xpi)
    nxt = _next_iterate(T, br, bi, a, jac)
    k0 = (br, bi) if jac is None else _minv(jac, br, bi)
    store(0, k0)

    def replay(j, k):
        k = nxt(*k)
        store(j, k)
        return k

    _loop(iters, replay, k0, start=1)
    barrier()

    if jac is None:
        def kb_in(kbr, kbi):        # cotangent of b + a T(k): identity on b
            return kbr, kbi
    else:
        _, _, mr, mi = jac

        def kb_in(kbr, kbi):        # transpose of Minv: multiply by conj
            return mr * kbr + mi * kbi, mr * kbi - mi * kbr

    def transpose(s, c):            # k_j = f(b, k_{j-1}), j = iters..1
        kbr, kbi, bbr, bbi, hr, hi = c
        wr, wi = kb_in(kbr, kbi)
        ur, ui = a * wr, a * wi
        pr, pi_ = load(iters - 1 - s)
        dhr, dhi = pair(ur, ui, pr, pi_)
        t1r, t1i = Tt(ur, ui)
        if jac is not None:         # - a d k: transpose multiplies conj(d)
            dr, di, _, _ = jac
            t1r = t1r - (dr * ur + di * ui)
            t1i = t1i - (dr * ui - di * ur)
        return (t1r, t1i, bbr + wr, bbi + wi, hr + dhr, hi + dhi)

    P = gr.shape[-1]
    zero_h = jnp.zeros((P, P), jnp.float32)
    kbr, kbi, bbr, bbi, hr, hi = _loop(
        iters, transpose, (dt * gr, dt * gi, jnp.zeros_like(gr),
                           jnp.zeros_like(gi), zero_h, zero_h))
    barrier()
    ur, ui = kb_in(kbr, kbi)        # k_0 = b or Minv b
    bbr, bbi = bbr + ur, bbi + ui
    dhr, dhi = pair(bbr, bbi, xpr, xpi)     # b = T(x_pre)
    tr, ti = Tt(bbr, bbi)
    outr, outi = gr + tr, gi + ti
    if split is not None:
        outr, outi = rot_t(outr, outi)
    return (outr, outi), (hr + dhr, hi + dhi)


def _contract(c_ref, t, Sr_ref, Si_ref, Ke):
    """This step's planes H = sum_k c[t, k] S_k (Ke static, unrolled)."""
    Hr = c_ref[t, 0] * Sr_ref[0]
    Hi = c_ref[t, 0] * Si_ref[0]
    for k in range(1, Ke):
        Hr = Hr + c_ref[t, k] * Sr_ref[k]
        Hi = Hi + c_ref[t, k] * Si_ref[k]
    return Hr, Hi


def _generator(Hr, Hi):
    """T(v) = -i H v and its real transpose on row-stacked state planes
    (rows times H^T)."""
    def T(vr, vi):
        ar = _dot_bt(vr, Hr) - _dot_bt(vi, Hi)
        ai = _dot_bt(vr, Hi) + _dot_bt(vi, Hr)
        return ai, -ar

    def Tt(ur, ui):
        return _dot(ur, Hi) - _dot(ui, Hr), _dot(ur, Hr) + _dot(ui, Hi)

    return T, Tt


def _plane_pair(cr, ci, ur, ui):
    """Plane cotangent of H from one use of T(u) = -i H u (rows times H^T)
    whose output cotangent is c."""
    return (_dot_at(cr, ui) - _dot_at(ci, ur),
            _dot_at(cr, ur) + _dot_at(ci, ui))


def _split_rows(rows, linsolver):
    if linsolver == "jacobi":
        return tuple(rows), None
    if linsolver == "split":
        return None, tuple(rows)
    return None, None


def make_fused_propagate(stack, dt: float, iters: int, ninit: int,
                         gen_diag=None, linsolver: str = "neumann",
                         interpret: bool = False):
    """Build propagate(Sr, Si, x0, C) -> (xT, hist) on the fused kernels.

    stack: (K, N, N) complex operator stack (shape and K only; the planes
    are passed as Sr/Si = plane_args(stack, P) so large stacks can be
    threaded as arguments). x0: complex (B, N) flat states; C: (ntime, K)
    real coefficient rows. Returns the final states (B, N) and the
    post-step history (ntime, B, N), differentiable in x0 and C.
    `interpret=True` runs the kernels in the Pallas interpreter (tests on
    a CPU only)."""
    K, N, _ = np.shape(stack)
    dt, iters = float(dt), int(iters)
    P, Bp, Ke = fused_shape(N, ninit, K, linsolver)
    if not fused_admits(N, ninit, K, linsolver):
        raise ValueError(
            f"fused kernel does not admit dim={N}, ninit={ninit}, K={K}: "
            f"2*{Ke}*{P}^2 f32 stack bytes must fit {_BLOCK_SMEM_BYTES} "
            f"and the padded batch {Bp} at most {_MAX_ROWS} rows")
    rows_np = _diag_rows(gen_diag, dt, N, P, linsolver)
    n_rows = len(rows_np)
    diag_slot = None
    if linsolver == "split":
        d = np.zeros((P,), np.complex128)
        d[:N] = np.asarray(gen_diag, dtype=np.complex128).reshape(-1)
        h = 1j * d      # the H-plane form of the generator diagonal
        diag_slot = (np.diag(h.real).astype(np.float32),
                     np.diag(h.imag).astype(np.float32))
    Kp = _pow2(Ke, 1)
    params = pltriton.CompilerParams(num_warps=4, num_stages=1)
    stage = dict(dt=dt, iters=iters)
    # the interpreter runs one program sequentially and has no barrier
    barrier = (lambda: None) if interpret else pltriton.debug_barrier

    def _ext(Sr, Si):
        Sr = Sr.astype(jnp.float32)
        Si = Si.astype(jnp.float32)
        if diag_slot is not None:
            Sr = jnp.concatenate([Sr, -jnp.asarray(diag_slot[0])[None]])
            Si = jnp.concatenate([Si, -jnp.asarray(diag_slot[1])[None]])
        return Sr, Si

    def _pad_C(C):
        Cp = jnp.zeros((C.shape[0], Kp), jnp.float32)
        Cp = Cp.at[:, :K].set(C.astype(jnp.float32))
        if diag_slot is not None:
            Cp = Cp.at[:, K].set(1.0)
        return Cp

    def _pack(x0):
        B = x0.shape[0]
        z = jnp.zeros((Bp, P), jnp.float32)
        return (z.at[:B, :N].set(jnp.real(x0).astype(jnp.float32)),
                z.at[:B, :N].set(jnp.imag(x0).astype(jnp.float32)))

    def _unpack(ar, ai, B, dtype):
        return (ar[..., :B, :N] + 1j * ai[..., :B, :N]).astype(dtype)

    def fwd_kernel(Sr_ref, Si_ref, c_ref, x0r_ref, x0i_ref, *refs):
        jac, split = _split_rows([r[...] for r in refs[:n_rows]], linsolver)
        xr_ref, xi_ref, hr_ref, hi_ref = refs[n_rows:]
        ntime = c_ref.shape[0]

        def body(t, carry):
            T, _ = _generator(*_contract(c_ref, t, Sr_ref, Si_ref, Ke))
            xr, xi = _stage_fwd(T, *carry, jac=jac, split=split, **stage)
            hr_ref[t] = xr
            hi_ref[t] = xi
            return xr, xi

        xr, xi = lax.fori_loop(jnp.int32(0), jnp.int32(ntime), body,
                               (x0r_ref[...], x0i_ref[...]))
        xr_ref[...] = xr
        xi_ref[...] = xi

    def bwd_kernel(Sr_ref, Si_ref, c_ref, hr_ref, hi_ref, jr_ref, ji_ref,
                   gTr_ref, gTi_ref, x0r_ref, x0i_ref, *refs):
        jac, split = _split_rows([r[...] for r in refs[:n_rows]], linsolver)
        gr_ref, gi_ref, cb_ref, ksr_ref, ksi_ref = refs[n_rows:]
        ntime = c_ref.shape[0]
        lane = lax.broadcasted_iota(jnp.int32, (1, Kp), 1)

        def store(j, k):
            ksr_ref[j] = k[0]
            ksi_ref[j] = k[1]

        def load(j):
            return ksr_ref[j], ksi_ref[j]

        # the replayed iterates go through memory: threads must see each
        # other's writes before the transposed loop reads them, and finish
        # reading before the next step overwrites them
        ks = (store, load, barrier)

        def body(s, carry):
            t = ntime - 1 - s
            tp = jnp.maximum(t - 1, 0)
            first = t == 0
            xpr = jnp.where(first, x0r_ref[...], hr_ref[tp])
            xpi = jnp.where(first, x0i_ref[...], hi_ref[tp])
            gr = carry[0] + jr_ref[t]
            gi = carry[1] + ji_ref[t]
            T, Tt = _generator(*_contract(c_ref, t, Sr_ref, Si_ref, Ke))
            out, (Hbr, Hbi) = _stage_bwd(T, Tt, _plane_pair, ks, xpr, xpi,
                                         gr, gi, jac=jac, split=split,
                                         **stage)
            row = jnp.zeros((1, Kp), jnp.float32)
            for k in range(Ke):
                v = jnp.sum(Hbr * Sr_ref[k]) + jnp.sum(Hbi * Si_ref[k])
                row = row + jnp.where(lane == k, v, 0.0)
            cb_ref[pl.ds(t, 1), :] = row
            return out

        gr, gi = lax.fori_loop(jnp.int32(0), jnp.int32(ntime), body,
                               (gTr_ref[...], gTi_ref[...]))
        gr_ref[...] = gr
        gi_ref[...] = gi

    def _call(kernel, out_shape, name):
        return pl.pallas_call(kernel, out_shape=out_shape, backend="triton",
                              compiler_params=params, interpret=interpret,
                              name=name)

    def _run_forward(Sr, Si, x0, C):
        ntime = C.shape[0]
        plane = jax.ShapeDtypeStruct((Bp, P), jnp.float32)
        hist = jax.ShapeDtypeStruct((ntime, Bp, P), jnp.float32)
        xr0, xi0 = _pack(x0)
        xr, xi, hr, hi = _call(fwd_kernel, (plane, plane, hist, hist),
                               "fused_imr_forward")(
            *_ext(Sr, Si), _pad_C(C), xr0, xi0, *rows_np)
        B = x0.shape[0]
        return _unpack(xr, xi, B, x0.dtype), _unpack(hr, hi, B, x0.dtype), \
            (hr, hi)

    @jax.custom_vjp
    def propagate(Sr, Si, x0, C):
        xT, hist, _ = _run_forward(Sr, Si, x0, C)
        return xT, hist

    def fwd(Sr, Si, x0, C):
        xT, hist, planes = _run_forward(Sr, Si, x0, C)
        return (xT, hist), (Sr, Si, x0, C, planes)

    def bwd(res, cots):
        Sr, Si, x0, C, (hr, hi) = res
        xT_bar, hist_bar = cots
        B, ntime = x0.shape[0], C.shape[0]
        _, h_vjp = jax.vjp(lambda a, b: _unpack(a, b, B, x0.dtype), hr, hi)
        jr, ji = h_vjp(hist_bar)
        _, t_vjp = jax.vjp(lambda a, b: _unpack(a, b, B, x0.dtype),
                           hr[-1], hi[-1])
        gTr, gTi = t_vjp(xT_bar)
        plane = jax.ShapeDtypeStruct((Bp, P), jnp.float32)
        crow = jax.ShapeDtypeStruct((ntime, Kp), jnp.float32)
        scratch = jax.ShapeDtypeStruct((max(iters, 1), Bp, P), jnp.float32)
        gr, gi, Cb, _, _ = _call(bwd_kernel,
                                 (plane, plane, crow, scratch, scratch),
                                 "fused_imr_adjoint")(
            *_ext(Sr, Si), _pad_C(C), hr, hi, jr, ji, gTr, gTi,
            *_pack(x0), *rows_np)
        _, p_vjp = jax.vjp(_pack, x0)
        (x0_bar,) = p_vjp((gr, gi))
        return (jnp.zeros_like(Sr), jnp.zeros_like(Si), x0_bar,
                Cb[:, :K].astype(C.dtype))

    propagate.defvjp(fwd, bwd)
    return propagate
