"""Time-parallel propagation: batched step matrices + associative scan.

The dynamics are LINEAR: x_{n+1} = S_n x_n with the IMR step operator

    S_n = I + dt * K_n,   K_n = (I - dt/2 M_n)^{-1} M_n,  M_n = -i H(t_n+dt/2)

Instead of scanning sequentially over time (2*ntime dependent tiny matmuls,
latency-bound at small N), we

 1. assemble ALL step generators M_n at once (one (ntime*nstages, K) x
    (K, N, N) tensordot, one large GEMM),
 2. run the matrix Neumann recursion batched over all steps
    (K <- M + (dt/2) M K, a few (T, N, N) batched GEMMs),
 3. combine stages into per-step operators S_n,
 4. compute ALL prefix propagators P_n = S_n ... S_1 with
    `lax.associative_scan` — O(log ntime) rounds of (T, N, N) batched GEMMs,
 5. apply to the initial-condition batch: x_n = P_n x0 — every state at every
    time in two einsums, so the penalty integrals vectorize over time.

This is genuine parallel-in-time — the axis the reference reserves but stubs
out (comm_optim, main.cpp:140-143) — and it converts the whole objective
into a handful of large batched GEMMs. Feasible when ntime * N^2 state fits
memory (Schroedinger up to N ~ a few hundred; Lindblad via the N^2-dim
superoperator for small N). Numerically identical to the sequential scan
(same Neumann-IMR update; products reassociated — exact in exact arithmetic,
differs by roundoff only).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .steppers import stage_gammas


def build_step_matrices_dense(stack, C, dt: float, timestepper: str,
                              linsolve_iters: int, lindblad_superop=None,
                              gen_diag=None, linsolver: str = "neumann"):
    """All per-step IMR operators S (ntime, N, N) from coefficient rows
    C (ntime, nstages, K).

    stack: (K, N, N) complex operator stack (Schroedinger: Hermitian terms;
    generator M = -i H). For the Lindblad path pass `lindblad_superop`, a
    function building the (T, N^2, N^2) superoperator generators instead.

    linsolver='jacobi' (requires gen_diag, the (N,)- or (N*N,)-flattened
    elementwise generator diagonal) runs the matrix form of
    steppers.jacobi_neumann_solve: K <- (I-aD)^{-1}(M + a(M K - D K)) with
    (I-aD)^{-1} and D K as row scalings — same stiffness-robust contraction
    as the sequential path, so the time-parallel product stays accurate on
    Kerr-stiff steps where the plain matrix Neumann series is not.
    """
    gammas = stage_gammas(timestepper)
    ntime, nstages, K = C.shape
    explicit = timestepper.upper() == "EE"

    Cf = C.reshape(ntime * nstages, K)
    if lindblad_superop is None:
        H = jnp.tensordot(Cf.astype(stack.dtype), stack, axes=1)  # (T*S, N, N)
        M = -1j * H
    else:
        M = lindblad_superop(Cf)                                   # (T*S, N2, N2)
    N = M.shape[-1]
    eye = jnp.eye(N, dtype=M.dtype)
    use_jacobi = linsolver == "jacobi" and gen_diag is not None
    if use_jacobi:
        d = jnp.asarray(gen_diag).reshape(-1).astype(M.dtype)  # (N,)

    S_total = None
    Ms = M.reshape(ntime, nstages, N, N)
    for i, g in enumerate(gammas):
        # python float: numpy scalars are strong-typed and would upcast
        # complex64 under jax_enable_x64
        h = float(g) * float(dt)
        Mi = Ms[:, i]
        if explicit:
            Si = eye + h * Mi
        else:
            half = h / 2.0
            if use_jacobi:
                dcol = d[None, :, None]                  # rows of (t, N, N)
                minv = 1.0 / (1.0 - half * dcol)
                Kmat = minv * Mi

                def body(_, Km, Mi=Mi, minv=minv, dcol=dcol, half=half):
                    MK = jnp.einsum("tij,tjk->tik", Mi, Km)
                    return minv * (Mi + half * (MK - dcol * Km))
            else:
                Kmat = Mi

                def body(_, Km, Mi=Mi, half=half):
                    return Mi + half * jnp.einsum("tij,tjk->tik", Mi, Km)
            Kmat = jax.lax.fori_loop(0, linsolve_iters, body, Kmat)
            Si = eye + h * Kmat
        S_total = Si if S_total is None else jnp.einsum("tij,tjk->tik", Si, S_total)
    return S_total


def prefix_propagators(S):
    """P (ntime, N, N) with P_n = S_n @ ... @ S_1 via associative scan."""
    def combine(a, b):
        # a = earlier block product, b = later; result applies a first.
        return jnp.einsum("...ij,...jk->...ik", b, a)
    return jax.lax.associative_scan(combine, S, axis=0)


def propagate_states(P, x0):
    """States after every step: x_n = P_n x0.

    x0: (B, N) -> returns (ntime, B, N);
    x0: (B, N, N) column-vectorized internally by the caller for Lindblad.
    """
    return jnp.einsum("tij,bj->tbi", P, x0)


def lindblad_superop_builder(stack, Ls):
    """Return a function mapping coefficient rows (T, K) to vectorized
    Lindblad generators (T, N^2, N^2), using COLUMN-major vec(rho)
    (user_guide.md:283-302):

        L(c) = I (x) (-i Heff) - (-i Heff^dag)^T (x) I + sum_c conj(L) (x) L

    where Heff = sum_j c_j O_j already contains the -i/2 sum L^dag L fold in
    the constant slot (ops/rhs.py DenseEngine). Only for small N.
    """
    N = stack.shape[-1]
    eye = np.eye(N)
    # constant jump part sum_c conj(L) (x) L
    if Ls is not None:
        jump = sum(np.kron(np.conj(np.asarray(L)), np.asarray(L)) for L in Ls)
    else:
        jump = np.zeros((N * N, N * N), dtype=np.complex128)
    jump = jnp.asarray(jump, dtype=stack.dtype)

    # per-term superoperator stacks (real coefficients c_j):
    #   vec(Heff rho)      -> I (x) O_j
    #   vec(rho Heff^dag)  -> conj(O_j) (x) I   (column-major vec identity)
    left = np.stack([np.kron(eye, np.asarray(O)) for O in np.asarray(stack)])
    right_c = np.stack([np.kron(np.conj(np.asarray(O)), eye) for O in np.asarray(stack)])
    left = jnp.asarray(left, dtype=stack.dtype)
    right_c = jnp.asarray(right_c, dtype=stack.dtype)

    def build(Cf):
        A = jnp.tensordot(Cf.astype(left.dtype), left, axes=1)
        Bm = jnp.tensordot(Cf.astype(right_c.dtype), right_c, axes=1)
        return -1j * A + 1j * Bm + jump

    return build
