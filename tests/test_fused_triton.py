"""The fused GPU time-loop kernels (ops/fused_triton.py), run here in the
Pallas interpreter against the plain XLA scan of the same IMR step
(ops/steppers.make_step_fn): forward states and history, and the
hand-written adjoint's gradients with respect to the initial states and the
coefficient rows. The compiled kernels are run on the card by
chip_smoke.py and by the `gpu`-marked test below."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quandary_tpu.ops import fused_triton as ft
from quandary_tpu.ops.steppers import make_step_fn


def _system(N, K, open_, seed):
    """Random operator stack with a static diagonal (controls are purely
    off-diagonal, as in every HamiltonianModel) and its generator
    diagonal. open_: the vec(rho) pseudo-Hamiltonian of an N-level system
    with decay, state dimension N^2."""
    rng = np.random.default_rng(seed)
    if open_:
        stack = np.zeros((K, N, N), np.complex128)
        stack[0] = np.diag(rng.uniform(-2, 2, N))
        for k in range(1, K):
            A = rng.normal(size=(N, N)) + 1j * rng.normal(size=(N, N))
            A = A + A.conj().T
            np.fill_diagonal(A, 0)
            stack[k] = 0.5 * A
        L = np.diag(np.sqrt(rng.uniform(0.01, 0.1, N - 1)), 1)
        stack[0] = stack[0] - 0.5j * (L.conj().T @ L)
        S = ft.lindblad_prime_stack(stack, [L])
    else:
        S = np.zeros((K, N, N), np.complex128)
        S[0] = np.diag(rng.uniform(-3, 3, N))
        for k in range(1, K):
            A = rng.normal(size=(N, N)) + 1j * rng.normal(size=(N, N))
            A = A + A.conj().T
            np.fill_diagonal(A, 0)
            S[k] = 0.5 * A
    gen_diag = -1j * np.diagonal(S[0])
    return S, gen_diag


def _reference(S, dt, iters, linsolver, gen_diag):
    stack = jnp.asarray(S)

    def rhs(c, x):
        return -1j * (x @ jnp.tensordot(c.astype(x.dtype), stack, 1).T)

    step = make_step_fn(rhs, dt, "IMR", iters, linsolver,
                        gen_diag=None if linsolver == "neumann" else gen_diag)

    def propagate(x0, C):
        def body(x, c):
            x = step(x, c[None])
            return x, x
        return jax.lax.scan(body, x0, C)

    return propagate


def _case(N, B, ntime, linsolver, open_, K=3, iters=4, seed=0,
          interpret=True):
    S, gd = _system(N, K, open_, seed)
    dim = S.shape[1]
    rng = np.random.default_rng(seed + 1)
    x0 = rng.normal(size=(B, dim)) + 1j * rng.normal(size=(B, dim))
    x0 /= np.linalg.norm(x0, axis=1, keepdims=True)
    C = np.concatenate([np.ones((ntime, 1)),
                        rng.uniform(-1, 1, (ntime, K - 1))], axis=1)
    dt = 0.05
    P, _, _ = ft.fused_shape(dim, B, K, linsolver)
    Sr, Si = ft.plane_args(S, P)
    prop = ft.make_fused_propagate(S, dt, iters, B, gen_diag=gd,
                                   linsolver=linsolver, interpret=interpret)
    ref = _reference(S, dt, iters, linsolver, gd)
    # positive terms only, so the value check has no cancellation; y1 gives
    # the final-state cotangent an arbitrary phase
    y1 = rng.normal(size=(B, dim)) + 1j * rng.normal(size=(B, dim))
    w1 = rng.uniform(0.5, 1.5, (B, dim))
    w2 = rng.uniform(0.5, 1.5, (ntime, B, dim))

    def loss(out):
        xT, hist = out
        return (jnp.sum(w1 * jnp.abs(xT - y1) ** 2)
                + jnp.sum(w2 * jnp.abs(hist) ** 2))

    x0_32 = jnp.asarray(x0, jnp.complex64)
    C32 = jnp.asarray(C, jnp.float32)
    f_k = lambda x, c: loss(prop(Sr, Si, x, c))
    f_r = lambda x, c: loss(ref(x, c))
    return f_k, f_r, x0_32, C32, jnp.asarray(x0), jnp.asarray(C), \
        (prop, ref, Sr, Si)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("open_", [False, True], ids=["closed", "open"])
@pytest.mark.parametrize("linsolver", ["neumann", "jacobi", "split"])
def test_forward_and_gradient_match_scan(linsolver, open_):
    N = 3 if open_ else 6
    f_k, f_r, x0, C, x0d, Cd, (prop, ref, Sr, Si) = _case(
        N, 3, 7, linsolver, open_)
    xT_k, h_k = prop(Sr, Si, x0, C)
    xT_r, h_r = ref(x0d, Cd)
    assert _rel(xT_k, xT_r) < 2e-5
    assert _rel(h_k, h_r) < 2e-5
    vk, (gx_k, gc_k) = jax.value_and_grad(f_k, argnums=(0, 1))(x0, C)
    vr, (gx_r, gc_r) = jax.value_and_grad(f_r, argnums=(0, 1))(x0d, Cd)
    assert abs(float(vk) - float(vr)) <= 1e-5 * abs(float(vr))
    assert _rel(gx_k, gx_r) < 1e-4
    assert _rel(gc_k, gc_r) < 1e-4


@pytest.mark.parametrize("ntime", [1, 7, 19])
def test_step_counts(ntime):
    f_k, f_r, x0, C, x0d, Cd, _ = _case(6, 3, ntime, "split", False)
    gk = jax.grad(f_k, argnums=1)(x0, C)
    gr = jax.grad(f_r, argnums=1)(x0d, Cd)
    assert gk.shape == (ntime, 3)
    assert _rel(gk, gr) < 1e-4


@pytest.mark.parametrize("N,B", [(6, 3), (12, 5), (16, 4)])
def test_padding(N, B):
    f_k, f_r, x0, C, x0d, Cd, (prop, ref, Sr, Si) = _case(
        N, B, 5, "jacobi", False, seed=N)
    P, Bp, _ = ft.fused_shape(N, B, 3, "jacobi")
    assert P >= max(16, N) and P & (P - 1) == 0
    assert Bp >= max(16, B) and Bp & (Bp - 1) == 0
    xT, hist = prop(Sr, Si, x0, C)
    assert xT.shape == (B, N) and hist.shape == (5, B, N)
    gx_k = jax.grad(f_k)(x0, C)
    gx_r = jax.grad(f_r)(x0d, Cd)
    assert _rel(gx_k, gx_r) < 1e-4


def test_vmap_over_candidates_matches_loop():
    f_k, _, x0, C, _, _, _ = _case(6, 3, 7, "neumann", False)
    rng = np.random.default_rng(5)
    Cs = C[None] * jnp.asarray(rng.uniform(0.5, 1.5, (3, 1, 1)), C.dtype)
    vg = jax.value_and_grad(f_k, argnums=1)
    vb, gb = jax.vmap(vg, in_axes=(None, 0))(x0, Cs)
    for e in range(3):
        v, g = vg(x0, Cs[e])
        np.testing.assert_allclose(vb[e], v, rtol=1e-6)
        np.testing.assert_allclose(gb[e], g, rtol=1e-5, atol=1e-7)


def test_stack_cotangents_are_zero():
    _, _, x0, C, _, _, (prop, _, Sr, Si) = _case(6, 3, 4, "neumann", False)
    Sr, Si = jnp.asarray(Sr), jnp.asarray(Si)
    g = jax.grad(lambda a, b: jnp.sum(jnp.abs(prop(a, b, x0, C)[0]) ** 2),
                 argnums=(0, 1))(Sr, Si)
    assert not np.any(np.asarray(g[0])) and not np.any(np.asarray(g[1]))


def test_admission_bound():
    assert ft.fused_admits(16, 4, 5, "split")
    # open guarded CNOT: vec(rho) of dimension 256 does not fit a block
    assert not ft.fused_admits(256, 16, 5, "neumann")
    assert not ft.fused_admits(16, 200, 5, "neumann")
    with pytest.raises(ValueError, match="does not admit"):
        ft.make_fused_propagate(np.zeros((5, 256, 256)), 0.1, 3, 4)
    with pytest.raises(ValueError, match="requires gen_diag"):
        ft.make_fused_propagate(np.zeros((2, 4, 4)), 0.1, 3, 2,
                                linsolver="jacobi")


@pytest.mark.gpu
def test_compiled_kernel_matches_scan_on_gpu(gpu):
    f_k, f_r, x0, C, x0d, Cd, _ = _case(16, 4, 19, "split", False, K=5,
                                         interpret=False)
    vk, gk = jax.value_and_grad(f_k, argnums=1)(x0, C)
    vr, gr = jax.value_and_grad(f_r, argnums=1)(x0d, Cd)
    assert abs(float(vk) - float(vr)) <= 1e-5 * abs(float(vr))
    assert _rel(gk, gr) < 1e-4


# ---------------------------------------------------------------------------
# Problem level: the fused path against the XLA engines on the same Setup
# ---------------------------------------------------------------------------

def _small_setup(lindblad=False, linsolver="neumann", stiff=False):
    from quandary_tpu.models import gates
    from quandary_tpu.models.hamiltonian import build_standard_model
    from quandary_tpu.problem import Setup
    from quandary_tpu.utils.splines import ControlSegment, OscillatorControl
    # open: two qubits, vec(rho) of dimension 16 fits the kernel
    nlev, ness = ([2, 2] if lindblad else [3, 3]), [2, 2]
    freq = [4.8, 4.9]
    kerr = [0.22, 0.23] if not stiff else [2.5, 2.6]
    model = build_standard_model(
        nlevels=nlev, freq01_ghz=freq, rotfreq_ghz=freq, selfkerr_ghz=kerr,
        jkl_ghz=[0.005], crosskerr_ghz=[],
        decay_time=[30.0, 35.0] if lindblad else [],
        dephase_time=[20.0, 25.0] if lindblad else [], lindblad=lindblad)
    T, ntime = 12.0, 24
    oscs = tuple(OscillatorControl(
        segments=(ControlSegment("spline", nsplines=6, tstart=0.0, tstop=T),),
        carrier_freqs=(0.0,)) for _ in range(2))
    V = gates.assemble_gate(gates.cnot(), nlev, ness, [0.0, 0.0], T)
    return Setup(
        model=model, nessential=tuple(ness), ntime=ntime, dt=T / ntime,
        oscillators=oscs, ground_freqs_radns=tuple(2 * np.pi * f for f in freq),
        initcond_type="basis", target_type="gate", target_gate_full=V,
        objective_type="Jtrace", gamma_tik=1e-4, gamma_penalty=0.1,
        gamma_penalty_energy=0.1,
        gamma_penalty_dpdm=0.0 if lindblad else 0.01,
        dtype=jnp.complex64, linsolve_iters=4, linsolver=linsolver,
        time_parallel=False)


@pytest.mark.parametrize("case", [
    dict(), dict(lindblad=True), dict(linsolver="jacobi", stiff=True),
    dict(linsolver="split")], ids=["closed", "open", "stiff-jacobi", "split"])
def test_problem_fused_matches_scan(fused_on_cpu, case):
    from quandary_tpu.problem import Problem
    setup = _small_setup(**case)
    pf = Problem(dataclasses.replace(setup, pallas=True))
    ps = Problem(dataclasses.replace(setup, pallas=False))
    assert pf.use_pallas and not ps.use_pallas
    assert pf.linsolver == ps.linsolver
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.uniform(-1, 1, setup.nparams) * 0.02, jnp.float32)
    (Jf, af), gf = pf.build_value_and_grad()(x, x)
    (Js, as_), gs = ps.build_value_and_grad()(x, x)
    assert abs(float(Jf) - float(Js)) <= 1e-5 * abs(float(Js))
    assert _rel(gf, gs) < 1e-4
    assert abs(float(af["fidelity"]) - float(as_["fidelity"])) < 1e-5
