"""The XLA engines against each other on one Setup (sequential scan with
stored states, reversible adjoint, time-parallel propagators, host-driven
stepping, the ensemble vmap), the big-array threading of the compiled entry
points, and the backend policy that picks the kernel and the optimiser
driver (quandary_tpu/backend.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from quandary_tpu import backend
from quandary_tpu.models import gates
from quandary_tpu.models.hamiltonian import build_standard_model
from quandary_tpu.ops.hostloop import HostLoopRunner
from quandary_tpu.problem import Problem, Setup
from quandary_tpu.utils.splines import ControlSegment, OscillatorControl


def _setup(lindblad=False, linsolver="neumann", **kw):
    Ne, nlevels = [2, 2], [3, 2]
    freq01 = [4.8, 5.1]
    model = build_standard_model(
        nlevels=nlevels, freq01_ghz=freq01, rotfreq_ghz=[4.79, 5.09],
        selfkerr_ghz=[0.22, 0.25], crosskerr_ghz=[0.01], jkl_ghz=[0.005],
        decay_time=[100.0, 80.0] if lindblad else [],
        dephase_time=[50.0, 60.0] if lindblad else [], lindblad=lindblad)
    T, ntime = 10.0, 40
    oscs = tuple(OscillatorControl(
        segments=(ControlSegment("spline", nsplines=5, tstart=0.0, tstop=T),),
        carrier_freqs=(0.0, 2 * np.pi * 0.05)) for _ in range(2))
    V = gates.assemble_gate(gates.cnot(), nlevels, Ne, [0.0, 0.0], T)
    fields = dict(
        model=model, nessential=tuple(Ne), ntime=ntime, dt=T / ntime,
        oscillators=oscs, ground_freqs_radns=tuple(2 * np.pi * f
                                                   for f in freq01),
        initcond_type="basis", target_type="gate", target_gate_full=V,
        objective_type="Jtrace", gamma_tik=1e-4, gamma_penalty=0.1,
        gamma_penalty_energy=0.1, linsolve_iters=12, linsolver=linsolver,
        time_parallel=False)
    fields.update(kw)
    return Setup(**fields)


def _params(setup, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.uniform(-1, 1, setup.nparams) * 0.05)


def _vg(setup, p):
    (J, _), g = Problem(setup).build_value_and_grad()(p, p)
    return float(J), np.asarray(g)


def _close(a, b, tol):
    (Ja, ga), (Jb, gb) = a, b
    assert abs(Ja - Jb) <= tol * abs(Jb)
    assert np.linalg.norm(ga - gb) <= tol * np.linalg.norm(gb)


@pytest.mark.parametrize("linsolver", ["neumann", "jacobi", "split"])
def test_reversible_adjoint_matches_stored_states(linsolver):
    setup = _setup(linsolver=linsolver)
    p = _params(setup)
    rev = _vg(dataclasses.replace(setup, adjoint="reversible"), p)
    remat = _vg(dataclasses.replace(setup, adjoint="remat"), p)
    _close(rev, remat, 1e-8)


@pytest.mark.parametrize("lindblad", [False, True], ids=["closed", "open"])
@pytest.mark.parametrize("linsolver", ["neumann", "jacobi"])
def test_time_parallel_matches_scan(linsolver, lindblad):
    setup = _setup(lindblad, linsolver, adjoint="remat")
    tp = Problem(dataclasses.replace(setup, time_parallel=True))
    assert tp.time_parallel
    p = _params(setup, 1)
    (J, _), g = tp.build_value_and_grad()(p, p)
    _close((float(J), np.asarray(g)), _vg(setup, p), 1e-9)


@pytest.mark.parametrize("lindblad", [False, True], ids=["closed", "open"])
@pytest.mark.parametrize("linsolver", ["neumann", "jacobi", "split"])
def test_host_loop_matches_scan(linsolver, lindblad):
    prob = Problem(_setup(lindblad, linsolver))
    p = _params(prob.setup, 2)
    x_scan = np.asarray(prob.build_propagate_final()(p))
    x_host, _ = HostLoopRunner(prob).forward(p)
    assert np.abs(np.asarray(x_host) - x_scan).max() < 1e-12


@pytest.mark.parametrize("lindblad", [False, True], ids=["closed", "open"])
def test_ensemble_vmap_matches_per_candidate(lindblad):
    setup = _setup(lindblad, "jacobi")
    prob = Problem(setup)
    rng = np.random.default_rng(3)
    Ps = jnp.asarray(rng.uniform(-1, 1, (3, setup.nparams)) * 0.05)
    ref = jnp.zeros(setup.nparams)
    (Je, _), ge = prob.build_ensemble_value_and_grad()(Ps, ref)
    vg = prob.build_value_and_grad()
    for e in range(3):
        (J, _), g = vg(Ps[e], ref)
        np.testing.assert_allclose(float(Je[e]), float(J), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(ge[e]), np.asarray(g),
                                   rtol=1e-10, atol=1e-14)


def test_big_arrays_threaded_as_arguments():
    """With every array above the threshold, the compiled entry point
    passes them as device arguments and must equal the embedded-constant
    program."""
    prob = Problem(_setup(True, "jacobi"))
    p = _params(prob.setup, 4)
    want = jax.jit(jax.value_and_grad(prob.objective, has_aux=True))(p, p)
    prob._BIG_THRESHOLD = 1
    assert {name for _, name in prob._big_slots()} >= {"x0", "target",
                                                      "stack"}
    got = prob.build_value_and_grad()(p, p)
    np.testing.assert_allclose(float(got[0][0]), float(want[0][0]),
                               rtol=1e-13)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               rtol=1e-11, atol=1e-15)


# ---------------------------------------------------------------------------
# backend policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("setting,eligible,lindblad,tp,gpu,want", [
    ("auto", True, False, False, False, False),  # no GPU: the XLA scan
    ("auto", True, False, False, True, True),    # measured faster: closed
    ("auto", True, False, True, True, False),    # time-parallel wins at E=1
    ("auto", True, True, False, True, False),    # open: not measured faster
    ("auto", False, False, False, True, False),
    (False, True, False, False, True, False),
    (True, True, True, True, True, True),
])
def test_fused_kernel_policy(monkeypatch, setting, eligible, lindblad, tp,
                             gpu, want):
    monkeypatch.setattr(backend, "on_gpu", lambda: gpu)
    assert backend.use_fused_kernel(setting, eligible, lindblad, tp) is want


def test_auto_keeps_time_parallel_and_forced_kernel_replaces_it(monkeypatch):
    monkeypatch.setattr(backend, "on_gpu", lambda: True)
    setup = _setup(linsolver="jacobi", dtype=jnp.complex64,
                   time_parallel="auto")
    auto = Problem(setup)
    assert auto.time_parallel and not auto.use_pallas
    forced = Problem(dataclasses.replace(setup, pallas=True))
    assert forced.use_pallas and not forced.time_parallel
    split = Problem(dataclasses.replace(setup, linsolver="split"))
    assert split.use_pallas and not split.time_parallel


def test_fused_kernel_forced_off_gpu_raises_with_backend():
    with pytest.raises(ValueError, match="'cpu'"):
        backend.use_fused_kernel(True, True, False, False)
    with pytest.raises(ValueError, match="pallas=True needs a GPU"):
        Problem(dataclasses.replace(_setup(), dtype=jnp.complex64,
                                    pallas=True))


def test_fused_kernel_forced_on_ineligible_problem_raises(monkeypatch):
    monkeypatch.setattr(backend, "on_gpu", lambda: True)
    # complex128 is not eligible: the kernel is f32
    with pytest.raises(ValueError, match="takes only"):
        Problem(dataclasses.replace(_setup(), pallas=True))


@pytest.mark.parametrize("setting,gpu,want", [
    ("auto", False, "host"), ("auto", True, "device"),
    ("host", True, "host"), ("device", False, "device")])
def test_optimizer_driver_policy(monkeypatch, setting, gpu, want):
    monkeypatch.setattr(backend, "on_gpu", lambda: gpu)
    assert backend.optimizer_driver(setting) == want


def test_optimizer_driver_rejects_unknown():
    with pytest.raises(ValueError, match="auto|host|device"):
        backend.optimizer_driver("tao")
