import os

# Tests run on the CPU, on a virtual 8-device mesh with float64 enabled:
# correctness/parity tests need f64, and the multi-device sharding tests
# need several devices. JAX_PLATFORMS=cuda runs them on a GPU instead, which
# is how the tests marked `gpu` (compiled kernels) run on the card:
#     JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_enable_x64", True)

import pytest

# -m quick: the <5-minute dev tier — ONE representative per feature family
# (engines, steppers, kernels, optimizers, IO, parallelism, goldens). The
# full suite stays the CI/judging tier; curate here, not with per-file
# marks, so the tier is visible in one place.
QUICK_NODE_PREFIXES = (
    "tests/test_indexing.py",
    "tests/test_configfile.py",
    "tests/test_native.py",
    "tests/test_control_kinds.py",
    "tests/test_api.py::test_get_results_roundtrip",
    "tests/test_api.py::test_get_results_lindblad_diagonal_uT",
    "tests/test_fuzz_gradient.py::test_fuzz_fd_gradient[4]",
    "tests/test_gradient_fd.py::test_fd_gradient[True-Jtrace]",
    "tests/test_solver_schroedinger.py::test_time_dependent_control_vs_scipy",
    "tests/test_solver_schroedinger.py::test_convergence_order[IMR-2]",
    "tests/test_lindblad.py::test_lindblad_vs_vectorized_expm",
    "tests/test_split_stepper.py::test_split_matches_expm_second_order",
    "tests/test_split_stepper.py::test_split_gradient_fd",
    "tests/test_jacobi_solver.py",
    "tests/test_tensor_engine.py::test_tensor_vs_dense_rhs",
    "tests/test_grouped_lindblad.py::test_rhs_matches_tensor_engine",
    "tests/test_grouped_adjoint.py::test_matches_finite_differences",
    "tests/test_fused_triton.py::test_forward_and_gradient_match_scan",
    "tests/test_engines.py",
    "tests/test_sharding.py::test_ensemble_sharded_matches_unsharded",
    "tests/test_checkpoint.py::test_kill_and_resume_reproduces_uninterrupted_run",
    "tests/test_device_driver.py::test_device_driver_maxiter_respected",
    "tests/test_wolfe.py::test_rosenbrock_active_bounds_wolfe",
    "tests/test_optimize.py::test_state_to_state_transfer",
    "tests/test_robust.py::test_robust_gradient_is_weighted_sum",
    "tests/test_golden_regression.py::test_xgate_sparsemat_grad",
    "tests/test_reversible.py",
    "tests/test_time_parallel.py",
)


def pytest_collection_modifyitems(config, items):
    for item in items:
        if any(item.nodeid.startswith(p) for p in QUICK_NODE_PREFIXES):
            item.add_marker(pytest.mark.quick)


@pytest.fixture
def gpu():
    """Skip unless the tests run on a GPU (JAX_PLATFORMS=cuda): the tests
    that take it run the compiled kernels, which have no CPU form."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda on the card")


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """Let Problem select the fused GPU kernel on the CPU: the backend
    reports a GPU and the kernel builder runs in the Pallas interpreter.
    The parity tests of the fused path use it."""
    from quandary_tpu import backend
    from quandary_tpu.ops import fused_triton as ft
    monkeypatch.setattr(backend, "on_gpu", lambda: True)
    build = ft.make_fused_propagate
    monkeypatch.setattr(
        ft, "make_fused_propagate",
        lambda *a, **kw: build(*a, **{**kw, "interpret": True}))
