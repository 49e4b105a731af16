"""Backend policy: which propagation kernel and which optimiser driver a
run uses, decided in one place from what the code can observe -- the JAX
backend and the problem's own eligibility. The accelerator is a GPU. On
the CPU every engine is XLA's plain code and optimisation runs the host
driver."""

from __future__ import annotations

import jax


def on_gpu() -> bool:
    return jax.default_backend() == "gpu"


def use_fused_kernel(setting, eligible: bool, lindblad: bool,
                     time_parallel: bool) -> bool:
    """Whether Problem runs the fused time-loop kernel
    (ops/fused_triton.py). `setting` is Setup.pallas: 'auto' takes it on a
    GPU for eligible closed systems unless the time-parallel propagator
    runs (ops/propagator.py), the regime where it was measured faster than
    XLA (PERF.md: the flagship's split stepper at E=1 and E=128, where the
    propagator does not apply; the propagator beats it at E=1 where it
    does). True requires it and raises where it cannot run; False never
    uses it."""
    if setting == "auto":
        return eligible and on_gpu() and not lindblad and not time_parallel
    if not setting:
        return False
    if not on_gpu():
        raise ValueError(
            "pallas=True needs a GPU: the fused kernel is compiled through "
            f"Triton, and the JAX backend is {jax.default_backend()!r}")
    if not eligible:
        raise ValueError(
            "pallas=True, but the fused kernel takes only dense IMR "
            "problems in complex64 with a neumann/jacobi/split stage solve "
            "whose operator stacks fit one GPU block")
    return True


def optimizer_driver(setting: str) -> str:
    """'host' or 'device' for an optimizer setting of 'auto' | 'host' |
    'device': 'auto' keeps the iterations on the device on a GPU (one host
    fetch per chunk) and on the host driver elsewhere."""
    if setting == "auto":
        return "device" if on_gpu() else "host"
    if setting not in ("host", "device"):
        raise ValueError(f"optimizer must be auto|host|device, got {setting!r}")
    return setting
