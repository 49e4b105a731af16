"""Problem assembly: from a resolved setup to differentiable objective /
simulation functions.

This module is the JAX counterpart of the reference call stack
main.cpp -> OptimProblem::evalF/evalGradF -> TimeStepper::solveODE ->
MasterEq::assemble_RHS (SURVEY.md section 3.1). The entire multi-initial-
condition objective — forward propagation of the whole batch, final-time cost,
fidelity, all four penalty integrals and both regularizers — is ONE pure
function of the control parameter vector. `jax.value_and_grad` of it is the
discrete adjoint (including the Schroedinger two-phase coupling through
|sum_i overlap_i|^2 that the reference handles with a second adjoint loop,
optimproblem.cpp:494-519 — here it falls out of AD automatically).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .models.controls import (
    control_variation_penalty,
    eval_controls,
    eval_controls_labframe,
)
from .models.hamiltonian import HamiltonianModel
from .models import initialconditions as ic
from .ops.rhs import DenseEngine
from .ops.steppers import make_step_fn, stage_midpoint_times
from .ops import solvers
from .utils.indexing import guard_mask
from .utils.splines import ControlEvalPlan, OscillatorControl, build_control_plan


@dataclasses.dataclass
class Setup:
    """Fully-resolved problem specification in internal units (rad/ns, ns)."""
    model: HamiltonianModel
    nessential: Tuple[int, ...]
    ntime: int
    dt: float
    timestepper: str = "IMR"
    linsolve_iters: int = 20
    linsolver: str = "neumann"

    oscillators: Tuple[OscillatorControl, ...] = ()
    pipulses: Optional[tuple] = None           # per-osc list of (t0, t1, amp)
    ground_freqs_radns: Tuple[float, ...] = ()

    initcond_type: str = "basis"
    initcond_ids: Tuple[int, ...] = ()
    pure_levels: Optional[Tuple[int, ...]] = None
    initial_state_ess: Optional[np.ndarray] = None   # for initcond 'file'

    target_type: str = "none"                  # 'gate' | 'pure' | 'file' | 'none'
    target_gate_full: Optional[np.ndarray] = None    # assembled full-dim V
    target_state_full: Optional[np.ndarray] = None   # full-dim target (file)
    target_batch: Optional[np.ndarray] = None        # precomputed (B, ...) targets
    pure_target_levels: Optional[Tuple[int, ...]] = None

    objective_type: str = "Jtrace"
    obj_weights: Optional[np.ndarray] = None   # un-normalized; filled/normalized here

    gamma_tik: float = 1e-4
    gamma_tik_interpolate: bool = False
    gamma_penalty: float = 0.0                 # leakage / weighted-J
    penalty_param: float = 0.0                 # 'a' of the weighted-J window
    gamma_penalty_dpdm: float = 0.0
    gamma_penalty_energy: float = 0.0
    gamma_penalty_variation: float = 0.0

    dtype: object = jnp.complex128
    # Adjoint mode for the sequential-scan path: 'remat' stores one state
    # per step and recomputes in-step work (storeFWD analog); 'reversible'
    # recomputes states by backward integration (O(1) state memory, closed
    # systems with IMR-family steppers only); 'auto' picks reversible when
    # legal. (ops/reversible.py)
    adjoint: str = "auto"
    # Fused time-loop kernel (ops/fused_triton.py, Pallas through Triton):
    # 'auto' selects it on a GPU where it was measured faster than the XLA
    # scan (quandary_tpu/backend.py); True requires it and raises off the
    # GPU or for a problem it does not admit; False never uses it.
    pallas: object = "auto"
    # Time-parallel propagation (ops/propagator.py): 'auto' enables it for
    # small dense systems where ntime * dim^2 fits comfortably in memory;
    # True forces, False disables (sequential lax.scan).
    time_parallel: object = "auto"
    time_parallel_budget: int = 1 << 27        # max ntime * dim^2 elements
    # RHS engine: 'auto' picks dense (HamiltonianModel) / tensor
    # (StructuredModel) / grouped (large Schroedinger StructuredModel);
    # 'tensor' | 'grouped' force a StructuredModel engine explicitly.
    engine: str = "auto"

    @property
    def total_time(self) -> float:
        return self.ntime * self.dt

    @property
    def nparams(self) -> int:
        return sum(o.nparams for o in self.oscillators)


class Problem:
    """Device-ready problem: precomputed plans, state batches and closures."""

    def __init__(self, setup: Setup):
        # every entry point funnels through here: wire the persistent XLA
        # compile cache so cold processes reuse prior compiles (the
        # reference binary has zero compile latency to match)
        from .utils.cache import enable_persistent_cache
        enable_persistent_cache()
        self.setup = setup
        model = setup.model
        self.model = model
        self.lindblad = model.lindblad
        self.dims = model.dims
        self.N = model.N
        s = setup

        # canonicalize against the runtime x64 state: with jax_enable_x64
        # off, a requested f64 silently truncates to f32 anyway — declare
        # what actually runs instead of warning on every zeros()
        self.rdtype = (jnp.float64
                       if s.dtype == jnp.complex128 and jax.config.jax_enable_x64
                       else jnp.float32)

        # --- engine: dense operator stack (HamiltonianModel) or matrix-free
        # per-axis contractions (StructuredModel) ---
        from .ops.tensor_rhs import StructuredModel, TensorEngine
        if isinstance(model, StructuredModel):
            use_grouped = (s.engine == "grouped" or (
                s.engine == "auto" and not model.lindblad
                and model.N >= 1 << 15))
            use_grouped_lind = (model.lindblad and len(model.dims) >= 2 and (
                s.engine == "grouped" or (
                    s.engine == "auto" and model.N >= 1 << 9)))
            if use_grouped and not model.lindblad and len(model.dims) >= 2:
                # large Schroedinger systems: matricized big-GEMM engine
                from .ops.grouped_rhs import GroupedEngine
                self.engine = GroupedEngine(model, dtype=s.dtype)
            elif use_grouped_lind:
                # large open systems: group GEMMs on the rank-4 rho view
                from .ops.grouped_lindblad import GroupedLindbladEngine
                self.engine = GroupedLindbladEngine(model, dtype=s.dtype)
            else:
                self.engine = TensorEngine(model, dtype=s.dtype)
        else:
            self.engine = DenseEngine(model, dtype=s.dtype)

        # --- time grids and control plans ---
        ntime, dt = s.ntime, s.dt
        self.ts_mid = stage_midpoint_times(ntime, dt, s.timestepper)  # (ntime, nstages)
        self.nstages = self.ts_mid.shape[1]
        self.plan_mid = build_control_plan(s.oscillators, self.ts_mid.reshape(-1))
        self.ts_stop = (np.arange(1, ntime + 1)) * dt
        self.plan_stop = build_control_plan(s.oscillators, self.ts_stop)
        self.ts_out = np.arange(ntime + 1) * dt
        self.plan_out = build_control_plan(s.oscillators, self.ts_out)

        # --- initial conditions ---
        osc_ids = s.initcond_ids if len(s.initcond_ids) > 0 else tuple(range(model.n_osc))
        x0_np, initids = ic.build_initial_states(
            s.initcond_type, model.dims, s.nessential, osc_ids, self.lindblad,
            pure_levels=s.pure_levels, from_file_state=s.initial_state_ess,
        )
        self.initids = initids
        self.ninit = x0_np.shape[0]
        # All static data is kept host-side (numpy): closed-over numpy arrays
        # are embedded as compile-time constants, big ones are threaded as
        # arguments (_wrap_with_data). The sharded multi-device path
        # replaces these with device_put arrays (parallel/mesh.py).
        npdt = np.complex64 if s.dtype == jnp.complex64 else np.complex128
        self.x0 = x0_np.astype(npdt)

        # --- objective weights (optimproblem.cpp:71-91) ---
        w = np.asarray(s.obj_weights if s.obj_weights is not None else [1.0], dtype=float)
        if w.size < self.ninit:
            w = np.concatenate([w, np.full(self.ninit - w.size, w[-1])])
        w = w[: self.ninit]
        w = w / w.sum()
        self.nprdtype = np.float32 if self.rdtype == jnp.float32 else np.float64
        self.weights = w.astype(self.nprdtype)

        # --- targets ---
        self.pure_target_id = None
        self.target = None          # (B, ...) target batch for gate/file targets
        if s.target_batch is not None:
            self.target = np.asarray(s.target_batch).astype(npdt)
        elif s.target_type == "gate" and s.target_gate_full is not None:
            V = np.asarray(s.target_gate_full, dtype=np.complex128)
            if self.lindblad:
                tgt = np.einsum("ij,bjk,lk->bil", V, x0_np, V.conj())
            else:
                tgt = np.einsum("ij,bj->bi", V, x0_np)
            self.target = tgt.astype(npdt)
        elif s.target_type in ("file", "state") \
                and s.target_state_full is not None:
            # 'state' is the direct-array spelling of the reference's
            # file-based fixed target (optimtarget.cpp:701)
            t1 = np.asarray(s.target_state_full, dtype=np.complex128)
            if self.lindblad and t1.ndim == 1:
                t1 = np.outer(t1, t1.conj())
            tgt = np.broadcast_to(t1, (self.ninit,) + t1.shape)
            self.target = np.ascontiguousarray(tgt).astype(npdt)
        elif s.target_type == "pure":
            levels = s.pure_target_levels or tuple([0] * model.n_osc)
            from .utils.indexing import flat_index
            self.pure_target_id = flat_index(levels, model.dims)
        elif s.target_type not in ("none", None):
            # an unrecognized target silently zeroing the objective cost
            # is exactly the failure mode that let XLA dead-code-eliminate
            # whole propagations in perf probes — refuse instead
            raise ValueError(
                f"target_type {s.target_type!r} provided without a usable "
                "target (expected gate/file/state/pure/none with the "
                "matching target_* field set)")

        # purity Tr(rho0^2) per initial condition (optimtarget.cpp:701-708)
        flat0 = x0_np.reshape(self.ninit, -1)
        self.purity = np.maximum(np.sum(np.abs(flat0) ** 2, axis=1),
                                 1e-300).astype(self.nprdtype)

        # --- penalty precomputations ---
        gmask = guard_mask(model.dims, s.nessential)
        self.has_guard = bool(gmask.any())
        self.guard_mask = gmask
        if s.penalty_param > 1e-13:
            a = s.penalty_param
            T = s.total_time
            self.jt_weight = ((1.0 / a) * np.exp(-(((self.ts_stop - T) / a) ** 2))
                              ).astype(self.nprdtype)
        else:
            self.jt_weight = None
        if self.pure_target_id is not None:
            self.measure_weights = np.abs(
                np.arange(self.N) - self.pure_target_id).astype(self.nprdtype)
        else:
            self.measure_weights = None

        # --- linear-solver stiffness guard. The plain Neumann stage solve
        # converges for u = dt/2 * ||M|| < 1, but what matters over a long
        # horizon is its truncation ERROR, ~u^(iters+1) per step: at u = 0.7
        # and 8 iters that is ~4e-2 per step, which compounds to e^50 over
        # ~1200 steps — the trajectory's stiffest (guard-corner Kerr) mode
        # explodes while the essential-subspace fidelity still looks sane.
        # So switch to the Jacobi-preconditioned iteration (exact elementwise
        # inverse of the stiff DIAGONAL; the remaining contraction is the
        # tiny off-diagonal coupling) as soon as u is large enough that the
        # truncated plain series is no longer accurate, not merely when it
        # stops converging. The reference side-steps this class of issue by
        # always running GMRES and warning at residual > 1e-3
        # (timestepper.cpp:612-614). ---
        self.linsolver = s.linsolver
        self.gen_diag = getattr(self.engine, "gen_diag", lambda: None)()
        lam = self._diag_scale_estimate()
        u_stiff = 0.5 * dt * lam
        # u^(iters+1) <= 1e-6/step keeps 10^4-step horizons below 1e-2 total
        u_ok = float(np.exp(np.log(1e-6) / (s.linsolve_iters + 1)))
        if self.linsolver == "neumann" and u_stiff > u_ok:
            from .ops.grouped_lindblad import GroupedLindbladEngine as _GLE
            from .ops.grouped_rhs import GroupedEngine as _GE_guard
            if isinstance(self.engine, (_GE_guard, _GLE)):
                # Grouped large-N engines: the diagonally-split stepper
                # integrates the stiff drift diagonal EXACTLY (elementwise
                # rotation; exact decay factors for the Lindblad diagonal)
                # and solves only the small off-diagonal remainder
                # — more accurate than IMR on the stiff modes AND ~3x fewer
                # solve iterations than the Jacobi-preconditioned path. Not
                # auto-selected for dense/tensor engines, whose goldens pin
                # plain-IMR discretization parity with the reference.
                self.linsolver = "split"
            elif self.gen_diag is not None:
                self.linsolver = "jacobi"
            elif u_stiff > 0.9:
                import warnings
                warnings.warn(
                    f"Stiff step: dt/2*|H_diag|max = {u_stiff:.2f} > 0.9; "
                    "switching the IMR stage solve to GMRES.")
                self.linsolver = "gmres"
            else:
                import warnings
                warnings.warn(
                    f"Stiff step: dt/2*|H_diag|max = {u_stiff:.2f} leaves "
                    f"~{u_stiff ** (s.linsolve_iters + 1):.1e} relative "
                    "truncation error per Neumann stage solve; consider more "
                    "linsolve_iters (no generator diagonal available for the "
                    "Jacobi-preconditioned solve).")
        # For the Lindblad matrix form the diag mask is (N, N); the flat
        # interface of Dense/Tensor engines takes x as (B, N, N) there.
        self.step_fn = make_step_fn(self.engine.rhs, dt, s.timestepper,
                                    s.linsolve_iters, self.linsolver,
                                    gen_diag=self.gen_diag)

        # --- time-parallel feasibility (ops/propagator.py) ---
        dim_prop = self.N * self.N if self.lindblad else self.N
        feasible = (isinstance(self.engine, DenseEngine)
                    and self.linsolver in ("neumann", "jacobi")
                    and s.ntime * dim_prop * dim_prop <= s.time_parallel_budget)
        if s.time_parallel == "auto":
            # Building propagators costs O(dim^2) per step vs O(dim*B) for
            # the sequential scan: pay off when the batch is comparable to
            # the dimension, or when the problem is so small that the scan
            # is latency-bound anyway.
            profitable = dim_prop <= 64 or dim_prop <= 4 * self.ninit
            self.time_parallel = feasible and profitable
        else:
            self.time_parallel = bool(s.time_parallel) and feasible

        # --- fused time-loop kernel (ops/fused_triton.py) ---
        # Dense IMR systems in complex64 whose operator stacks fit one GPU
        # block. Open systems run it on the column-major vec(rho) with the
        # pseudo-Hamiltonian H' = i L (fused_triton.lindblad_prime_stack).
        from .ops import fused_triton
        from . import backend
        dim_flat = self.N * self.N if self.lindblad else self.N
        fused_ok = (isinstance(self.engine, DenseEngine)
                    and s.timestepper.upper() == "IMR"
                    and self.linsolver in ("neumann", "jacobi", "split")
                    and s.dtype == jnp.complex64
                    and fused_triton.fused_admits(dim_flat, self.ninit,
                                                  self.model.K,
                                                  self.linsolver))
        self.use_pallas = backend.use_fused_kernel(
            s.pallas, fused_ok, lindblad=self.lindblad,
            time_parallel=self.time_parallel)
        if self.use_pallas:
            # the fused kernel owns propagation when selected
            self.time_parallel = False
            eng = self.engine
            S = (fused_triton.lindblad_prime_stack(eng.stack, eng.Ls)
                 if self.lindblad else eng.stack)
            P, _, _ = fused_triton.fused_shape(dim_flat, self.ninit,
                                               self.model.K, self.linsolver)
            eng.pallas_Sr, eng.pallas_Si = fused_triton.plane_args(S, P)
        if self.time_parallel and self.lindblad:
            from .ops.propagator import lindblad_superop_builder
            self._superop_builder = lindblad_superop_builder(
                jnp.asarray(self.engine.stack), self.engine.Ls)
        else:
            self._superop_builder = None

        # --- multi-device mesh (set by parallel.mesh.shard_problem) ---
        self.mesh = None
        self.shard_hilbert = False

    def state_sharding_spec(self, ndim: int = None):
        """PartitionSpec for a batched state array of rank `ndim` (defaults
        to x0's rank) on the ('init', 'hilbert') mesh — the engine-dependent
        layout documented in parallel/mesh.py."""
        from jax.sharding import PartitionSpec as P
        from .ops.grouped_rhs import GroupedEngine
        from .ops.tensor_rhs import TensorEngine
        ndim = ndim if ndim is not None else np.ndim(self.x0)
        tail = [None] * (ndim - 1)
        if self.shard_hilbert:
            if isinstance(self.engine, GroupedEngine) and ndim == 3:
                tail[0] = "hilbert"     # (B, m1, m2) planes: shard m1
            else:
                # flat (B, N) / Lindblad (B, N, N) — including the
                # TensorEngine (round 3): GSPMD propagates the flat-N
                # sharding through the (B, n1..nQ) reshape to the leading
                # tensor factor and inserts the collectives the per-axis
                # contractions need; sharded-vs-unsharded parity is pinned
                # in test_sharding.py (round-1's "no aligned shard axis"
                # replication was overly conservative)
                tail[-1] = "hilbert"
        return P("init", *tail)

    def _shard_state(self, x):
        """with_sharding_constraint pin for the propagating state when a mesh
        is configured — keeps GSPMD from re-replicating the carry inside
        scan/adjoint bodies."""
        if self.mesh is None:
            return x
        from jax.sharding import NamedSharding
        spec = self.state_sharding_spec(jnp.ndim(x))
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(self.mesh, spec))

    def _diag_scale_estimate(self) -> float:
        """Cheap host-side bound of the generator's dominant scale (rad/ns):
        max |diag(H_d)|. For Kerr-dominated transmon models the drift
        diagonal dominates the spectrum."""
        from .ops.tensor_rhs import StructuredModel
        m = self.model
        if isinstance(m, StructuredModel):
            from .utils.operators import drift_diagonal
            d = drift_diagonal(m.dims, m.detune, m.selfkerr, m.crosskerr)
            return float(np.abs(d).max())
        return float(np.abs(np.diagonal(self.engine.stack[0])).max())

    # ------------------------------------------------------------------
    # state functionals
    # ------------------------------------------------------------------

    @property
    def _srank(self):
        """Number of trailing state axes: 1 (psi) or 2 (rho)."""
        return 2 if self.lindblad else 1

    def _state_axes(self, x):
        return tuple(range(x.ndim - self._srank, x.ndim))

    def _diag(self, x):
        """Complex diagonal entries: psi components or rho_ii, (..., N)."""
        if self.lindblad:
            return jnp.diagonal(x, axis1=-2, axis2=-1)
        return x

    def overlaps(self, x):
        """Hilbert-Schmidt overlap <target_b, x_b> (optimtarget.cpp:343-408).
        Accepts any leading batch dims whose last is the init batch;
        returns complex (..., B)."""
        if self.target is not None:
            return jnp.sum(jnp.conj(jnp.asarray(self.target)) * x,
                           axis=self._state_axes(x))
        if self.pure_target_id is not None:
            d = self._diag(x)
            return d[..., self.pure_target_id]
        return jnp.zeros(x.shape[:-self._srank], dtype=x.dtype)

    def eval_J_parts(self, x):
        """Per-initial-condition raw objective values (J_re, J_im), (B,).

        JTRACE: purity-scaled HS overlap (Re scaled only, optimtarget.cpp:400-403).
        JFROBENIUS / JMEASURE: real scalars.
        """
        obj = self.setup.objective_type
        axes = self._state_axes(x)
        if obj == "Jtrace":
            ov = self.overlaps(x)
            return jnp.real(ov) / jnp.asarray(self.purity), jnp.imag(ov)
        if obj == "Jfrobenius":
            if self.target is not None:
                diff = x - jnp.asarray(self.target)
                J = 0.5 * jnp.sum(jnp.abs(diff) ** 2, axis=axes)
            else:
                # pure target e_m (e_m e_m^dag): 1/2 || x - E_m ||^2
                d = self._diag(x)
                m = self.pure_target_id
                norm2 = jnp.sum(jnp.abs(x) ** 2, axis=axes)
                J = 0.5 * (norm2 - 2.0 * jnp.real(d[..., m]) + 1.0)
            return J, jnp.zeros_like(J)
        if obj == "Jmeasure":
            pop = solvers.population_full(x, self.lindblad) if self.lindblad \
                else jnp.abs(x) ** 2
            J = pop @ jnp.asarray(self.measure_weights).astype(pop.dtype)
            return J, jnp.zeros_like(J)
        raise ValueError(obj)

    def finalize_J(self, J_re, J_im):
        """Scalar objective from (already weighted/summed) J parts
        (optimtarget.cpp:864-879)."""
        if self.setup.objective_type == "Jtrace":
            if self.lindblad:
                return 1.0 - J_re
            return 1.0 - (J_re ** 2 + J_im ** 2)
        return J_re

    def eval_J_per_state(self, x):
        """Per-state finalized J (used by the weighted-J penalty integral,
        timestepper.cpp:256-270, which applies finalizeJ per state)."""
        J_re, J_im = self.eval_J_parts(x)
        if self.setup.objective_type == "Jtrace":
            if self.lindblad:
                return 1.0 - J_re
            return 1.0 - (J_re ** 2 + J_im ** 2)
        return J_re

    # ------------------------------------------------------------------
    # coefficient rows from parameters
    # ------------------------------------------------------------------

    def coeff_rows_mid(self, params):
        p, q = eval_controls(self.plan_mid, params, self.setup.pipulses)
        C = self.model.coeff_rows(p, q, self.plan_mid.ts)
        return C.reshape(self.setup.ntime, self.nstages, self.model.K)

    # ------------------------------------------------------------------
    # objective
    # ------------------------------------------------------------------


    def _flat_state_layout(self):
        """The fused kernel's flat-state conventions: flat dimension, the
        generator diagonal in that layout (column-major vec(rho) for
        Lindblad; the engine diag is in (N, N) matrix layout), and the
        flat initial-condition batch (B, dim)."""
        dim = self.N * self.N if self.lindblad else self.N
        gd = self.gen_diag
        if self.lindblad and gd is not None:
            gd = np.asarray(gd).T.reshape(-1)
        x0k = jnp.asarray(self.x0, dtype=self.setup.dtype)
        if self.lindblad:
            x0k = x0k.transpose(0, 2, 1).reshape(self.ninit, dim)
        return dim, gd, x0k

    def _unflatten_states(self, xT, hist):
        """Inverse of the vec(rho) flattening on kernel outputs: xT
        (..., dim) / hist (ntime, ..., dim) -> density-matrix layout
        (..., N, N) for Lindblad; identity for closed systems."""
        if not self.lindblad:
            return xT, hist
        N = self.N
        xT = xT.reshape(xT.shape[:-1] + (N, N)).swapaxes(-1, -2)
        hist = hist.reshape(hist.shape[:-1] + (N, N)).swapaxes(-1, -2)
        return xT, hist

    def objective(self, params, params_ref):
        """Full objective. Returns (J_total, aux) with every term and the
        fidelity, matching optimproblem.cpp:224-338 semantics. Dispatches to
        the time-parallel path (associative-scan propagators) when enabled."""
        if self.time_parallel:
            return self._objective_time_parallel(params, params_ref)
        return self._objective_scan(params, params_ref)

    def _energy_integral(self, params):
        s = self.setup
        if s.gamma_penalty_energy > 1e-13:
            p_stop, q_stop = eval_controls(self.plan_stop, params, s.pipulses)
            return jnp.sum(p_stop ** 2 + q_stop ** 2) / s.ntime
        return jnp.zeros((), dtype=self.rdtype)

    def _assemble_objective(self, params, params_ref, xT, pen_leak_b,
                            pen_jt_b, pen_dpdm_b, energy_int):
        """Common tail: final-time cost, fidelity, regularizers, totals."""
        s = self.setup
        w = jnp.asarray(self.weights)
        J_re_b, J_im_b = self.eval_J_parts(xT)
        J_re = jnp.sum(w * J_re_b)
        J_im = jnp.sum(w * J_im_b)
        obj_cost = self.finalize_J(J_re, J_im)

        ov = self.overlaps(xT)
        fid_re = jnp.sum(jnp.real(ov)) / self.ninit
        fid_im = jnp.sum(jnp.imag(ov)) / self.ninit
        fidelity = fid_re if self.lindblad else fid_re ** 2 + fid_im ** 2

        dx = params - params_ref if s.gamma_tik_interpolate else params
        obj_regul = 0.5 * s.gamma_tik * jnp.sum(dx * dx)

        obj_penal = jnp.zeros((), dtype=self.rdtype)
        if pen_leak_b is not None:
            obj_penal = obj_penal + s.gamma_penalty * jnp.sum(w * pen_leak_b)
        if pen_jt_b is not None:
            obj_penal = obj_penal + s.gamma_penalty * jnp.sum(w * pen_jt_b)
        obj_penal_dpdm = (s.gamma_penalty_dpdm * jnp.sum(w * pen_dpdm_b) / s.ntime
                          if pen_dpdm_b is not None
                          else jnp.zeros((), dtype=self.rdtype))
        obj_penal_energy = s.gamma_penalty_energy * energy_int
        if s.gamma_penalty_variation > 1e-13:
            obj_penal_variation = 0.5 * s.gamma_penalty_variation * \
                control_variation_penalty(self.plan_mid, params)
        else:
            obj_penal_variation = jnp.zeros((), dtype=self.rdtype)

        J = (obj_cost + obj_regul + obj_penal + obj_penal_dpdm
             + obj_penal_energy + obj_penal_variation)
        aux = {
            "obj_cost": obj_cost,
            "obj_regul": obj_regul,
            "obj_penal": obj_penal,
            "obj_penal_dpdm": obj_penal_dpdm,
            "obj_penal_energy": obj_penal_energy,
            "obj_penal_variation": obj_penal_variation,
            "fidelity": fidelity,
        }
        return J, aux

    def _all_states_time_parallel(self, params):
        """States after steps 1..ntime, shape (ntime, B, ...), computed with
        batched step matrices + associative-scan prefix products."""
        from .ops.propagator import (build_step_matrices_dense,
                                     prefix_propagators, propagate_states)
        s = self.setup
        C = self.coeff_rows_mid(params)
        stack = jnp.asarray(self.engine.stack)
        gd = self.gen_diag
        if gd is not None and self.lindblad:
            # superop uses COLUMN-major vec(rho); the engine diag is in
            # (N, N) matrix layout
            gd = jnp.asarray(gd).T.reshape(-1)
        S = build_step_matrices_dense(stack, C, s.dt, s.timestepper,
                                      s.linsolve_iters,
                                      lindblad_superop=self._superop_builder,
                                      gen_diag=gd, linsolver=self.linsolver)
        P = prefix_propagators(S)
        if self.lindblad:
            x0v = jnp.asarray(self.x0).transpose(0, 2, 1).reshape(self.ninit, -1)
            sv = propagate_states(P, x0v)
            return sv.reshape(s.ntime, self.ninit, self.N, self.N).swapaxes(-1, -2)
        return propagate_states(P, jnp.asarray(self.x0))

    def _history_penalties(self, states):
        """Vectorized integral penalties over a full state history
        (T, B, ...): guard leakage, weighted-J window, and the population
        second-difference (dpdm). One fused XLA op each — used by the
        time-parallel and fused-Pallas paths."""
        s = self.setup
        use_leak = self.has_guard and s.gamma_penalty > 1e-13
        use_jt = self.jt_weight is not None and s.gamma_penalty > 1e-13
        use_dpdm = s.gamma_penalty_dpdm > 1e-13 and not self.lindblad

        pen_leak_b = pen_jt_b = pen_dpdm_b = None
        if use_leak:
            if self.lindblad:
                d = jnp.diagonal(states, axis1=-2, axis2=-1)
            else:
                d = states
            leak_tb = jnp.sum((jnp.abs(d) ** 2) * self.guard_mask[None, None, :],
                              axis=-1)
            pen_leak_b = jnp.sum(leak_tb, axis=0) / s.ntime
        if use_jt:
            Jtb = self.eval_J_per_state(states)               # (T, B)
            pen_jt_b = jnp.sum(jnp.asarray(self.jt_weight)[:, None] * Jtb, axis=0) * s.dt
        if use_dpdm:
            B = self.ninit
            pop0 = jnp.abs(jnp.asarray(self.x0).reshape(1, B, -1)) ** 2
            popt = jnp.abs(states.reshape(states.shape[0], B, -1)) ** 2
            pop = jnp.concatenate([pop0, popt], axis=0)      # (T+1, B, dim)
            sec = pop[2:] - 2.0 * pop[1:-1] + pop[:-2]
            pen_dpdm_b = jnp.sum(sec * sec, axis=(0, 2)) / s.dt ** 4
        return pen_leak_b, pen_jt_b, pen_dpdm_b

    def _objective_time_parallel(self, params, params_ref):
        states = self._all_states_time_parallel(params)     # (T, B, ...)
        xT = states[-1]
        energy_int = self._energy_integral(params)
        pen_leak_b, pen_jt_b, pen_dpdm_b = self._history_penalties(states)
        return self._assemble_objective(params, params_ref, xT, pen_leak_b,
                                        pen_jt_b, pen_dpdm_b, energy_int)

    def _objective_scan(self, params, params_ref):
        s = self.setup
        C = self.coeff_rows_mid(params)
        energy_int = self._energy_integral(params)

        use_leak = self.has_guard and s.gamma_penalty > 1e-13
        use_jt = self.jt_weight is not None and s.gamma_penalty > 1e-13
        use_dpdm = s.gamma_penalty_dpdm > 1e-13 and not self.lindblad

        if self.use_pallas:
            # Fused time loop (ops/fused_triton.py): the state history is
            # stored (storeFWD analog), so every integral penalty is one
            # vectorized op whose gradient flows through the kernel's
            # hand-written adjoint.
            from .ops.fused_triton import make_fused_propagate
            dim, gd, x0k = self._flat_state_layout()
            prop = make_fused_propagate(
                np.zeros((self.model.K, dim, dim), np.complex64), s.dt,
                s.linsolve_iters, self.ninit, gen_diag=gd,
                linsolver=self.linsolver)
            xT, hist = prop(jnp.asarray(self.engine.pallas_Sr),
                            jnp.asarray(self.engine.pallas_Si),
                            x0k, C[:, 0, :])
            xT, hist = self._unflatten_states(xT, hist)
            pen_leak_b, pen_jt_b, pen_dpdm_b = self._history_penalties(hist)
            return self._assemble_objective(
                params, params_ref, xT,
                pen_leak_b, pen_jt_b, pen_dpdm_b, energy_int)

        # Reversible O(1)-memory adjoint: closed systems, IMR family, no
        # multi-state penalties (dpdm needs a state history).
        use_reversible = (
            s.adjoint in ("auto", "reversible", "reversible-ad")
            and not self.lindblad and not use_dpdm
            and s.timestepper.upper() in ("IMR", "IMR4", "IMR8"))
        if use_reversible:
            from .ops.reversible import make_reversible_propagate
            _bwd_raw = make_step_fn(self.engine.rhs, -s.dt, s.timestepper,
                                    s.linsolve_iters, self.linsolver,
                                    gen_diag=self.gen_diag)
            # Inverse of a composed step applies the stages in REVERSE order
            # with negated dt; the gamma sequences are palindromic, but the
            # per-stage coefficient rows (midpoint times) are not — flip them.
            step_bwd = lambda x, c: _bwd_raw(x, c[::-1])

            def penalty_fn(x, extra):
                out = {}
                if use_leak:
                    d2 = jnp.abs(self._diag(x)) ** 2
                    out["leak"] = jnp.sum(
                        d2 * jnp.asarray(self.guard_mask)[None, :], axis=1) / s.ntime
                if use_jt:
                    out["jt"] = extra["wt"] * self.eval_J_per_state(x) * s.dt
                return out

            extras = {"wt": jnp.asarray(self.jt_weight)} if use_jt else {}
            use_pen = use_leak or use_jt

            from .ops.grouped_rhs import GroupedEngine as _GE
            real_grouped = (isinstance(self.engine, _GE)
                            and s.timestepper.upper() == "IMR"
                            and self.gen_diag is not None
                            and self.linsolver in ("neumann", "jacobi",
                                                   "split"))
            use_split = self.linsolver == "split"
            if real_grouped:
                # All-REAL grouped reversible adjoint: the state is carried
                # as f32/f64 (re, im) planes and every product in both the
                # forward step and its AD transpose is a real GEMM
                # (ops/grouped_rhs.make_real_imr_step). Cuts the adjoint
                # sweep cost vs differentiating the complex-arithmetic step.
                eng = self.engine
                B = self.ninit
                rdt = jnp.float32 if s.dtype == jnp.complex64 else jnp.float64

                def to_complex(x):
                    return jax.lax.complex(x[0], x[1]).reshape(
                        B, self.N).astype(s.dtype)

                pen_planes = (lambda x, extra: penalty_fn(to_complex(x), extra)) \
                    if use_pen else None
                if s.adjoint == "reversible-ad":
                    # generic reversible adjoint (AD through the unrolled
                    # stage solve) — kept as a cross-check path. The split
                    # step recomputes its rotation planes inside the scan
                    # body here (planes=None): precomputing them at this
                    # scope would leak outer tracers into the custom-VJP
                    # backward closure. Acceptable for a cross-check path;
                    # the production split adjoint (grouped_adjoint.py)
                    # computes the planes once per propagate/bwd trace.
                    from .ops.grouped_rhs import (make_real_imr_step,
                                                  make_real_split_step)
                    mk = make_real_split_step if use_split \
                        else make_real_imr_step
                    rstep_f = mk(eng, s.dt, s.linsolve_iters)
                    rstep_b = mk(eng, -s.dt, s.linsolve_iters)
                    prop = make_reversible_propagate(
                        lambda x, c: tuple(rstep_f(x[0], x[1], c[0])),
                        lambda x, c: tuple(rstep_b(x[0], x[1], c[0])),
                        pen_planes)
                else:
                    # hand-written solve-based adjoint: ~2x forward cost per
                    # step vs ~7x for AD (ops/grouped_adjoint.py; the
                    # reference's evolveBWD economics, timestepper.cpp:631-694)
                    from .ops.grouped_adjoint import make_grouped_adjoint_propagate
                    prop = make_grouped_adjoint_propagate(
                        eng, s.dt, s.linsolve_iters, pen_planes,
                        split=use_split)
                x0c = jnp.asarray(self.x0, dtype=s.dtype).reshape(
                    B, eng.m1, eng.m2)
                x0p = (self._shard_state(jnp.real(x0c).astype(rdt)),
                       self._shard_state(jnp.imag(x0c).astype(rdt)))
                xTp, pen = prop(x0p, C, extras)
                xT = to_complex(xTp)
            else:
                prop = make_reversible_propagate(
                    self.step_fn, step_bwd,
                    penalty_fn if use_pen else None)
                xT, pen = prop(self._shard_state(
                    jnp.asarray(self.x0, dtype=s.dtype)), C, extras)
            return self._assemble_objective(
                params, params_ref, xT,
                pen.get("leak") if use_pen else None,
                pen.get("jt") if use_pen else None,
                None, energy_int)

        B = self.ninit
        post_init = {}
        extras = {"n": jnp.arange(s.ntime)}
        if use_leak:
            post_init["leak"] = jnp.zeros((B,), dtype=self.rdtype)
        if use_jt:
            post_init["jt"] = jnp.zeros((B,), dtype=self.rdtype)
            extras["wt"] = self.jt_weight
        if use_dpdm:
            pop0 = jnp.abs(self.x0.reshape(B, -1)) ** 2
            post_init["dpdm"] = jnp.zeros((B,), dtype=self.rdtype)
            post_init["prev1"] = pop0
            post_init["prev2"] = pop0

        def post_fn(aux, x, ex):
            out = dict(aux)
            if use_leak:
                d2 = jnp.abs(self._diag(x)) ** 2            # (B, N)
                leak = jnp.sum(d2 * self.guard_mask[None, :], axis=1)
                out["leak"] = aux["leak"] + leak / s.ntime
            if use_jt:
                out["jt"] = aux["jt"] + ex["wt"] * self.eval_J_per_state(x) * s.dt
            if use_dpdm:
                cur = jnp.abs(x.reshape(B, -1)) ** 2
                sec = cur - 2.0 * aux["prev1"] + aux["prev2"]
                contrib = jnp.sum(sec * sec, axis=1) / s.dt ** 4
                out["dpdm"] = aux["dpdm"] + jnp.where(ex["n"] > 0, contrib, 0.0)
                out["prev1"] = cur
                out["prev2"] = aux["prev1"]
            return out

        x0 = self._shard_state(jnp.asarray(self.x0, dtype=s.dtype))
        if post_init:
            xT, acc = solvers.propagate(self.step_fn, x0, C, extras, post_fn, post_init)
        else:
            xT, acc = solvers.propagate(self.step_fn, x0, C)
            acc = {}

        return self._assemble_objective(
            params, params_ref, xT,
            acc.get("leak"), acc.get("jt"), acc.get("dpdm"), energy_int)

    # ------------------------------------------------------------------
    # big-array argument threading
    #
    # Small static arrays are embedded as jit constants from host memory.
    # LARGE arrays (operator stacks, big initial-condition batches) are
    # passed as runtime ARGUMENTS instead: embedded constants bloat the
    # compiled program and its compile time. We temporarily swap tracers
    # into the holder attributes during tracing.
    # ------------------------------------------------------------------

    _BIG_THRESHOLD = 1 << 16   # elements

    def _big_slots(self):
        slots = [(self, "x0"), (self, "target")]
        eng = self.engine
        for name in ("stack", "Ls", "stackL", "stackR", "cross_diag",
                     "crossA", "crossB", "jumpL", "jumpR",
                     "pallas_Sr", "pallas_Si"):
            if getattr(eng, name, None) is not None:
                slots.append((eng, name))
        out = []
        for holder, name in slots:
            arr = getattr(holder, name, None)
            if arr is not None and np.size(arr) >= self._BIG_THRESHOLD:
                out.append((holder, name))
        return out

    def _wrap_with_data(self, fn):
        """Return a jitted fn(*args) with big arrays threaded as arguments
        (device-resident between calls). An engine-provided on-device
        builder (engine.device_builders) assembles an array where one
        exists; everything else is one device_put."""
        slots = self._big_slots()
        if not slots:
            return jax.jit(fn)
        builders = {}
        for h, _name in slots:
            get_b = getattr(h, "device_builders", None)
            if get_b is not None and id(h) not in builders:
                builders[id(h)] = get_b()
        dev_vals = {}
        for h, name in slots:
            b = builders.get(id(h), {}).get(name)
            dev_vals[name] = b() if b is not None \
                else jax.device_put(np.asarray(getattr(h, name)))
        if self.mesh is not None:
            # states sharded per state_sharding_spec, operator data replicated
            from jax.sharding import NamedSharding, PartitionSpec as P
            for h, name in slots:
                if h is self and name in ("x0", "target"):
                    spec = self.state_sharding_spec(np.ndim(dev_vals[name]))
                else:
                    spec = P()
                dev_vals[name] = jax.device_put(
                    dev_vals[name], NamedSharding(self.mesh, spec))

        def traced(data, *args):
            saved = {}
            try:
                for h, name in slots:
                    saved[name] = getattr(h, name)
                    setattr(h, name, data[name])
                return fn(*args)
            finally:
                for h, name in slots:
                    setattr(h, name, saved[name])

        jf = jax.jit(traced)

        def call(*args):
            return jf(dev_vals, *args)

        return call

    # compiled entry points -------------------------------------------------

    def build_value_and_grad(self):
        return self._wrap_with_data(
            jax.value_and_grad(self.objective, has_aux=True))

    def build_objective(self):
        return self._wrap_with_data(self.objective)

    def build_propagate_trajectory(self):
        return self._wrap_with_data(self.propagate_trajectory)

    def build_propagate_final(self):
        return self._wrap_with_data(self.propagate_final)

    def _ensemble_vg(self):
        """(E, nparams)-batched value_and_grad
        fn(Ps, ref) -> ((J (E,), aux), grad (E, nparams)). On the fused
        kernel the vmap becomes one more grid axis: one program per
        candidate."""
        vg = jax.value_and_grad(self.objective, has_aux=True)
        return jax.vmap(vg, in_axes=(0, None))

    def sharded_batch_fns(self, params_ref, mesh, axis="init"):
        """batched_lbfgsb hooks that shard_map a population's objective and
        gradient evaluations over the candidate axis of `mesh`: each device
        runs its E/n slice, so a whole population optimisation scales over
        cards like the ensemble sweep (parity pinned in test_sharding.py).
        Callers splat the result into batched_lbfgsb(**kw)."""
        from jax.sharding import PartitionSpec as P
        eobj = jax.vmap(self.objective, in_axes=(0, None))
        evg = self._ensemble_vg()

        def obj_only(Ps, ref):
            return eobj(Ps, ref)[0]

        def vg_only(Ps, ref):
            (J, _aux), gr = evg(Ps, ref)
            return J, gr

        obj_only = self._ensemble_shard(obj_only, mesh, axis, P(axis))
        vg_only = self._ensemble_shard(vg_only, mesh, axis,
                                       (P(axis), P(axis)))
        return dict(objective_batch=lambda xs: obj_only(xs, params_ref),
                    grad_batch=lambda xs: vg_only(xs, params_ref)[1],
                    vg_batch=lambda xs: vg_only(xs, params_ref))

    def _ensemble_shard(self, fn, mesh, axis, out_specs):
        """shard_map `fn(Ps, ref)` over the candidate (leading-Ps) axis of
        the mesh. Each device runs the FULL per-candidate program — the
        fused kernel included, which GSPMD cannot partition but shard_map
        runs whole per shard — on its E/n slice of the ensemble. This is the
        multi-chip analog of the reference's comm_init split
        (optimproblem.cpp:85-91, user_guide.md:422): candidates are
        embarrassingly parallel, so the only collectives are the final
        reductions (psum / all-gather of per-candidate outputs)."""
        from jax.sharding import PartitionSpec as P

        n = mesh.shape[axis]

        def sharded(Ps, params_ref):
            E = Ps.shape[-2]
            if E % n:
                raise ValueError(
                    f"ensemble size {E} not divisible by mesh axis "
                    f"'{axis}' of size {n}")
            return jax.shard_map(
                fn, mesh=mesh,
                in_specs=(P(*([None] * (Ps.ndim - 2)), axis), P()),
                out_specs=out_specs,
                # the fused kernel does not carry varying-mesh-axes
                # annotations; correctness is pinned by the sharded-vs-
                # unsharded parity tests (test_sharding.py)
                check_vma=False)(Ps, params_ref)

        return sharded

    def build_ensemble_value_and_grad(self, mesh=None, axis="init"):
        """value_and_grad vmapped over an ensemble of control vectors
        (E, nparams) -> ((J (E,), aux (E,...)), grad (E, nparams)).

        This is the batched-candidate axis the reference has no analog for:
        many control candidates (multi-start optimization, robust-control
        ensembles, population-based search) propagate simultaneously, turning
        the small per-problem matmuls into large batched GEMMs.

        With `mesh`, the candidate axis is SHARDED over the mesh's `axis`
        (shard_map; each device runs its E/n slice through the full fused
        path) — the multi-chip scaling axis for the flagship throughput
        metric."""
        evg = self._ensemble_vg()
        if mesh is None:
            return self._wrap_with_data(evg)
        from jax.sharding import PartitionSpec as P
        out_specs = ((P(axis), P(axis)), P(axis))
        return self._wrap_with_data(
            self._ensemble_shard(evg, mesh, axis, out_specs))

    def build_ensemble_sweeps(self, mesh=None, axis="init"):
        """f(Ps, params_ref) -> scalar consuming Ps.shape[0] PIPELINED
        ensemble gradient sweeps in one jit call (each a vmapped
        value_and_grad over Ps.shape[1] candidates; the scalar sums J and
        the gradients so nothing can be dead-code-eliminated). This is the
        throughput-probe entry point: one dispatch + one synchronous fetch
        measures the device rate without charging a host round-trip to
        every repetition.

        With `mesh`, the candidate axis of every sweep is SHARDED over the
        mesh's `axis`: Ps (reps, E, nparams) with E split n ways, one psum
        of the accumulated scalar at the end — per-chip work is exactly the
        unsharded program at E/n."""
        evg = self._ensemble_vg()

        def reps(Ps, params_ref):
            def body(acc, P):
                (J, _), g = evg(P, params_ref)
                # cast: under x64 the objective promotes to f64 while the
                # carry is the setup's real dtype
                return (acc + jnp.sum(J) + jnp.sum(g)).astype(acc.dtype), None
            out, _ = jax.lax.scan(body, jnp.zeros((), self.rdtype), Ps)
            return out

        if mesh is None:
            return self._wrap_with_data(reps)
        from jax.sharding import PartitionSpec as P

        def reps_psum(Ps, params_ref):
            return jax.lax.psum(reps(Ps, params_ref), axis)

        return self._wrap_with_data(
            self._ensemble_shard(reps_psum, mesh, axis, P()))

    def propagate_final(self, params):
        """Forward-only propagation; returns final states (B, ...)."""
        if self.time_parallel:
            return self._all_states_time_parallel(params)[-1]
        C = self.coeff_rows_mid(params)
        xT, _ = solvers.propagate(self.step_fn, self.x0, C, remat=False)
        return xT

    def propagate_trajectory(self, params):
        """All states (ntime+1, B, ...) for trajectory output."""
        if self.time_parallel:
            states = self._all_states_time_parallel(params)
            x0 = jnp.asarray(self.x0).astype(states.dtype)
            return jnp.concatenate([x0[None], states], axis=0)
        C = self.coeff_rows_mid(params)
        return solvers.propagate_trajectory(self.step_fn, self.x0, C)

    def controls_on_output_grid(self, params):
        """(ts, p, q, f_lab) on the output time grid t_n = n*dt."""
        p, q = eval_controls(self.plan_out, params, self.setup.pipulses)
        f = eval_controls_labframe(self.plan_out, params,
                                   np.asarray(self.setup.ground_freqs_radns),
                                   self.setup.pipulses)
        return self.ts_out, p, q, f
