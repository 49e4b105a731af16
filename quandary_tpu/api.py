"""User-facing API: the `Quandary` configuration/driver class.

Mirrors the reference Python front end (quandary.py:10-893) field-for-field —
same defaults, same derived quantities (time-step estimate, spline counts,
carrier-wave resonances) — but everything runs IN-PROCESS on a GPU or the CPU through
JAX: no config files, no `mpirun` subprocess, no output-file round trip.
Output files in the reference formats can still be written via `datadir` for
compatibility and golden testing.

    from quandary_tpu import Quandary
    q = Quandary(Ne=[2,2], freq01=[4.8, 4.9], Jkl=[0.005], T=200.0,
                 targetgate=cnot_matrix, maxctrl_MHz=[30,30], rand_seed=1234)
    t, pt, qt, infidelity, expectedEnergy, population = q.optimize()
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import field
from typing import Dict, List, Optional

import numpy as np

from .models import gates as gates_mod
from .models.hamiltonian import build_file_model, build_standard_model
from .optim.driver import build_bounds, run_optimization
from .problem import Problem, Setup
from .utils.indexing import lift_vector_ess_to_full, ess_to_full_map
from .utils.operators import hamiltonians
from .utils.resonances import estimate_timesteps, get_resonances
from .utils.splines import ControlSegment, OscillatorControl
from .io import output as out_io
from .io import datafiles


def resolve_datadir(datadir: str) -> str:
    """QUANDARY_BASE_DATADIR handling (quandary.py:1083-1111)."""
    if os.path.isabs(datadir):
        return datadir
    base_dir = os.environ.get("QUANDARY_BASE_DATADIR")
    if base_dir:
        if not os.path.exists(base_dir):
            raise ValueError(
                f"Environment variable QUANDARY_BASE_DATADIR points to non-existent path: {base_dir}")
        if not os.path.isdir(base_dir):
            raise ValueError(
                f"Environment variable QUANDARY_BASE_DATADIR is not a directory: {base_dir}")
        datadir = os.path.join(base_dir, datadir)
    return os.path.normpath(datadir)


@dataclasses.dataclass
class Quandary:
    """Configuration + driver. Field semantics match the reference
    `Quandary` dataclass (quandary.py:106-177); see that docstring for the
    physics meaning of every option. Frequencies in GHz, times in ns,
    control amplitudes in MHz."""

    # Quantum system
    Ne: List[int] = field(default_factory=lambda: [3])
    Ng: List[int] = field(default_factory=lambda: [0])
    freq01: List[float] = field(default_factory=lambda: [4.10595])
    selfkerr: List[float] = field(default_factory=lambda: [0.2198])
    rotfreq: List[float] = field(default_factory=list)
    Jkl: List[float] = field(default_factory=list)
    crosskerr: List[float] = field(default_factory=list)
    T1: List[float] = field(default_factory=list)
    T2: List[float] = field(default_factory=list)
    # Optional user-defined Hamiltonian (rad/ns)
    Hsys: List[complex] = field(default_factory=list)
    Hc_re: List[List[float]] = field(default_factory=list)
    Hc_im: List[List[float]] = field(default_factory=list)
    standardmodel: bool = True
    # Time discretization
    T: float = 100.0
    Pmin: int = 150
    nsteps: int = -1
    dT: float = -1.0
    timestepper: str = "IMR"
    # Targets / initial states
    targetgate: List[List[complex]] = field(default_factory=list)
    targetstate: List[complex] = field(default_factory=list)
    initialcondition: object = "basis"
    gate_rot_freq: List[float] = field(default_factory=list)
    # Control pulses
    pcof0: List[float] = field(default_factory=list)
    pcof0_filename: str = ""
    randomize_init_ctrl: bool = True
    initctrl_MHz: object = field(default_factory=list)
    maxctrl_MHz: object = field(default_factory=list)
    control_enforce_BC: bool = False
    spline_knot_spacing: float = 3.0
    nsplines: int = -1
    spline_order: int = 2
    carrier_frequency: List[List[float]] = field(default_factory=list)
    cw_amp_thres: float = 1e-7
    cw_prox_thres: float = 1e-2
    # Optimization
    maxiter: int = 200
    # optimizer driver: 'host' = per-iteration strong-Wolfe L-BFGS-B
    # (reference-faithful, f64); 'device' = the on-device chunked loop
    # (optim/device_driver.py — one host fetch per chunk); 'auto' = device
    # on a GPU, host otherwise (quandary_tpu/backend.py)
    optimizer: str = "auto"
    tol_infidelity: float = 1e-5
    tol_costfunc: float = 1e-4
    tol_gnorm_abs: float = 1e-4
    tol_gnorm_rel: float = 1e-4
    costfunction: str = "Jtrace"
    optim_target: str = "gate, none"
    gamma_tik0: float = 1e-4
    gamma_tik0_interpolate: float = 0.0
    gamma_leakage: float = 0.1
    gamma_energy: float = 0.1
    gamma_dpdm: float = 0.01
    gamma_variation: float = 0.01
    # General
    rand_seed: Optional[int] = None
    print_frequency_iter: int = 1
    usematfree: bool = True           # engine hint: tensor engine for large N
    verbose: bool = False
    precision: str = "double"         # 'double' (validation) | 'single' (speed)
    linearsolver_maxiter: int = 20
    # Internal
    _ninit: int = -1
    _lindblad_solver: bool = False
    _initialstate: List[complex] = field(default_factory=list)
    # Outputs (after simulate/optimize)
    popt: List[float] = field(default_factory=list)
    time: List[float] = field(default_factory=list)
    optim_hist: Dict = field(default_factory=dict)
    uT: object = field(default_factory=list)

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.spline_order == 0:
            minspline = 2
        elif self.spline_order == 2:
            minspline = 5 if self.control_enforce_BC else 3
        else:
            raise ValueError(f"spline order {self.spline_order} not available (0 or 2)")

        if len(self.freq01) != len(self.Ne) and len(self.Hsys) <= 0:
            self.Ne = [2 for _ in range(len(self.freq01))]
        if len(self.Ng) != len(self.Ne):
            self.Ng = [0 for _ in range(len(self.Ne))]
        if len(self.selfkerr) != len(self.Ne):
            self.selfkerr = np.zeros(len(self.Ne))
        if len(self.rotfreq) == 0:
            self.rotfreq = self.freq01
        if len(self.gate_rot_freq) == 0:
            self.gate_rot_freq = np.zeros(len(self.rotfreq))
        if isinstance(self.initctrl_MHz, (float, int)):
            self.initctrl_MHz = [self.initctrl_MHz for _ in range(len(self.Ne))]
        if len(self.initctrl_MHz) == 0:
            self.initctrl_MHz = [10.0 for _ in range(len(self.Ne))]
        if len(self.Hsys) > 0 and not self.standardmodel:
            self.standardmodel = False
        else:
            self.standardmodel = True
        if len(self.targetstate) > 0:
            self.optim_target = "file"
        if len(self.targetgate) > 0:
            self.optim_target = "gate, file"
        if not isinstance(self.initialcondition, str):
            self._initialstate = np.array(self.initialcondition).copy()
            self.initialcondition = "file"
        if isinstance(self.maxctrl_MHz, (float, int)):
            self.maxctrl_MHz = [self.maxctrl_MHz for _ in range(len(self.Ne))]

        self._lindblad_solver = (len(self.T1) > 0) or (len(self.T2) > 0)
        if str(self.initialcondition)[0:4] in ("file", "pure"):
            self._ninit = 1
        else:
            self._ninit = int(np.prod(self.Ne))
        if self._lindblad_solver:
            self._ninit = self._ninit ** 2

        # time steps (quandary.py:239-247)
        if self.dT < 0:
            if self.standardmodel:
                Ntot = [sum(x) for x in zip(self.Ne, self.Ng)]
                self.Hsys, self.Hc_re, self.Hc_im = hamiltonians(
                    N=Ntot, freq01=self.freq01, selfkerr=self.selfkerr,
                    crosskerr=self.crosskerr, Jkl=self.Jkl, rotfreq=self.rotfreq,
                    verbose=self.verbose)
            self.nsteps = estimate_timesteps(
                T=self.T, Hsys=self.Hsys, Hc_re=self.Hc_re, Hc_im=self.Hc_im,
                maxctrl_MHz=self.maxctrl_MHz, Pmin=self.Pmin)
            self.dT = self.T / self.nsteps
        else:
            self.nsteps = int(np.ceil(self.T / self.dT))
            self.T = self.nsteps * self.dT

        # spline count (quandary.py:252-261)
        if self.nsplines < 0:
            if self.spline_order == 0:
                self.nsplines = int(np.max([np.rint(self.nsteps * self.dT / self.spline_knot_spacing + 1), minspline]))
            else:
                self.nsplines = int(np.max([np.ceil(self.T / self.spline_knot_spacing + 2), minspline]))
            self.spline_knot_spacing = (self.nsteps * self.dT / (self.nsplines - 1)
                                        if self.spline_order == 0
                                        else self.nsteps * self.dT / (self.nsplines - 2))
        else:
            self.spline_knot_spacing = (self.nsteps * self.dT / (self.nsplines - 1)
                                        if self.spline_order == 0
                                        else self.T / (self.nsplines - 2))

        # carrier waves (quandary.py:263-271)
        if self.spline_order == 0 and len(self.carrier_frequency) == 0:
            self.carrier_frequency = [[0.0] for _ in range(len(self.freq01))]
        if len(self.carrier_frequency) == 0:
            if self.standardmodel and len(self.Hsys) <= 0:
                Ntot = [sum(x) for x in zip(self.Ne, self.Ng)]
                self.Hsys, self.Hc_re, self.Hc_im = hamiltonians(
                    N=Ntot, freq01=self.freq01, selfkerr=self.selfkerr,
                    crosskerr=self.crosskerr, Jkl=self.Jkl, rotfreq=self.rotfreq,
                    verbose=self.verbose)
            try:
                self.carrier_frequency, _ = get_resonances(
                    Ne=self.Ne, Ng=self.Ng, Hsys=np.asarray(self.Hsys),
                    Hc_re=self.Hc_re, Hc_im=self.Hc_im, rotfreq=self.rotfreq,
                    verbose=self.verbose, cw_amp_thres=self.cw_amp_thres,
                    cw_prox_thres=self.cw_prox_thres, stdmodel=self.standardmodel)
            except ValueError as e:
                # degenerate Hamiltonian spectra defeat the identity-ordering
                # of the eigenvector matrix (same failure as the reference's
                # eigen_and_reorder, quandary.py:957-959); fall back to a
                # single zero-frequency carrier and tell the user to supply
                # carrier_frequency explicitly.
                import warnings
                warnings.warn(
                    f"Automatic carrier-frequency resonance analysis failed "
                    f"({e}); falling back to carrier_frequency=[[0.0]] per "
                    "oscillator. Pass carrier_frequency explicitly for "
                    "degenerate systems.")
                self.carrier_frequency = [[0.0] for _ in range(len(self.freq01))]

        if self.verbose:
            print("Final time: ", self.T, "ns, Number of timesteps: ", self.nsteps,
                  ", dt=", self.T / self.nsteps, "ns")
            print("Carrier frequencies (rot. frame): ", self.carrier_frequency)

    # ------------------------------------------------------------------
    def copy(self):
        return dataclasses.replace(self)

    def update(self):
        popt, time, hist, uT = self.popt, self.time, self.optim_hist, self.uT
        self.__post_init__()
        self.popt, self.time, self.optim_hist, self.uT = popt, time, hist, uT

    # ------------------------------------------------------------------
    # setup construction
    # ------------------------------------------------------------------

    @property
    def nlevels(self) -> List[int]:
        return [e + g for e, g in zip(self.Ne, self.Ng)]

    def _dtype(self):
        import jax.numpy as jnp
        return jnp.complex128 if self.precision == "double" else jnp.complex64

    def _build_oscillators(self):
        kind = "spline" if self.spline_order == 2 else "spline0"
        oscs = []
        for k in range(len(self.Ne)):
            seg = ControlSegment(kind, nsplines=self.nsplines, tstart=0.0,
                                 tstop=self.nsteps * self.dT)
            cf = tuple(2.0 * np.pi * f for f in np.atleast_1d(self.carrier_frequency[k]))
            oscs.append(OscillatorControl(segments=(seg,), carrier_freqs=cf,
                                          enforce_bc=bool(self.control_enforce_BC)))
        return tuple(oscs)

    def _build_setup(self) -> Setup:
        nlv = self.nlevels
        lind = self._lindblad_solver
        if self.standardmodel:
            if int(np.prod(nlv)) > 1024:
                from .ops.tensor_rhs import build_structured_model
                model = build_structured_model(
                    nlevels=nlv, freq01_ghz=self.freq01, rotfreq_ghz=self.rotfreq,
                    selfkerr_ghz=self.selfkerr, crosskerr_ghz=self.crosskerr,
                    jkl_ghz=self.Jkl, decay_time=self.T1, dephase_time=self.T2,
                    lindblad=lind)
            else:
                model = build_standard_model(
                    nlevels=nlv, freq01_ghz=self.freq01, rotfreq_ghz=self.rotfreq,
                    selfkerr_ghz=self.selfkerr, crosskerr_ghz=self.crosskerr,
                    jkl_ghz=self.Jkl, decay_time=self.T1, dephase_time=self.T2,
                    lindblad=lind)
        else:
            model = build_file_model(
                nlevels=nlv, Hsys_radns=np.asarray(self.Hsys),
                Hc_re=self.Hc_re, Hc_im=self.Hc_im,
                decay_time=self.T1, dephase_time=self.T2, lindblad=lind)

        oscillators = self._build_oscillators()

        # --- initial condition ---
        ic_str = str(self.initialcondition)
        # tolerate trailing commas ("pure, 1, 0, " — the reference's own
        # spinchain example builds the string that way)
        parts = [s.strip() for s in ic_str.split(",") if s.strip() != ""]
        ic_type = parts[0]
        pure_levels = None
        init_state = None
        ic_ids = ()
        if ic_type == "pure":
            pure_levels = tuple(int(p) for p in parts[1:]) if len(parts) > 1 \
                else tuple([0] * len(nlv))
        elif ic_type == "file":
            init_state = np.asarray(self._initialstate)
        elif len(parts) > 1:
            ic_ids = tuple(int(p) for p in parts[1:] if p != "")

        # --- target ---
        tparts = [s.strip() for s in str(self.optim_target).split(",")]
        target_type = "none"
        target_gate_full = None
        target_state_full = None
        pure_target_levels = None
        if len(self.targetgate) > 0:
            target_type = "gate"
            V = np.asarray(self.targetgate, dtype=np.complex128)
            target_gate_full = gates_mod.assemble_gate(
                V, nlv, self.Ne, self.gate_rot_freq, self.nsteps * self.dT)
        elif len(self.targetstate) > 0:
            target_type = "file"
            tvec = np.asarray(self.targetstate, dtype=np.complex128)
            if lind:
                tmat = np.outer(tvec, tvec.conj())
                full = np.zeros((model.N, model.N), dtype=np.complex128)
                emap = ess_to_full_map(nlv, self.Ne)
                full[np.ix_(emap, emap)] = tmat
                target_state_full = full
            else:
                target_state_full = lift_vector_ess_to_full(tvec, nlv, self.Ne)
        elif tparts[0] == "gate":
            gname = tparts[1] if len(tparts) > 1 else "none"
            Vess = gates_mod.from_name(gname, self.Ne)
            if Vess is not None:
                target_type = "gate"
                target_gate_full = gates_mod.assemble_gate(
                    Vess, nlv, self.Ne, self.gate_rot_freq, self.nsteps * self.dT)
        elif tparts[0] == "pure":
            target_type = "pure"
            lv = [int(p) for p in tparts[1:]] if len(tparts) > 1 else [0] * len(nlv)
            while len(lv) < len(nlv):
                lv.append(lv[-1])
            pure_target_levels = tuple(lv)

        return Setup(
            model=model,
            nessential=tuple(self.Ne),
            ntime=self.nsteps,
            dt=self.dT,
            timestepper=self.timestepper,
            linsolve_iters=self.linearsolver_maxiter,
            oscillators=oscillators,
            ground_freqs_radns=tuple(2.0 * np.pi * f for f in self.freq01),
            initcond_type=ic_type,
            initcond_ids=ic_ids,
            pure_levels=pure_levels,
            initial_state_ess=init_state,
            target_type=target_type,
            target_gate_full=target_gate_full,
            target_state_full=target_state_full,
            pure_target_levels=pure_target_levels,
            objective_type=self.costfunction,
            gamma_tik=(self.gamma_tik0_interpolate
                       if self.gamma_tik0_interpolate > 0.0 else self.gamma_tik0),
            gamma_tik_interpolate=self.gamma_tik0_interpolate > 0.0,
            gamma_penalty=self.gamma_leakage,
            penalty_param=0.0,
            gamma_penalty_dpdm=self.gamma_dpdm,
            gamma_penalty_energy=self.gamma_energy,
            gamma_penalty_variation=self.gamma_variation,
            dtype=self._dtype(),
        )

    def _initial_params(self, oscillators) -> np.ndarray:
        """Initial control vector (oscillator.cpp:134-205 semantics):
        amplitude initctrl_MHz scaled by 1/(1000*sqrt(2)*nf) [GHz] then
        2*pi; 'random' draws uniform in [-a, a] (numpy PRNG — deterministic
        under rand_seed but not bit-identical to the reference's mt19937),
        'constant' sets all coefficients to a. Boundary-condition splines are
        zeroed when control_enforce_BC."""
        if len(self.pcof0) > 0:
            return np.asarray(self.pcof0, dtype=float)
        if self.pcof0_filename:
            return datafiles.read_vector(self.pcof0_filename)
        rng = np.random.default_rng(self.rand_seed if self.rand_seed is not None else None)
        chunks = []
        for k, osc in enumerate(oscillators):
            nf = len(osc.carrier_freqs)
            initamp_ghz = float(np.atleast_1d(self.initctrl_MHz)[k]) / 1000.0 / np.sqrt(2.0) / nf
            a = initamp_ghz * 2.0 * np.pi
            n = osc.nparams
            if self.randomize_init_ctrl:
                u = None
                if self.rand_seed is not None:
                    # bit-exact reference parity: std::mt19937(seed) restarted
                    # per oscillator (the reference passes the engine by value
                    # into each Oscillator ctor, main.cpp:240)
                    from .io.native import mt19937_uniform
                    u = mt19937_uniform(int(self.rand_seed), n)
                if u is None:
                    u = rng.uniform(0.0, 1.0, n)
                v = u * a
                v = 2.0 * v - a
            else:
                v = np.full(n, a)
            # zero the boundary splines (enforceBoundary)
            if self.control_enforce_BC:
                off = 0
                for seg in osc.segments:
                    npc = seg.nparams_per_carrier()
                    ns = seg.nsplines
                    for f in range(nf):
                        base = off + f * npc
                        if seg.kind == "spline":
                            for l in (0, 1, ns - 2, ns - 1):
                                v[base + l] = 0.0
                                v[base + ns + l] = 0.0
                        elif seg.kind == "spline0":
                            v[base + 0] = 0.0
                            v[base + ns - 1] = 0.0
                            v[base + ns] = 0.0
                            v[base + 2 * ns - 1] = 0.0
                    off += npc * nf
            chunks.append(v)
        return np.concatenate(chunks) if chunks else np.zeros(0)

    # ------------------------------------------------------------------
    # main entry points
    # ------------------------------------------------------------------

    def simulate(self, *, pcof0=[], pt0=[], qt0=[], maxcores=-1,
                 datadir="./run_dir", **_ignored):
        """Forward simulation; returns (time, pt, qt, infidelity,
        expectedEnergy, population) exactly like the reference
        (quandary.py:301-348)."""
        if len(pt0) > 0 and len(qt0) > 0:
            return self._run_sampled(pt0, qt0, runtype="simulation", datadir=datadir)
        return self._run(pcof0=pcof0, runtype="simulation", datadir=datadir)

    def optimize(self, *, pcof0=[], pt0=[], qt0=[], maxcores=-1,
                 datadir="./run_dir", multistart: int = 1, **_ignored):
        """Run the optimization (quandary.py:351-395).

        multistart > 1 (an extension of the reference): refine `multistart` random
        starting points IN PARALLEL on-device with the batched L-BFGS
        (optim/batched_lbfgs.py), then polish the best candidate with the
        host optimizer. Requires rand_seed for reproducibility."""
        if len(pt0) > 0 and len(qt0) > 0:
            return self._run_sampled(pt0, qt0, runtype="optimization", datadir=datadir)
        if multistart > 1 and len(pcof0) == 0:
            pcof0 = self._multistart_best(multistart)
        return self._run(pcof0=pcof0, runtype="optimization", datadir=datadir)

    def _multistart_best(self, E: int):
        import jax
        import jax.numpy as jnp
        from .optim.batched_lbfgs import batched_lbfgsb
        from .optim.driver import build_bounds

        setup = self._build_setup()
        problem = Problem(setup)
        rng = np.random.default_rng(self.rand_seed)
        scale = float(np.atleast_1d(self.initctrl_MHz)[0]) / 1000.0 * 2 * np.pi / np.sqrt(2)
        x0s = jnp.asarray(rng.uniform(-1, 1, (E, setup.nparams)) * scale)
        bounds_ghz = [[m / 1000.0] for m in (np.atleast_1d(self.maxctrl_MHz)
                                             if len(np.atleast_1d(self.maxctrl_MHz)) > 0
                                             else [1e15] * len(self.Ne))]
        lb, ub = build_bounds(setup.oscillators, bounds_ghz)
        ref = jnp.zeros(setup.nparams)

        def objective(x):
            J, _ = problem.objective(x, ref)
            return J

        run = problem._wrap_with_data(lambda xs: batched_lbfgsb(
            objective, jax.grad(objective), xs, lb, ub, iters=30))
        xbest, fbest, _ = run(x0s)
        best = int(jnp.argmin(fbest))
        if self.verbose:
            print(f"multistart: candidate objectives {np.round(np.asarray(fbest), 6)}"
                  f" -> picking {best}")
        return np.asarray(xbest[best])

    def evalControls(self, *, pcof0=[], points_per_ns=1, datadir="./run_dir", **_ignored):
        """Evaluate the control pulses on a given sample rate
        (quandary.py:398-441). Returns (time, pt, qt) in MHz."""
        from .models.controls import eval_controls
        from .utils.splines import build_control_plan

        setup = self._build_setup()
        params = np.asarray(pcof0, dtype=float) if len(pcof0) > 0 \
            else self._initial_params(setup.oscillators)
        nt = int(np.floor(self.T * points_per_ns))
        ts = np.arange(nt + 1) * (self.T / max(nt, 1))
        plan = build_control_plan(setup.oscillators, ts)
        import jax.numpy as jnp
        p, q = eval_controls(plan, jnp.asarray(params))
        pt = [np.asarray(p)[:, k] / (2 * np.pi) * 1e3 for k in range(len(self.Ne))]
        qt = [np.asarray(q)[:, k] / (2 * np.pi) * 1e3 for k in range(len(self.Ne))]
        self.popt = params.tolist()
        return ts.tolist(), pt, qt

    # ------------------------------------------------------------------

    def _run_sampled(self, pt0, qt0, runtype, datadir):
        """Downsample given (pt,qt) pulses [MHz] onto spline0 coefficients and
        run (quandary.py:328-347, 444-488)."""
        org = (self.nsplines, self.spline_knot_spacing, self.spline_order,
               [list(c) for c in self.carrier_frequency])
        self.carrier_frequency = [[0.0] for _ in range(len(self.Ne))]
        self.spline_order = 0
        self.spline_knot_spacing = self.dT
        self.nsplines = int(np.max([2, int(np.ceil(self.nsteps * self.dT / self.spline_knot_spacing + 1))]))
        pcof0 = self.downsample_pulses(pt0=pt0, qt0=qt0)
        try:
            result = self._run(pcof0=pcof0, runtype=runtype, datadir=datadir)
        finally:
            (self.nsplines, self.spline_knot_spacing, self.spline_order,
             self.carrier_frequency) = org
        return result

    def downsample_pulses(self, *, pt0=[], qt0=[]):
        """quandary.py:444-488."""
        assert self.spline_order == 0
        Nsys = len(self.Ne)
        pcof0 = np.zeros(0)
        fact = 2e-3 * np.pi
        for iosc in range(Nsys):
            Nelem = np.size(pt0[iosc])
            dt = (self.nsteps * self.dT) / (Nelem - 1)
            seg_re = np.zeros(self.nsplines)
            seg_im = np.zeros(self.nsplines)
            for i_spl in range(self.nsplines):
                t_spl = i_spl * self.spline_knot_spacing
                i = int(np.rint(t_spl / dt))
                i = min(i, Nelem - 1)
                seg_re[i_spl] = fact * pt0[iosc][i]
                seg_im[i_spl] = fact * qt0[iosc][i]
            pcof0 = np.append(pcof0, seg_re)
            pcof0 = np.append(pcof0, seg_im)
        return pcof0

    def _run(self, *, pcof0, runtype, datadir):
        import jax.numpy as jnp

        datadir = resolve_datadir(datadir)
        os.makedirs(datadir, exist_ok=True)

        setup = self._build_setup()
        problem = Problem(setup)
        params0 = np.asarray(pcof0, dtype=float) if len(pcof0) > 0 \
            else self._initial_params(setup.oscillators)
        assert params0.size == setup.nparams, \
            f"pcof0 has {params0.size} entries, expected {setup.nparams}"

        history = []
        if runtype == "optimization":
            bounds_ghz = [[m / 1000.0] for m in
                          (np.atleast_1d(self.maxctrl_MHz)
                           if len(np.atleast_1d(self.maxctrl_MHz)) > 0
                           else [1e15] * len(self.Ne))]
            lb, ub = build_bounds(setup.oscillators, bounds_ghz)
            from .backend import optimizer_driver
            if optimizer_driver(self.optimizer) == "device":
                from .optim.device_driver import run_optimization_device
                res = run_optimization_device(
                    problem, params0, lb, ub, maxiter=self.maxiter,
                    gatol=self.tol_gnorm_abs, grtol=self.tol_gnorm_rel,
                    fatol=self.tol_costfunc, inftol=self.tol_infidelity,
                    monitor_freq=self.print_frequency_iter,
                    verbose=self.verbose, datadir=datadir)
            else:
                res = run_optimization(
                    problem, params0, lb, ub, maxiter=self.maxiter,
                    gatol=self.tol_gnorm_abs, grtol=self.tol_gnorm_rel,
                    fatol=self.tol_costfunc, inftol=self.tol_infidelity,
                    monitor_freq=self.print_frequency_iter,
                    verbose=self.verbose,
                    datadir=datadir)  # durable: streamed history+checkpoints
            params = res.params
            history = res.history
            self.popt = params.tolist()
        else:
            params = params0
            # one objective evaluation for the history row / infidelity
            obj = problem.build_objective()
            J, aux = obj(jnp.asarray(params), jnp.asarray(params0))
            from .optim.driver import OptimHistoryRow
            history = [OptimHistoryRow(
                iter=0, objective=float(J), gnorm=0.0, step=0.0,
                fidelity=float(aux["fidelity"]), cost=float(aux["obj_cost"]),
                tikhonov=float(aux["obj_regul"]), penalty=float(aux["obj_penal"]),
                penalty_dpdm=float(aux["obj_penal_dpdm"]),
                penalty_energy=float(aux["obj_penal_energy"]),
                penalty_variation=float(aux["obj_penal_variation"]))]

        # trajectory + observables
        traj = np.asarray(problem.build_propagate_trajectory()(jnp.asarray(params)))
        result = self._collect_results(problem, setup, params, traj, history, datadir)
        return result

    def _collect_results(self, problem, setup, params, traj, history, datadir):
        """Compute observables, write output files, return the reference's
        6-tuple (time, pt, qt, infidelity, expectedEnergy, population)."""
        import jax.numpy as jnp
        from .ops import solvers as slv

        lind = self._lindblad_solver
        dims = setup.model.dims
        ts_out, p, q, flab = problem.controls_on_output_grid(jnp.asarray(params))
        p = np.asarray(p)
        q = np.asarray(q)
        flab = np.asarray(flab)

        ntp1, B = traj.shape[0], traj.shape[1]
        pop_full = np.asarray(slv.population_full(jnp.asarray(traj), lind))  # (nt+1, B, N)

        expected = [[] for _ in range(len(self.Ne))]
        population = [[] for _ in range(len(self.Ne))]
        # Observables are reported per PHYSICAL initial state, selected
        # directly from problem.initids (the file ids). Only the Lindblad
        # 'basis' batch contains unphysical entries (the off-diagonal
        # B_kj mixtures): keep its diagonal ids i*(nsub+1). Every other
        # batch ('diagonal' [i*(nsub+1)], '3states' [1..3], 'Nplus1'
        # [0..N], pure/file/ensemble [0], Schroedinger basis [0..n-1]) is
        # entirely physical — reconstructing a stride formula per type
        # here used to drop all '3states'/'Nplus1' observables.
        initids = problem.initids
        if lind and setup.initcond_type == "basis":
            nsub = int(round(np.sqrt(problem.ninit)))
            diag_ids = {i * (nsub + 1) for i in range(nsub)}
            sel = [(b, iid) for b, iid in enumerate(initids)
                   if iid in diag_ids]
        else:
            sel = list(enumerate(initids))
        sel.sort(key=lambda bi: bi[1])      # file-id order
        reds = []
        for iosc in range(len(self.Ne)):
            red = np.asarray(slv.reduced_population(jnp.asarray(pop_full), dims, iosc))
            reds.append(red)
            lv = np.arange(dims[iosc])
            for b, _iid in sel:
                population[iosc].append(red[:, b, :].T)
                expected[iosc].append(red[:, b, :] @ lv)

        # uT (quandary.py:853-873): final states, vectorized columns
        xT = traj[-1]
        if lind:
            uT = np.stack([xT[b].reshape(-1, order="F") for b in range(B)], axis=1)
        else:
            uT = xT.T.copy()
        self.uT = uT
        self.time = ts_out.tolist()

        infidelity = 1.0 - history[-1].fidelity if history else 1.0
        self.optim_hist = {
            "Iters": np.array([r.iter for r in history]),
            "Gradient": np.array([r.gnorm for r in history]),
            "Fidelity": np.array([r.fidelity for r in history]),
            "Cost": np.array([r.cost for r in history]),
            "Tikhonov": np.array([r.tikhonov for r in history]),
            "Penalty-Leakage": np.array([r.penalty for r in history]),
            "Penalty-StateVariation": np.array([r.penalty_dpdm for r in history]),
            "Penalty-TotalEnergy": np.array([r.penalty_energy for r in history]),
        }

        # ---- write output files (reference formats) ----
        if datadir:
            out_io.write_params(os.path.join(datadir, "params.dat"), params)
            out_io.write_controls(datadir, ts_out, p, q, flab)
            out_io.write_optim_history(os.path.join(datadir, "optim_history.dat"), history)
            for iosc in range(len(self.Ne)):
                red = reds[iosc]
                lv = np.arange(dims[iosc])
                for b, initid in enumerate(initids):
                    out_io.write_expected_energy(datadir, iosc, initid, ts_out,
                                                 red[:, b, :] @ lv)
                    out_io.write_population(datadir, iosc, initid, ts_out, red[:, b, :])
            for b, initid in enumerate(initids):
                out_io.write_fullstate(datadir, initid, ts_out, traj[:, b], lind)

        pt = [p[:, k] / (2 * np.pi) * 1e3 for k in range(len(self.Ne))]
        qt = [q[:, k] / (2 * np.pi) * 1e3 for k in range(len(self.Ne))]
        return ts_out.tolist(), pt, qt, infidelity, expected, population

    def dump_reference_config(self, *, pcof0=[], runtype="optimization",
                              datadir="./run_dir") -> str:
        """Write a reference-compatible config.cfg (+ targetgate.dat /
        targetstate.dat / initialstate.dat / pcof0.dat / hamiltonian_*.dat)
        into datadir — the mirror of the reference's __dump
        (quandary.py:551-762). The directory can be executed by the
        reference C++ binary OR by `python -m quandary_tpu` (bidirectional
        migration). Returns the config file path."""
        datadir = resolve_datadir(datadir)
        os.makedirs(datadir, exist_ok=True)

        gatefile = ""
        if len(self.targetgate) > 0:
            gatefile = "targetgate.dat"
            datafiles.write_complex_state(
                os.path.join(datadir, gatefile),
                np.asarray(self.targetgate, dtype=complex))
        elif len(self.targetstate) > 0:
            gatefile = "targetstate.dat"
            state = np.asarray(self.targetstate, dtype=complex)
            if self._lindblad_solver:
                state = np.outer(state, state.conj())
            datafiles.write_complex_state(os.path.join(datadir, gatefile), state)

        initfile = ""
        if str(self.initialcondition)[0:4] == "file":
            initfile = "initialstate.dat"
            state = np.asarray(self._initialstate, dtype=complex)
            if self._lindblad_solver:
                state = np.outer(state, state.conj())
            datafiles.write_complex_state(os.path.join(datadir, initfile), state)

        hsys_file = hc_file = ""
        if not self.standardmodel:
            hsys_file = "hamiltonian_Hsys.dat"
            datafiles.write_hamiltonian_sys(
                os.path.join(datadir, hsys_file), np.asarray(self.Hsys))
            if len(self.Hc_re) > 0 or len(self.Hc_im) > 0:
                hc_file = "hamiltonian_Hc.dat"
                datafiles.write_hamiltonian_ctrl(
                    os.path.join(datadir, hc_file), self.Hc_re, self.Hc_im)

        read_pcof = False
        use_pcof = list(pcof0) if len(pcof0) > 0 else list(self.pcof0)
        if len(use_pcof) > 0:
            datafiles.write_vector(os.path.join(datadir, "pcof0.dat"), use_pcof)
            read_pcof = True

        Nt = self.nlevels
        lines = []
        lines.append("nlevels = " + ",".join(str(i) for i in Nt))
        lines.append("nessential= " + ",".join(str(i) for i in self.Ne))
        lines.append(f"ntime = {self.nsteps}")
        lines.append(f"dt = {self.dT}")
        lines.append("transfreq = " + ",".join(str(f) for f in self.freq01))
        lines.append("rotfreq= " + ",".join(str(f) for f in self.rotfreq))
        lines.append("selfkerr = " + ",".join(str(f) for f in self.selfkerr))
        lines.append("crosskerr= " + (",".join(str(f) for f in self.crosskerr)
                                      if len(self.crosskerr) else "0.0"))
        lines.append("Jkl= " + (",".join(str(f) for f in self.Jkl)
                                if len(self.Jkl) else "0.0"))
        decay, dephase = len(self.T1) > 0, len(self.T2) > 0
        if decay:
            lines.append("decay_time = " + ",".join(str(f) for f in self.T1))
        if dephase:
            lines.append("dephase_time = " + ",".join(str(f) for f in self.T2))
        lines.append("collapse_type = " + ("both" if decay and dephase else
                                           "decay" if decay else
                                           "dephase" if dephase else "none"))
        if str(self.initialcondition)[0:4] == "file":
            lines.append(f"initialcondition = file, {initfile}")
        else:
            lines.append(f"initialcondition = {self.initialcondition}")
        kind = "spline" if self.spline_order == 2 else "spline0"
        for iosc in range(len(self.Ne)):
            lines.append(f"control_segments{iosc} = {kind}, {self.nsplines}")
            if read_pcof:
                lines.append(f"control_initialization{iosc} = file, pcof0.dat")
            else:
                nf = len(np.atleast_1d(self.carrier_frequency[iosc]))
                amp = float(np.atleast_1d(self.initctrl_MHz)[iosc]) / 1000.0 / np.sqrt(2) / nf
                mode = "random" if self.randomize_init_ctrl else "constant"
                lines.append(f"control_initialization{iosc} = {mode}, {amp}")
            bound = (float(np.atleast_1d(self.maxctrl_MHz)[iosc]) / 1000.0
                     if len(np.atleast_1d(self.maxctrl_MHz)) else 1e12)
            lines.append(f"control_bounds{iosc} = {bound}")
            lines.append(f"carrier_frequency{iosc} = "
                         + ", ".join(str(f) for f in np.atleast_1d(self.carrier_frequency[iosc])))
        lines.append(f"control_enforceBC = {self.control_enforce_BC}")
        if gatefile:
            lines.append(f"optim_target = {self.optim_target}, {gatefile}")
        else:
            lines.append(f"optim_target = {self.optim_target}")
        lines.append(f"optim_objective = {self.costfunction}")
        lines.append("gate_rot_freq = " + ", ".join(str(v) for v in self.gate_rot_freq))
        lines.append("optim_weights= 1.0")
        lines.append(f"optim_atol= {self.tol_gnorm_abs}")
        lines.append(f"optim_rtol= {self.tol_gnorm_rel}")
        lines.append(f"optim_ftol= {self.tol_costfunc}")
        lines.append(f"optim_inftol= {self.tol_infidelity}")
        lines.append(f"optim_maxiter= {self.maxiter}")
        if self.gamma_tik0_interpolate > 0.0:
            lines.append(f"optim_regul= {self.gamma_tik0_interpolate}")
            lines.append("optim_regul_tik0 = true")
        else:
            lines.append(f"optim_regul= {self.gamma_tik0}")
            lines.append("optim_regul_tik0=false")
        lines.append(f"optim_penalty= {self.gamma_leakage}")
        lines.append("optim_penalty_param= 0.0")
        lines.append(f"optim_penalty_dpdm= {self.gamma_dpdm}")
        lines.append(f"optim_penalty_variation= {self.gamma_variation}")
        lines.append(f"optim_penalty_energy= {self.gamma_energy}")
        lines.append("datadir= ./")
        for iosc in range(len(self.Ne)):
            lines.append(f"output{iosc}=expectedEnergy, population, fullstate")
        lines.append("output_frequency = 1")
        lines.append(f"optim_monitor_frequency = {self.print_frequency_iter}")
        lines.append(f"runtype = {runtype}")
        lines.append(f"usematfree = {self.usematfree}")
        lines.append("linearsolver_type = gmres")
        lines.append(f"linearsolver_maxiter = {self.linearsolver_maxiter}")
        if hsys_file:
            lines.append(f"hamiltonian_file_Hsys= {hsys_file}")
        if hc_file:
            lines.append(f"hamiltonian_file_Hc= {hc_file}")
        lines.append(f"timestepper = {self.timestepper}")
        if self.rand_seed is not None and self.rand_seed >= 0:
            lines.append(f"rand_seed = {int(self.rand_seed)}")
        outpath = os.path.join(datadir, "config.cfg")
        with open(outpath, "w", newline="\n") as f:
            f.write("\n".join(lines) + "\n")
        return outpath

    def get_results(self, *, datadir="./", ignore_failure=False):
        """Parse a reference-format output directory (quandary.py:765-893):
        works on directories written by this framework OR by the reference
        binary (migration compatibility). Returns the reference's 9-tuple
        (time, pt, qt, uT, expectedEnergy, population, pcof, infid, hist)."""
        datadir = resolve_datadir(datadir)

        def _load(fname, **kw):
            try:
                return np.loadtxt(os.path.join(datadir, fname), **kw)
            except Exception:
                if not ignore_failure:
                    print(f"Can't read {fname} from {datadir}")
                return None

        pcof = _load("params.dat")
        pcof = pcof.astype(float) if pcof is not None else []

        hist = _load("optim_history.dat")
        if hist is None:
            hist = np.zeros((1, 11))
        if hist.ndim == 1:
            hist = hist[None, :]
        infid_last = 1.0 - hist[-1, 4]
        optim_hist = {
            "Iters": hist[:, 0], "Gradient": hist[:, 2], "Fidelity": hist[:, 4],
            "Cost": hist[:, 5], "Tikhonov": hist[:, 6],
            "Penalty-Leakage": hist[:, 7], "Penalty-StateVariation": hist[:, 8],
            "Penalty-TotalEnergy": hist[:, 9],
        }

        # discover the written initial-condition ids from the directory
        # instead of recomputing them from prod(Ne) (subset
        # initialconditions stride by the SELECTED basis size); for
        # Lindblad BASIS runs — recognized by the discovered ids being the
        # full contiguous 0..nsub^2-1 set — keep only the diagonal
        # (physical) ids i*(nsub+1), matching the reference. Non-basis
        # Lindblad runs ('diagonal' writes [0, nsub+1, ...], '3states'
        # writes [1,2,3], ...) already name files by their physical ids:
        # keep them verbatim (a len()-only square test used to misfire on
        # a 4-state diagonal run, rewriting [0,5,10,15] -> [0,3]).
        import glob as _glob
        import re as _re
        expectedEnergy = [[] for _ in range(len(self.Ne))]
        population = [[] for _ in range(len(self.Ne))]
        ids = sorted({int(m.group(1)) for f in _glob.glob(
            os.path.join(datadir, "expected0.iinit*.dat"))
            for m in [_re.search(r"iinit(\d+)\.dat$", f)] if m})
        if (self._lindblad_solver and ids
                and str(self.initialcondition).startswith("basis")):
            nsub = int(round(np.sqrt(len(ids))))
            if (nsub * nsub == len(ids) and nsub > 1
                    and ids == list(range(len(ids)))):
                ids = [i * (nsub + 1) for i in range(nsub)]
        for iosc in range(len(self.Ne)):
            for iid in ids:
                x = _load(f"expected{iosc}.iinit{iid:04d}.dat")
                if x is not None:
                    expectedEnergy[iosc].append(x[:, 1])
                x = _load(f"population{iosc}.iinit{iid:04d}.dat")
                if x is not None:
                    population[iosc].append(x[:, 1:].transpose())

        Ntot = [i + j for i, j in zip(self.Ne, self.Ng)]
        ndim = int(np.prod(Ntot)) if not self._lindblad_solver else int(np.prod(Ntot)) ** 2
        # like expected/population above, the rho files are named by the
        # PHYSICAL initial-condition id ('diagonal' Lindblad runs write
        # [0, nsub+1, ...], '3states' writes [1,2,3], ...), so discover the
        # ids from the directory; range(self._ninit) would silently read
        # missing files and leave those uT columns zero.
        rho_ids = sorted({int(m.group(1)) for f in _glob.glob(
            os.path.join(datadir, "rho_Re.iinit*.dat"))
            for m in [_re.search(r"iinit(\d+)\.dat$", f)] if m})
        if not rho_ids:
            rho_ids = list(range(self._ninit))
        uT = np.zeros((ndim, len(rho_ids)), dtype=complex)
        for col, iinit in enumerate(rho_ids):
            xre = _load(f"rho_Re.iinit{iinit:04d}.dat")
            xim = _load(f"rho_Im.iinit{iinit:04d}.dat")
            if xre is not None:
                uT[:, col] = np.atleast_2d(xre)[-1, 1:ndim + 1]
            if xim is not None:
                uT[:, col] += 1j * np.atleast_2d(xim)[-1, 1:ndim + 1]

        pt, qt, time = [], [], []
        for iosc in range(len(self.Ne)):
            x = _load(f"control{iosc}.dat")
            if x is None:
                x = np.zeros((1, 4))
            time = x[:, 0]
            pt.append([v * 1e3 for v in x[:, 1]])
            qt.append([v * 1e3 for v in x[:, 2]])

        return time, pt, qt, uT, expectedEnergy, population, pcof, infid_last, optim_hist
