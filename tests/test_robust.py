"""Robust ensemble control: gradient equals the weighted sum of per-sample
gradients; robust optimization beats the nominal pulse on detuned samples."""

import jax
import jax.numpy as jnp
import numpy as np

from quandary_tpu.optim.driver import build_bounds
from quandary_tpu.optim.robust import (build_robust_objective,
                                       build_robust_value_and_grad,
                                       sample_standard_models)
from quandary_tpu.utils.splines import ControlSegment, OscillatorControl


def _setup_common(T=60.0, ntime=300):
    osc = OscillatorControl(
        segments=(ControlSegment("spline", nsplines=10, tstart=0.0, tstop=T),),
        carrier_freqs=(0.0,))
    return dict(
        nessential=(2,), ntime=ntime, dt=T / ntime, oscillators=(osc,),
        ground_freqs_radns=(1.0,),
        initcond_type="pure", pure_levels=(0,),
        target_type="pure", pure_target_levels=(1,),
        objective_type="Jtrace", gamma_tik=1e-6)


def _samples(deltas):
    base = dict(nlevels=[2], freq01_ghz=[4.1], rotfreq_ghz=[4.1],
                selfkerr_ghz=[0.2])
    return sample_standard_models(
        base,
        [{"freq01_ghz": [4.1 + d]} for d in deltas],
        _setup_common())


def test_robust_gradient_is_weighted_sum():
    problems = _samples([0.0, 0.002])
    w = [0.6, 0.4]
    obj = build_robust_objective(problems, w)
    rng = np.random.default_rng(0)
    params = jnp.asarray(rng.normal(size=problems[0].setup.nparams) * 0.02)
    (J, aux), g = jax.value_and_grad(obj, has_aux=True)(params, params)

    total = 0.0
    gsum = np.zeros(params.shape)
    for p, ws in zip(problems, w):
        (Js, _), gs = jax.value_and_grad(p.objective, has_aux=True)(params, params)
        total += ws * float(Js)
        gsum += ws * np.asarray(gs)
    assert abs(float(J) - total) < 1e-12
    np.testing.assert_allclose(np.asarray(g), gsum, rtol=1e-12, atol=1e-15)
    assert aux["fidelity_per_sample"].shape == (2,)


def test_robust_optimization_improves_worst_case():
    """Optimize over a +-2 MHz detuning ensemble; the robust pulse's WORST
    sample fidelity must beat the nominal-optimized pulse's worst sample."""
    from quandary_tpu.optim.lbfgsb import minimize_lbfgsb

    deltas = [-0.01, 0.0, 0.01]
    problems = _samples(deltas)
    nominal = problems[1]
    rng = np.random.default_rng(1)
    x0 = rng.uniform(-1, 1, nominal.setup.nparams) * 0.01
    lb, ub = build_bounds(nominal.setup.oscillators, [[1.0]])

    def make_fg(obj):
        vg = jax.jit(jax.value_and_grad(obj, has_aux=True))

        def fg(x):
            (f, aux), g = vg(jnp.asarray(x), jnp.zeros_like(jnp.asarray(x)))
            return float(f), np.asarray(g, dtype=np.float64), aux
        return fg

    res_nom = minimize_lbfgsb(make_fg(nominal.objective), x0, lb, ub, maxiter=40)
    obj_rob = build_robust_objective(problems)
    res_rob = minimize_lbfgsb(make_fg(obj_rob), x0, lb, ub, maxiter=40)

    def worst_infid(x):
        worst = 0.0
        for p in problems:
            _, aux = p.objective(jnp.asarray(x), jnp.zeros(p.setup.nparams))
            worst = max(worst, 1.0 - float(aux["fidelity"]))
        return worst

    w_nom = worst_infid(res_nom.x)
    w_rob = worst_infid(res_rob.x)
    assert w_rob < w_nom, (w_rob, w_nom)


def test_packed_robust_matches_per_sample(fused_on_cpu):
    """The robust objective over samples that each run the fused kernel
    must reproduce the same objective over XLA-scan samples: J, every aux
    column, and the gradient."""
    import jax.numpy as jnp

    base = dict(nlevels=[3], freq01_ghz=[4.1], rotfreq_ghz=[4.1],
                selfkerr_ghz=[0.2])
    common = _setup_common()
    common.update(nessential=(2,), pallas=True, dtype=jnp.complex64,
                  gamma_penalty=0.05, gamma_penalty_energy=0.02)
    samples = [{"freq01_ghz": [4.1 + d]} for d in (0.0, 0.002, -0.003)]
    problems = sample_standard_models(base, samples, common)
    assert all(p.use_pallas for p in problems)
    scan = sample_standard_models(base, samples,
                                  dict(common, pallas=False))
    assert not any(p.use_pallas for p in scan)
    w = [0.5, 0.3, 0.2]
    obj0 = build_robust_objective(scan, w)
    obj1 = build_robust_objective(problems, w)
    rng = np.random.default_rng(0)
    params = jnp.asarray(rng.normal(size=problems[0].setup.nparams) * 0.02,
                         jnp.float32)
    ref = jnp.zeros_like(params)
    (J0, a0), g0 = jax.jit(jax.value_and_grad(obj0, has_aux=True))(params, ref)
    (J1, a1), g1 = jax.jit(jax.value_and_grad(obj1, has_aux=True))(params, ref)
    np.testing.assert_allclose(float(J1), float(J0), rtol=5e-6)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g0), rtol=0,
                               atol=5e-6 * float(jnp.abs(g0).max()))
    for k in a0:
        np.testing.assert_allclose(np.asarray(a1[k]), np.asarray(a0[k]),
                                   rtol=1e-5, atol=1e-8, err_msg=k)
