"""Multi-device mesh sharding on the virtual 8-device CPU mesh: the sharded
objective/gradient must equal the unsharded one, and the driver's
dryrun_multichip must pass."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, ".")


def test_sharded_objective_matches_unsharded():
    from __graft_entry__ import _build_problem
    from quandary_tpu.parallel.mesh import make_mesh, shard_problem

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")

    prob_ref, setup = _build_problem(ntime=12, T=2.0, lindblad=True,
                                     dtype=jnp.complex128)
    params = jnp.asarray(np.random.default_rng(0).normal(size=setup.nparams) * 0.02)
    (J_ref, aux_ref), g_ref = jax.value_and_grad(
        prob_ref.objective, has_aux=True)(params, params)

    for (ni, nh) in [(8, 1), (4, 2), (2, 2)]:
        prob, setup2 = _build_problem(ntime=12, T=2.0, lindblad=True,
                                      dtype=jnp.complex128)
        mesh = make_mesh(ni, nh)
        shard_problem(prob, mesh, shard_hilbert=(nh > 1))
        with mesh:
            (J, aux), g = jax.jit(jax.value_and_grad(
                prob.objective, has_aux=True))(params, params)
        assert abs(float(J) - float(J_ref)) < 1e-10, (ni, nh)
        np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                                   rtol=1e-8, atol=1e-12)


def test_sharded_grouped_matches_unsharded():
    """Hilbert-axis sharding for the GroupedEngine (the large-N flagship):
    the (B, m1, m2) state sharded on m1 over 'hilbert' must reproduce the
    unsharded objective and gradient exactly — X @ H_R^T and the diagonal
    cross-Kerr mask are local, H_L @ X and the cross-JC products gather the
    state over 'hilbert' (parallel/mesh.py). Also covers the composed
    path (shard_problem THEN build_value_and_grad: _wrap_with_data must
    materialize the threaded arrays with mesh shardings).

    One mesh config per path: the SPMD-partitioned reversible-adjoint
    compile is ~2 min/config on the virtual CPU mesh, so this test keeps
    the config set minimal; dryrun_multichip exercises a second shape.
    """
    from __graft_entry__ import _build_grouped_problem
    from quandary_tpu.parallel.mesh import make_mesh, shard_problem

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")

    # nlev=4 -> m1 = m2 = 16, divisible by every hilbert-axis size used
    kw = dict(nlev=4, ntime=8, T=0.8, dtype=jnp.complex128,
              linsolve_iters=4)
    prob_ref, setup = _build_grouped_problem(**kw)
    params = jnp.asarray(
        np.random.default_rng(3).normal(size=setup.nparams) * 0.02)
    (J_ref, aux_ref), g_ref = jax.value_and_grad(
        prob_ref.objective, has_aux=True)(params, params)

    # direct jit of problem.objective on a 2x4 mesh
    prob, _ = _build_grouped_problem(**kw)
    mesh = make_mesh(2, 4)
    shard_problem(prob, mesh, shard_hilbert=True)
    with mesh:
        (J, aux), g = jax.jit(jax.value_and_grad(
            prob.objective, has_aux=True))(params, params)
    assert abs(float(J) - float(J_ref)) < 1e-10
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                               rtol=1e-8, atol=1e-12)

    # composed wrapped path on a 4x2 mesh
    prob2, _ = _build_grouped_problem(**kw)
    mesh2 = make_mesh(4, 2)
    shard_problem(prob2, mesh2, shard_hilbert=True)
    with mesh2:
        vg = prob2.build_value_and_grad()
        (J2, _), g2 = vg(params, params)
    assert abs(float(J2) - float(J_ref)) < 1e-10
    np.testing.assert_allclose(np.asarray(g2), np.asarray(g_ref),
                               rtol=1e-8, atol=1e-12)


def test_ensemble_sharded_matches_unsharded(fused_on_cpu):
    """The candidate/ensemble axis — the one that delivers the headline
    throughput metric — sharded over the mesh via shard_map must reproduce
    the unsharded vmapped value_and_grad and the pipelined-sweeps scalar
    exactly, for BOTH the XLA scan path and the fused GPU kernel (here in
    the Pallas interpreter; it runs whole per shard, GSPMD cannot
    partition it). This is the
    multi-chip analog of the reference's comm_init split
    (optimproblem.cpp:85-91)."""
    import dataclasses

    from __graft_entry__ import _build_problem
    from quandary_tpu.parallel.mesh import make_mesh
    from quandary_tpu.problem import Problem

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")

    _, setup = _build_problem(ntime=12, T=2.0)
    prob_x = Problem(dataclasses.replace(setup, pallas=False))
    prob_p = Problem(dataclasses.replace(setup, pallas=True))
    assert prob_p.use_pallas and not prob_x.use_pallas

    E, R = 16, 2
    rng = np.random.default_rng(7)
    Ps = jnp.asarray(rng.normal(size=(R, E, setup.nparams)) * 0.02,
                     dtype=jnp.float32)
    ref = jnp.zeros((setup.nparams,), jnp.float32)

    for name, prob in [("xla", prob_x), ("pallas", prob_p)]:
        for mesh in (make_mesh(8, 1), make_mesh(4, 2)):
            with mesh:
                su = prob.build_ensemble_sweeps()(Ps, ref)
                ss = prob.build_ensemble_sweeps(mesh=mesh)(Ps, ref)
                (Ju, _), gu = prob.build_ensemble_value_and_grad()(Ps[0], ref)
                (Js, _), gs = prob.build_ensemble_value_and_grad(
                    mesh=mesh)(Ps[0], ref)
            np.testing.assert_allclose(float(ss), float(su), rtol=1e-6,
                                       err_msg=name)
            np.testing.assert_allclose(np.asarray(Js), np.asarray(Ju),
                                       rtol=1e-6, atol=0, err_msg=name)
            np.testing.assert_allclose(np.asarray(gs), np.asarray(gu),
                                       rtol=1e-5, atol=1e-7, err_msg=name)

    # non-divisible ensemble is a loud error, not silent truncation
    bad = jnp.zeros((R, 6, setup.nparams), jnp.float32)
    with pytest.raises(ValueError, match="not divisible"):
        with make_mesh(8, 1) as mesh:
            prob_x.build_ensemble_sweeps(mesh=mesh)(bad, ref)


def test_dryrun_multichip():
    from __graft_entry__ import dryrun_multichip

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    dryrun_multichip(8)
    dryrun_multichip(2)


def test_sharded_tensor_engine_matches_unsharded():
    """Hilbert-axis sharding for the TensorEngine (per-axis contractions,
    the ANY-Q engine): the flat (B, N) state sharded on N over 'hilbert'
    must reproduce the unsharded objective/gradient exactly. GSPMD
    propagates the flat-N sharding through the (B, n1..nQ) reshape and
    inserts the contractions' collectives — this closes the round-2
    'TensorEngine replicated over hilbert' coverage hole."""
    import dataclasses

    from __graft_entry__ import _build_grouped_problem
    from quandary_tpu.ops.tensor_rhs import TensorEngine
    from quandary_tpu.parallel.mesh import make_mesh, shard_problem
    from quandary_tpu.problem import Problem

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")

    _, setup = _build_grouped_problem(nlev=4, ntime=8, T=0.8,
                                      dtype=jnp.complex128,
                                      linsolve_iters=4)
    setup_t = dataclasses.replace(setup, engine="tensor")
    prob_ref = Problem(setup_t)
    assert isinstance(prob_ref.engine, TensorEngine)
    params = jnp.asarray(
        np.random.default_rng(3).normal(size=setup.nparams) * 0.02)
    (J0, _), g0 = jax.value_and_grad(prob_ref.objective, has_aux=True)(
        params, params)

    prob = Problem(setup_t)
    mesh = make_mesh(2, 4)
    shard_problem(prob, mesh, shard_hilbert=True)
    with mesh:
        (J1, _), g1 = jax.jit(jax.value_and_grad(
            prob.objective, has_aux=True))(params, params)
    assert float(J0) == float(J1)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g0),
                               rtol=1e-12, atol=1e-15)


def test_sharded_population_optimization_matches_unsharded(fused_on_cpu):
    """A WHOLE population optimization (batched projected L-BFGS on the
    fused kernel) sharded over the candidate axis via
    sharded_batch_fns(mesh) must reproduce the unsharded optimization:
    same objective traces, same final candidates. This extends the
    multi-device evidence from throughput probes to the delivered optimizer."""
    import dataclasses

    from __graft_entry__ import _build_problem
    from quandary_tpu.optim.batched_lbfgs import batched_lbfgsb
    from quandary_tpu.parallel.mesh import make_mesh
    from quandary_tpu.problem import Problem

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")

    prob, setup = _build_problem(ntime=12, T=2.0)
    prob = Problem(dataclasses.replace(setup, pallas=True))
    assert prob.use_pallas

    E, iters = 16, 6
    rng = np.random.default_rng(11)
    x0s = jnp.asarray(rng.normal(size=(E, setup.nparams)) * 0.02,
                      dtype=jnp.float32)
    ref = jnp.zeros((setup.nparams,), jnp.float32)
    lb = -0.5 * np.ones(setup.nparams, np.float32)
    ub = 0.5 * np.ones(setup.nparams, np.float32)

    def objective(x):
        J, _ = prob.objective(x, ref)
        return J

    def run(mesh):
        kw = {} if mesh is None else prob.sharded_batch_fns(ref, mesh)
        f = prob._wrap_with_data(lambda xs: batched_lbfgsb(
            objective, jax.grad(objective), xs, lb, ub,
            iters=iters, history=4, **kw))
        return f(x0s)

    xu, fu, tru = run(None)
    with make_mesh(8, 1) as mesh:
        xs_, fs, trs = run(mesh)

    np.testing.assert_allclose(np.asarray(trs), np.asarray(tru),
                               rtol=2e-5, atol=1e-8)
    np.testing.assert_allclose(np.asarray(fs), np.asarray(fu),
                               rtol=2e-5, atol=1e-8)
    np.testing.assert_allclose(np.asarray(xs_), np.asarray(xu),
                               rtol=1e-4, atol=1e-7)
