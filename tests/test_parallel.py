"""Mesh-sharded multistart tests on the 8-virtual-device CPU mesh
(conftest sets xla_force_host_platform_device_count=8).

These validate the distribution layer the reference never had: DP-sharded
multistart L-BFGS fleets, best-of-batch selection across devices, and
SP-sharded Hessian time-rows — with value equality against the unsharded
path (the multi-chip analogue of the reference's seq-vs-parallel
determinism tests, GradientTests.cpp:261-285).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from optimalcontrolmps import engine, groundstate, tebd
from optimalcontrolmps import control as controllib
from optimalcontrolmps import seeds
from optimalcontrolmps.parallel import make_mesh, multistart_lbfgs
from optimalcontrolmps.parallel.multistart import make_train_step

L, D, NPART = 4, 3, 4
T, TSTEP, M, CHI = 0.1, 1e-2, 4, 16
N = int(T / TSTEP + 1)


@pytest.fixture(scope="module")
def pieces():
    st = tebd.make_stepper(L, D, 1.0, TSTEP, CHI)
    psi_i = groundstate.initialize_state(L, D, NPART, 1.0, 2.5, CHI)
    psi_f = groundstate.initialize_state(L, D, NPART, 1.0, 50.0, CHI)
    basis = controllib.chopped_sine_basis(
        seeds.linspace(2.5, 50.0, N), TSTEP, T, M)
    return st, psi_i, psi_f, basis


def test_mesh_construction():
    assert len(jax.devices()) >= 8
    mesh = make_mesh(8)
    assert mesh.devices.size == 8
    assert set(mesh.axis_names) == {"batch", "rows"}
    mesh4 = make_mesh(4, rows=2)
    assert mesh4.devices.shape == (2, 2)


def test_sharded_multistart_matches_unsharded(pieces):
    st, psi_i, psi_f, basis = pieces
    rng = np.random.default_rng(0)
    c0 = jnp.asarray(rng.normal(0, 0.3, (8, M)))
    # 2-device mesh, 5 iterations: the sharded-vs-unsharded equality is
    # device-count independent, and every lockstep L-BFGS iteration
    # all-reduces across the mesh — at 8 virtual devices on a 2-core
    # host that made THIS test 40% of the whole suite's wall time
    # (437 s isolated; 2-dev/5-iter: ~30 s, same property)
    mesh = make_mesh(2)
    res_sh = multistart_lbfgs(st, psi_i, psi_f, basis, c0, gamma=1e-6,
                              max_iter=5, mesh=mesh)
    res_un = multistart_lbfgs(st, psi_i, psi_f, basis, c0, gamma=1e-6,
                              max_iter=5, mesh=None)
    np.testing.assert_allclose(np.asarray(res_sh.all_costs),
                               np.asarray(res_un.all_costs), atol=1e-10)
    assert float(res_sh.best_cost) == float(np.asarray(res_sh.all_costs).min())


def test_train_step_with_row_sharded_hessian(pieces):
    st, psi_i, psi_f, basis = pieces
    # (2, 2) mesh: exercises BOTH axes (batch DP + rows SP) at a
    # fraction of the 8-device oversubscription cost
    mesh = make_mesh(4, rows=2)
    step, sh = make_train_step(st, psi_i, psi_f, basis, gamma=1e-6,
                               lr=10.0, mesh=mesh, with_hessian=True)
    cs = jax.device_put(np.zeros((16, M)), sh)
    cs2, costs, best, hdiag = step(cs)
    jax.block_until_ready((cs2, costs, best, hdiag))
    assert cs2.shape == (16, M)
    assert hdiag.shape == (N,)
    # unsharded reference for the Hessian diagonal
    u0 = basis.convert_control(jnp.zeros(M))
    H = engine.hessian(st, psi_i, psi_f, u0, 1e-6)
    np.testing.assert_allclose(np.asarray(hdiag), np.asarray(jnp.diagonal(H)),
                               atol=1e-10)


def test_scaling_bench_harness():
    """Weak-scaling harness runs over 1/2/4/8 virtual devices and reports
    sane efficiencies (SURVEY.md section 7 item 8)."""
    from optimalcontrolmps.drivers import scaling_bench

    res = scaling_bench.run(per_device_batch=4, steps=1)
    assert [r["devices"] for r in res["rows"]] == [1, 2, 4, 8]
    for r in res["rows"]:
        assert r["ramps_per_s"] > 0
        assert np.isfinite(r["efficiency"])


def test_best_of_batch_monotone(pieces):
    """Best-of-B multistart is monotone in B for nested seed sets (the
    4096-multistart production property, BASELINE configs[5]): the larger
    fleet contains the smaller fleet's seeds, so its best cost can only be
    <= — and the winning seed's solve must agree between the two runs."""
    st, psi_i, psi_f, basis = pieces
    rng = np.random.default_rng(11)
    big = rng.normal(0.0, 0.5, (16, M)).astype(np.float64)
    small = big[:4]  # nested

    r_small = multistart_lbfgs(st, psi_i, psi_f, basis,
                               jnp.asarray(small), gamma=1e-6, max_iter=4)
    r_big = multistart_lbfgs(st, psi_i, psi_f, basis,
                             jnp.asarray(big), gamma=1e-6, max_iter=4)
    assert float(r_big.best_cost) <= float(r_small.best_cost) + 1e-12
    # lockstep vmap: identical seeds give identical per-seed results
    assert np.allclose(np.asarray(r_big.all_costs[:4]),
                       np.asarray(r_small.all_costs), atol=1e-10)


def test_vidal_tensor_parallel_rollout_matches():
    """Lattice-TP bond updates (vidal.rollout_final_tp: bond batches
    sharded over the mesh "rows" axis) must produce the same state as
    the unsharded rollout — sharding is a layout annotation, not a
    numerics change."""
    from optimalcontrolmps import vidal

    L, d, npart, chi = 6, 3, 6, 12
    st = tebd.make_stepper(L, d, 1.0, 0.01, chi, sweep="vidal")
    psi0 = vidal.from_mps(groundstate.initialize_state(
        L, d, npart, 1.0, 2.5, chi))
    u = jnp.asarray(seeds.linspace(2.5, 50.0, 9))

    ref = jax.jit(lambda uu: vidal.rollout_final(st, psi0, uu))(u)
    mesh = make_mesh(8, rows=4)   # 4-way TP x 2-way batch
    tp = jax.jit(lambda uu: vidal.rollout_final_tp(st, psi0, uu,
                                                   mesh))(u)
    # Vidal tensors carry an eigh-basis gauge that differs between
    # compilations; compare the PHYSICAL state and the gauge-invariant
    # Schmidt spectra instead
    from optimalcontrolmps import mps
    v_ref = np.asarray(mps.to_statevector(ref.B))
    v_tp = np.asarray(mps.to_statevector(tp.B))
    ov = abs(np.vdot(v_ref, v_tp)) / (np.linalg.norm(v_ref)
                                      * np.linalg.norm(v_tp))
    assert abs(ov - 1.0) < 1e-10, ov
    # tail Schmidt values below ~1e-7 sit in degenerate null space and
    # differ by compilation; they carry < 1e-13 state weight
    np.testing.assert_allclose(vidal.schmidt_values(tp),
                               vidal.schmidt_values(ref), atol=1e-6)
