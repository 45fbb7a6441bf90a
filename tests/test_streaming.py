"""Streaming rollout / segmented-gradient equivalence tests.

The streaming paths (engine/vidal `fidelities_streaming`,
`gradient_segmented`, `vidal.rollout_diagnostics`) must produce the SAME
values as the stacking paths — they only change the memory schedule.
Small L so the whole suite stays in the smoke tier.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from optimalcontrolmps import engine, groundstate, seeds, tebd, vidal
from optimalcontrolmps.streaming import pick_segment

L, NPART, D = 4, 4, 3
J, TSTEP = 1.0, 0.01
N = 31            # 30 steps: segments divide as 2,3,5,6,10,15
CHI = 16


@pytest.fixture(scope="module")
def mps_problem():
    st = tebd.make_stepper(L, D, J, TSTEP, CHI)
    psi_i = groundstate.initialize_state(L, D, NPART, J, 2.5, CHI)
    psi_f = groundstate.initialize_state(L, D, NPART, J, 50.0, CHI)
    u = jnp.asarray(seeds.linspace(2.5, 50.0, N))
    return st, psi_i, psi_f, u


@pytest.fixture(scope="module")
def vidal_problem():
    st = tebd.make_stepper(L, D, J, TSTEP, CHI, sweep="vidal")
    psi_i = vidal.from_mps(groundstate.initialize_state(
        L, D, NPART, J, 2.5, CHI))
    psi_f = vidal.from_mps(groundstate.initialize_state(
        L, D, NPART, J, 50.0, CHI))
    u = jnp.asarray(seeds.linspace(2.5, 50.0, N))
    return st, psi_i, psi_f, u


def test_pick_segment():
    assert pick_segment(30) == 5       # sqrt(30) ~ 5.48 -> 5 divides
    assert pick_segment(1000) == 25    # 31 -> largest divisor <= 31 is 25
    assert pick_segment(30, 6) == 6
    assert pick_segment(7) == 1        # prime: only 1 divides
    assert pick_segment(1, None) == 1


def test_engine_fidelities_streaming(mps_problem):
    st, psi_i, psi_f, u = mps_problem
    full = np.asarray(engine.fidelities(st, psi_i, psi_f, u))
    stream = np.asarray(jax.jit(
        lambda uu: engine.fidelities_streaming(st, psi_i, psi_f, uu))(u))
    assert stream.shape == (N,)
    np.testing.assert_allclose(stream, full, rtol=0, atol=1e-12)


def test_engine_gradient_segmented(mps_problem):
    st, psi_i, psi_f, u = mps_problem
    g_ref, (_, _, divT_ref, ov_ref) = engine.gradient(
        st, psi_i, psi_f, u, 1e-6)
    for seg in (None, 3, 10):
        g, (psiT, divT, ov) = jax.jit(
            lambda uu: engine.gradient_segmented(st, psi_i, psi_f, uu,
                                                 1e-6, seg=seg))(u)
        np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                                   rtol=0, atol=1e-11)
        np.testing.assert_allclose(np.asarray(divT), np.asarray(divT_ref),
                                   rtol=0, atol=1e-11)
        np.testing.assert_allclose(complex(ov), complex(ov_ref), atol=1e-12)


def test_vidal_fidelities_streaming(vidal_problem):
    st, psi_i, psi_f, u = vidal_problem
    full = np.asarray(vidal.fidelities(st, psi_i, psi_f, u))
    stream = np.asarray(jax.jit(
        lambda uu: vidal.fidelities_streaming(st, psi_i, psi_f, uu))(u))
    np.testing.assert_allclose(stream, full, rtol=0, atol=1e-12)


def test_vidal_gradient_segmented(vidal_problem):
    st, psi_i, psi_f, u = vidal_problem
    g_ref, _ = vidal.gradient(st, psi_i, psi_f, u, 1e-6)
    g, _ = jax.jit(lambda uu: vidal.gradient_segmented(
        st, psi_i, psi_f, uu, 1e-6, seg=5))(u)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                               rtol=0, atol=1e-11)


def test_vidal_rollout_diagnostics(vidal_problem):
    st, psi_i, psi_f, u = vidal_problem
    sT, diag = jax.jit(lambda uu: vidal.rollout_diagnostics(
        st, psi_i, uu, psi_target=psi_f))(u)
    fid_ref = np.asarray(vidal.fidelities(st, psi_i, psi_f, u))
    np.testing.assert_allclose(np.asarray(diag["fid"]), fid_ref,
                               rtol=0, atol=1e-12)
    disc = np.asarray(diag["disc"])
    s2 = np.asarray(diag["s2"])
    assert disc.shape == (N, L - 1) and s2.shape == (N, L - 1)
    assert (disc[0] == 0).all()            # no step produced psi_0
    assert (disc >= 0).all() and disc.max() < 1e-3   # near-exact regime
    assert np.isfinite(s2).all() and (s2 >= -1e-9).all()
    # final state of the diagnostics scan == plain rollout final state
    psiT = vidal.rollout_final(st, psi_i, u)
    np.testing.assert_allclose(np.asarray(sT.B), np.asarray(psiT.B),
                               atol=1e-12)


def test_vidal_bond_renyi2_vs_exact(vidal_problem):
    """S2 from the Schmidt carrier vs S2 from the exact Schmidt values:
    for the vector carrier they are the same formula; check the matrix
    carrier agrees after to_matrix_carriers."""
    st, psi_i, _, u = vidal_problem
    s2_vec = np.asarray(vidal.bond_renyi2(psi_i))
    s2_mat = np.asarray(vidal.bond_renyi2(
        vidal.to_matrix_carriers(psi_i)))
    np.testing.assert_allclose(s2_mat, s2_vec, atol=1e-6)
    # against exact statevector Schmidt spectrum of the first bond
    lam = vidal.schmidt_values(psi_i)[0]
    w = lam * lam
    w = w / w.sum()
    s2_exact = -np.log(np.sum(w * w))
    np.testing.assert_allclose(s2_vec[0], s2_exact, atol=1e-8)
