"""Observables (C11 rebuild) against exact dense computations, plus
config-parser and result-file round-trips."""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from optimalcontrolmps import groundstate, mps, observables, io
from optimalcontrolmps.config import (parse_input_text, write_input_file,
                                      parse_input_file)
from optimalcontrolmps.sites import op

L, D, NPART = 5, 4, 5
CHI = 30


@pytest.fixture(scope="module")
def state():
    vec = groundstate.ground_statevector(L, D, NPART, 1.0, 3.0)
    A = mps.from_statevector(vec, L, D + 1, CHI)
    return jnp.asarray(A), vec


def dense_op_at(o, i):
    p = D + 1
    out = np.array([[1.0]])
    for k in range(L):
        out = np.kron(out, o if k == i else np.eye(p))
    return out


def test_correlation_function_vs_dense(state):
    A, vec = state
    adag, a = op("Adag", D), op("A", D)
    for (i, j) in [(0, 3), (2, 2), (4, 1)]:
        got = complex(observables.correlation_function(A, adag, i, a, j))
        if i == j:
            dense = dense_op_at(adag @ a, i)
        else:
            dense = dense_op_at(adag, i) @ dense_op_at(a, j)
        want = np.vdot(vec, dense @ vec)
        assert abs(got - want) < 1e-9, (i, j, got, want)


def test_window_correlations_vs_pairwise(state):
    """The streaming quench measure (shared environments) must equal the
    per-pair correlation_function values it replaces."""
    A, _ = state
    a, adag, n = op("A", D), op("Adag", D), op("N", D)
    start, end = 1, L - 1
    sp, dd, rdd = observables.window_correlations(A, a, adag, n, start,
                                                  end)
    eye = np.eye(D + 1)
    exp0 = float(observables.correlation_function(A, n, start, eye,
                                                  start).real)
    for k, j in enumerate(range(start + 1, end + 1)):
        spc = float(observables.correlation_function(A, adag, start, a,
                                                     j).real)
        ddc = float(observables.correlation_function(A, n, start, n,
                                                     j).real)
        expj = float(observables.correlation_function(A, n, j, eye,
                                                      j).real)
        assert abs(float(sp[k]) - spc) < 1e-10
        assert abs(float(dd[k]) - ddc) < 1e-10
        assert abs(float(rdd[k]) - (ddc - exp0 * expj)) < 1e-10


def test_correlation_matrix_hermitian_and_diag(state):
    A, vec = state
    adag, a = op("Adag", D), op("A", D)
    C = np.asarray(observables.correlation_matrix(A, adag, a))
    assert np.abs(C - C.conj().T).max() < 1e-9
    # diagonal = <n_i>
    n = np.asarray(mps.expectation_values(A, op("N", D))).real
    np.testing.assert_allclose(np.diag(C).real, n, atol=1e-9)
    # trace = Npart
    assert abs(np.trace(C).real - NPART) < 1e-8


def test_condensate_fraction(state):
    """Superfluid-ish ground state at U=3: condensate eigenvalue between 1
    (Mott) and Npart (ideal BEC); Mott product state gives exactly 1
    (reference SiteSetTests:173-180)."""
    A, _ = state
    lam = float(observables.condensate_fraction(A, op("Adag", D),
                                                op("A", D)))
    assert 1.0 < lam < NPART
    mott = jnp.asarray(mps.product_state([1] * L, D + 1, CHI))
    lam_mott = float(observables.condensate_fraction(mott, op("Adag", D),
                                                     op("A", D)))
    assert abs(lam_mott - 1.0) < 1e-9


def test_entanglement_entropy(state):
    A, vec = state
    S = np.asarray(observables.entanglement_entropies(A))
    assert S.shape == (L - 1,)
    # exact entropy of the first bond from the dense state
    p = D + 1
    rho = vec.reshape(p, -1)
    s = np.linalg.svd(rho, compute_uv=False) ** 2
    s = s[s > 1e-12]
    S0 = float(-(s * np.log(s)).sum())
    assert abs(S[0] - S0) < 1e-8
    # product state has zero entropy
    mott = jnp.asarray(mps.product_state([1] * L, D + 1, CHI))
    Sm = np.asarray(observables.entanglement_entropies(mott))
    assert np.abs(Sm).max() < 1e-10


def test_defect_metrics(state):
    A, _ = state
    rho = float(observables.mean_density_deviation(A, op("N", D)))
    assert 0.0 <= rho < 1.0
    f2 = float(observables.number_fluctuation(A, op("N", D), op("NN", D)))
    assert f2 > 0.0
    mott = jnp.asarray(mps.product_state([1] * L, D + 1, CHI))
    assert float(observables.mean_density_deviation(mott, op("N", D))) < 1e-12
    assert abs(float(observables.number_fluctuation(
        mott, op("N", D), op("NN", D)))) < 1e-12


def test_config_parser(tmp_path):
    text = """
    input
    {
    tstep = 0.01
    T = 2.0
    N = 5
    cacheProgress = no
    useBFGS = yes
    name = hello
    }
    """
    g = parse_input_text(text)
    assert g.get_real("tstep") == 0.01
    assert g.get_int("N") == 5
    assert g.get_yesno("cacheProgress") is False
    assert g.get_yesno("useBFGS") is True
    assert g.get_string("name") == "hello"
    assert g.get_int("missing", 7) == 7
    with pytest.raises(KeyError):
        g.get_real("nope")

    # round-trip through writer (README.md:28-45 format)
    path = str(tmp_path / "InputFile")
    write_input_file(path, {"tstep": 0.01, "T": 2.0, "cacheProgress": False})
    g2 = parse_input_file(path)
    assert g2.get_real("T") == 2.0
    assert g2.get_yesno("cacheProgress") is False


def test_ramp_file_roundtrip(tmp_path):
    path = str(tmp_path / "BHrampInitialFinal.txt")
    t = np.linspace(0, 2, 11)
    io.write_ramp_file(path, t, t + 1, t * 0.1, t + 2, t * 0.2)
    back = io.read_ramp_file(path)
    np.testing.assert_allclose(back["times"], t, atol=1e-9)
    np.testing.assert_allclose(back["u_final"], t + 2, atol=1e-9)

    ck = str(tmp_path / "ck.json")
    io.save_checkpoint(ck, t, extra={"cost": 0.5})
    c, ex = io.load_checkpoint(ck)
    np.testing.assert_allclose(c, t)
    assert ex["cost"] == 0.5


def test_nprop_accounting():
    """src/BH_nlp.cpp:311-317."""
    assert io.nprop_per_iteration(201, ls_trials=0, exact_hessian=False) == 402
    assert io.nprop_per_iteration(201, ls_trials=3, exact_hessian=False) \
        == 201 * 5
    assert io.nprop_per_iteration(201, 0, True) == 402 + 201 * 200 // 2


def test_state_serialization_roundtrip(tmp_path):
    """save_states/load_states round-trip for all three engine state
    layouts + fingerprint mismatch rejection (the reference round-trips
    site sets/MPS via BH_sites::read, include/BH_sites.h:39-53)."""
    from optimalcontrolmps import groundstate, sector, vidal
    meta = {"L": 3, "d": 2, "npart": 3, "chi": 4, "engine": "mps",
            "u": [2.5, 50.0]}

    # plain MPS
    a = groundstate.initialize_state(3, 2, 3, 1.0, 2.5, 4)
    b = groundstate.initialize_state(3, 2, 3, 1.0, 50.0, 4)
    path = str(tmp_path / "states_mps.npz")
    io.save_states(path, a, b, meta)
    out = io.load_states(path, meta)
    assert out is not None
    assert np.allclose(out[0], np.asarray(a))
    assert np.allclose(out[1], np.asarray(b))
    # fingerprint mismatch -> None
    assert io.load_states(path, {**meta, "chi": 5}) is None
    assert io.load_states(str(tmp_path / "absent.npz"), meta) is None

    # sector vectors
    sa = sector.sector_ground_state(3, 2, 3, 1.0, 2.5)
    sb = sector.sector_ground_state(3, 2, 3, 1.0, 50.0)
    spath = str(tmp_path / "states_sector.npz")
    io.save_states(spath, sa, sb, {**meta, "engine": "sector"})
    out = io.load_states(spath, {**meta, "engine": "sector"})
    assert np.allclose(out[0], sa) and np.allclose(out[1], sb)

    # VidalState pytrees
    va, vb = vidal.from_mps(np.asarray(a)), vidal.from_mps(np.asarray(b))
    vpath = str(tmp_path / "states_vidal.npz")
    io.save_states(vpath, va, vb, {**meta, "engine": "vidal"})
    out = io.load_states(vpath, {**meta, "engine": "vidal"})
    assert np.allclose(out[0].B, np.asarray(va.B))
    assert np.allclose(out[0].lam, np.asarray(va.lam))
    assert np.allclose(out[1].B, np.asarray(vb.B))
