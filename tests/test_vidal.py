"""Vidal-form parallel TEBD: canonical-form invariants + channel parity.

Exact-chi regime: the vidal brick step must reproduce the dense Trotter
propagator (exact.py) and the snake engine to ~1e-9 — same gate product,
no truncation. Truncating regime: the per-bond Schmidt data must stay a
faithful canonical form, and accuracy must track the snake sweep's.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from optimalcontrolmps import (control, engine, exact, groundstate, mps,
                               seeds, tebd, vidal)

L, D, NPART = 5, 4, 5
J, DT, CHI = 1.0, 0.01, 30


def _exact_schmidt(vec, L, p, bond, chi):
    """Top-chi Schmidt values of a dense state across bond `bond`."""
    m = np.asarray(vec).reshape(p ** (bond + 1), -1)
    s = np.linalg.svd(m, compute_uv=False)
    out = np.zeros(chi)
    k = min(chi, s.size)
    out[:k] = s[:k]
    return out / np.linalg.norm(out)


@pytest.fixture(scope="module")
def setup():
    st = tebd.make_stepper(L, D, J, DT, CHI, sweep="vidal")
    est = exact.make_exact_stepper(L, D, J, DT)
    vec = groundstate.ground_statevector(L, D, NPART, J, 2.0)
    A = mps.from_statevector(vec, L, D + 1, CHI)
    state = vidal.from_mps(A)
    return st, est, vec, state


def test_from_mps_roundtrip(setup):
    st, est, vec, state = setup
    v = np.asarray(mps.to_statevector(state.B))
    assert np.abs(v - np.asarray(vec)).max() < 1e-10
    # lam must be the true Schmidt spectra
    for b in range(L - 1):
        ref = _exact_schmidt(vec, L, D + 1, b, CHI)
        assert np.abs(np.sort(np.asarray(state.lam[b]))[::-1]
                      - ref).max() < 1e-10


@pytest.mark.smoke
def test_vidal_step_matches_statevector(setup):
    st, est, vec, state = setup
    u = np.linspace(2.0, 50.0, 21)
    psi = jnp.asarray(vec)
    s = state
    for i in range(20):
        s = vidal.vidal_step(st, s, u[i], u[i + 1], True)
        psi = exact.exact_step(est, psi, u[i], u[i + 1], True)
    v1 = np.asarray(mps.to_statevector(s.B))
    pv = np.asarray(psi)
    ph = np.vdot(v1, pv)
    ph = ph / abs(ph)
    assert np.abs(v1 * ph - pv).max() < 1e-9
    # canonical-form invariant: lam equals the exact Schmidt spectrum
    # (tolerance floor: ops/trunc._jitter shifts zero eigenvalues by
    # ~1e-12 * tr(rho)/m, i.e. sqrt -> ~1e-7 on the zero tail)
    for b in range(L - 1):
        ref = _exact_schmidt(pv, L, D + 1, b, CHI)
        assert np.abs(np.sort(np.asarray(s.lam[b]))[::-1]
                      - ref).max() < 1e-6


def test_vidal_backward_matches_statevector(setup):
    st, est, vec, state = setup
    u = np.linspace(50.0, 2.0, 11)
    s, q = state, jnp.asarray(vec)
    for i in range(10):
        s = vidal.vidal_step(st, s, u[i], u[i + 1], False)
        q = exact.exact_step(est, q, u[i], u[i + 1], False)
    v1 = np.asarray(mps.to_statevector(s.B))
    pv = np.asarray(q)
    ph = np.vdot(v1, pv)
    ph = ph / abs(ph)
    assert np.abs(v1 * ph - pv).max() < 1e-9


@pytest.mark.smoke
def test_vidal_gradient_matches_snake_engine(setup):
    """Exact-chi regime: the vidal engine's cost/gradient == snake engine."""
    T_ = 0.1
    N = int(round(T_ / DT)) + 1
    st_v = tebd.make_stepper(L, D, J, DT, CHI, sweep="vidal")
    st_s = tebd.make_stepper(L, D, J, DT, CHI, sweep="snake")
    psi_i = groundstate.initialize_state(L, D, NPART, J, 2.5, CHI)
    psi_f = groundstate.initialize_state(L, D, NPART, J, 50.0, CHI)
    vi, vf = vidal.from_mps(psi_i), vidal.from_mps(psi_f)
    u = jnp.asarray(seeds.adiabatic_seed(2.5, 50.0, N))
    Jv = float(vidal.cost(st_v, vi, vf, u, 1e-6))
    Js = float(engine.cost(st_s, psi_i, psi_f, u, 1e-6))
    assert abs(Jv - Js) < 1e-8
    gv, _ = vidal.gradient(st_v, vi, vf, u, 1e-6)
    gs, _ = engine.gradient(st_s, psi_i, psi_f, u, 1e-6)
    assert np.abs(np.asarray(gv) - np.asarray(gs)).max() < 1e-8
    gl, (_, _, divT, ov) = vidal.gradient_lowmem(st_v, vi, vf, u, 1e-6)
    assert np.abs(np.asarray(gl) - np.asarray(gv)).max() < 1e-10
    fv = vidal.fidelities(st_v, vi, vf, u)
    fs = engine.fidelities(st_s, psi_i, psi_f, u)
    assert np.abs(np.asarray(fv) - np.asarray(fs)).max() < 1e-8


def test_vidal_truncating_tracks_snake():
    """Real truncation (chi < exact rank bound): the vidal channel's error
    vs the dense propagator must be comparable to the snake sweep's."""
    Lt, dt_, chi_t = 6, 2, 4  # rank bound 27 >> chi
    st_v = tebd.make_stepper(Lt, dt_, J, DT, chi_t, sweep="vidal")
    st_s = tebd.make_stepper(Lt, dt_, J, DT, chi_t, sweep="snake")
    est = exact.make_exact_stepper(Lt, dt_, J, DT)
    vec = groundstate.ground_statevector(Lt, dt_, Lt, J, 2.0)
    A = mps.from_statevector(vec, Lt, dt_ + 1, chi_t)  # truncated start
    sv = vidal.from_mps(A)
    ss = A
    psi = jnp.asarray(vec)
    u = np.linspace(2.0, 12.0, 31)
    for i in range(30):
        sv = vidal.vidal_step(st_v, sv, u[i], u[i + 1], True)
        ss = tebd.tebd_step(st_s, ss, u[i], u[i + 1], True)
        psi = exact.exact_step(est, psi, u[i], u[i + 1], True)
    pv = np.asarray(psi)
    f_v = abs(np.vdot(np.asarray(mps.to_statevector(sv.B)), pv))
    f_s = abs(np.vdot(np.asarray(mps.to_statevector(ss)), pv))
    # both truncate; neither may be catastrophically worse
    assert 1.0 - f_v < 5e-3
    assert (1.0 - f_v) < 5.0 * (1.0 - f_s) + 1e-6
    # state stays normalized, Schmidt values stay unit-norm per bond
    assert abs(float(mps.norm(sv.B)) - 1.0) < 1e-10
    lam_norms = np.linalg.norm(np.asarray(sv.lam), axis=1)
    assert np.abs(lam_norms - 1.0).max() < 1e-10


def test_matfree_carriers_match_eigh(setup):
    """Matrix-carrier (matmul-only) bond updates == vector-carrier updates
    in the exact-chi regime: same states, carriers with the same spectra."""
    st, est, vec, state = setup
    sm = vidal.to_matrix_carriers(state)
    u = np.linspace(2.0, 50.0, 11)
    se = state
    for i in range(10):
        se = vidal.vidal_step(st, se, u[i], u[i + 1], True)
        sm = vidal.vidal_step(st, sm, u[i], u[i + 1], True)
    ve = np.asarray(mps.to_statevector(se.B))
    vm = np.asarray(mps.to_statevector(sm.B))
    ph = np.vdot(vm, ve)
    ph = ph / abs(ph)
    assert np.abs(vm * ph - ve).max() < 1e-7
    le = vidal.schmidt_values(se)
    lm = vidal.schmidt_values(sm)
    assert np.abs(le - lm).max() < 1e-6


def test_matfree_carriers_truncating():
    """Real truncation with matrix carriers stays accurate and normalized."""
    Lt, dt_, chi_t = 6, 2, 4
    st = tebd.make_stepper(Lt, dt_, J, DT, chi_t, sweep="vidal",
                           trunc_method="nssub")
    est = exact.make_exact_stepper(Lt, dt_, J, DT)
    vec = groundstate.ground_statevector(Lt, dt_, Lt, J, 2.0)
    A = mps.from_statevector(vec, Lt, dt_ + 1, chi_t)
    s = vidal.to_matrix_carriers(vidal.from_mps(A))
    psi = jnp.asarray(vec)
    u = np.linspace(2.0, 12.0, 31)
    for i in range(30):
        s = vidal.vidal_step(st, s, u[i], u[i + 1], True)
        psi = exact.exact_step(est, psi, u[i], u[i + 1], True)
    f = abs(np.vdot(np.asarray(mps.to_statevector(s.B)), np.asarray(psi)))
    assert 1.0 - f < 5e-3
    assert abs(float(mps.norm(s.B)) - 1.0) < 1e-9


def test_vidal_stepper_guards():
    with pytest.raises(ValueError):
        tebd.make_stepper(L, D, J, DT, CHI, sweep="vidal",
                          trunc_method="rsvd")
    st = tebd.make_stepper(L, D, J, DT, CHI, sweep="vidal")
    with pytest.raises(TypeError):
        tebd.tebd_step(st, jnp.zeros((L, CHI, D + 1, CHI),
                                     jnp.complex128), 2.0, 3.0)
    from optimalcontrolmps.backends import engine_for
    assert engine_for(st) is vidal


def test_vidal_hessian_vs_fd():
    """vidal.hessian (hybrid: vidal trajectories + snake row propagation)
    vs forward-difference Hessian of the vidal cost, at the reference's
    GRAPE interior tolerance 5e-3 (HessianTests.cpp:178-184). Run in a
    truncating regime so the truncation channel is actually exercised."""
    Lt, dt_, chi_t = 4, 2, 4          # rank bound 9 > chi=4: truncating
    T_ = 0.1
    N = int(round(T_ / DT)) + 1
    st_v = tebd.make_stepper(Lt, dt_, J, DT, chi_t, sweep="vidal")
    psi_i = groundstate.initialize_state(Lt, dt_, Lt, J, 2.5, chi_t)
    psi_f = groundstate.initialize_state(Lt, dt_, Lt, J, 50.0, chi_t)
    vi, vf = vidal.from_mps(psi_i), vidal.from_mps(psi_f)
    rng = np.random.default_rng(3)
    u = jnp.asarray(seeds.adiabatic_seed(2.5, 50.0, N)
                    + rng.uniform(-0.5, 0.5, N))
    gamma = 0.0

    H = np.asarray(vidal.hessian(st_v, vi, vf, u, gamma))
    assert np.abs(H - H.T).max() < 1e-10

    # forward-difference of the analytic gradient (the reference's method,
    # HessianTests.cpp:131-160), interior block only
    eps = 1e-3
    g0, _ = vidal.gradient(st_v, vi, vf, u, gamma)
    g0 = np.asarray(g0)
    fd = np.zeros((N, N))
    for j in range(1, N - 1):
        gj, _ = vidal.gradient(st_v, vi, vf, u.at[j].add(eps), gamma)
        fd[:, j] = (np.asarray(gj) - g0) / eps
    fd = 0.5 * (fd + fd.T)
    Hi = H[1:-1, 1:-1]
    Fi = fd[1:-1, 1:-1]
    scale = np.abs(Fi).max()
    assert np.abs(Hi - Fi).max() / scale < 5e-3


def test_vidal_hessian_matches_snake_exact_regime():
    """No truncation (chi >= rank bound): vidal.hessian == engine.hessian."""
    T_ = 0.1
    N = int(round(T_ / DT)) + 1
    st_v = tebd.make_stepper(L, D, J, DT, CHI, sweep="vidal")
    st_s = tebd.make_stepper(L, D, J, DT, CHI, sweep="snake")
    psi_i = groundstate.initialize_state(L, D, NPART, J, 2.5, CHI)
    psi_f = groundstate.initialize_state(L, D, NPART, J, 50.0, CHI)
    vi, vf = vidal.from_mps(psi_i), vidal.from_mps(psi_f)
    u = jnp.asarray(seeds.adiabatic_seed(2.5, 50.0, N))
    Hv = np.asarray(vidal.hessian(st_v, vi, vf, u, 1e-6))
    Hs = np.asarray(engine.hessian(st_s, psi_i, psi_f, u, 1e-6))
    assert np.abs(Hv - Hs).max() < 1e-6
