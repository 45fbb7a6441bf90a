"""TEBD propagator anchors at machine precision.

Stronger than the ported golden vectors (which carry the reference DMRG's
own 1e-5 convergence error): the dense statevector propagator in exact.py
applies the identical Trotter product with no truncation, so in the
exact-chi regime the MPS path must agree to ~1e-10.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from functools import partial

from optimalcontrolmps import tebd, exact, mps, groundstate


L, D, NPART = 5, 4, 5
J, DT, CHI = 1.0, 0.01, 30


@pytest.fixture(scope="module")
def setup():
    st = tebd.make_stepper(L, D, J, DT, CHI)
    est = exact.make_exact_stepper(L, D, J, DT)
    vec = groundstate.ground_statevector(L, D, NPART, J, 2.0)
    A = mps.from_statevector(vec, L, D + 1, CHI)
    return st, est, vec, A


@pytest.mark.smoke
def test_tebd_matches_statevector(setup):
    st, est, vec, A = setup
    u = np.linspace(2.0, 50.0, 21)
    step_m = jax.jit(partial(tebd.tebd_step, st), static_argnames='forward')
    step_e = jax.jit(partial(exact.exact_step, est), static_argnames='forward')
    psi = jnp.asarray(vec)
    for i in range(20):
        A = step_m(A, u[i], u[i + 1])
        psi = step_e(psi, u[i], u[i + 1])
    v1 = np.asarray(mps.to_statevector(A))
    pv = np.asarray(psi)
    ph = np.vdot(v1, pv)
    ph = ph / abs(ph)
    assert np.abs(v1 * ph - pv).max() < 1e-9


def test_backward_matches_statevector(setup):
    """Backward MPS sweep == backward dense sweep at machine precision.

    Note: backward is the reference's convention (same even-then-odd gate
    order with negated dt and controls, src/BH_tDMRG.cpp:117-124), which is
    NOT the exact inverse of the forward step — they differ at
    O(dt^2 [H_even, H_odd]) per step. We check both paths implement the
    same convention, and that fwd+bwd recovers the state to Trotter order.
    """
    st, est, vec, A = setup
    psi = jnp.asarray(vec)
    u = np.linspace(50.0, 2.0, 11)
    B, q = A, psi
    for i in range(10):
        B = tebd.tebd_step(st, B, u[i], u[i + 1], False)
        q = exact.exact_step(est, q, u[i], u[i + 1], False)
    v1 = np.asarray(mps.to_statevector(B))
    pv = np.asarray(q)
    ph = np.vdot(v1, pv)
    ph = ph / abs(ph)
    assert np.abs(v1 * ph - pv).max() < 1e-9

    # fwd then bwd recovers the state to the even/odd commutator error
    C = tebd.tebd_step(st, A, 3.0, 7.0, True)
    C2 = tebd.tebd_step(st, C, 7.0, 3.0, False)
    assert abs(abs(complex(mps.overlap(C2, A))) - 1.0) < 1e-6


def test_norm_preserved(setup):
    st, _, _, A = setup
    B = tebd.tebd_step(st, A, 2.0, 50.0, True)
    assert abs(float(mps.norm(B)) - 1.0) < 1e-12


def test_particle_number_conserved(setup):
    st, _, _, A = setup
    from optimalcontrolmps.sites import op
    nmat = op("N", D)
    B = A
    for i in range(5):
        B = tebd.tebd_step(st, B, 2.0 + i, 3.0 + i, True)
    total_n = float(jnp.sum(mps.expectation_values(B, nmat)).real)
    assert abs(total_n - NPART) < 1e-8


def test_even_chain_length():
    """L=4 exercises the even-N lonely-U-gate path (BH_tDMRG.cpp:156-159)."""
    L4 = 4
    st = tebd.make_stepper(L4, D, J, DT, 30)
    est = exact.make_exact_stepper(L4, D, J, DT)
    vec = groundstate.ground_statevector(L4, D, 4, J, 2.5)
    A = mps.from_statevector(vec, L4, D + 1, 30)
    psi = jnp.asarray(vec)
    u = np.linspace(2.5, 30.0, 11)
    for i in range(10):
        A = tebd.tebd_step(st, A, u[i], u[i + 1], True)
        psi = exact.exact_step(est, psi, u[i], u[i + 1], True)
    v1 = np.asarray(mps.to_statevector(A))
    pv = np.asarray(psi)
    ph = np.vdot(v1, pv)
    ph = ph / abs(ph)
    assert np.abs(v1 * ph - pv).max() < 1e-9


def test_three_site_chain():
    L3 = 3
    st = tebd.make_stepper(L3, D, J, DT, 25)
    est = exact.make_exact_stepper(L3, D, J, DT)
    vec = groundstate.ground_statevector(L3, D, 3, J, 2.5)
    A = mps.from_statevector(vec, L3, D + 1, 25)
    psi = jnp.asarray(vec)
    for i in range(10):
        A = tebd.tebd_step(st, A, 2.5 + i, 3.5 + i, True)
        psi = exact.exact_step(est, psi, 2.5 + i, 3.5 + i, True)
    v1 = np.asarray(mps.to_statevector(A))
    pv = np.asarray(psi)
    ph = np.vdot(v1, pv)
    ph = ph / abs(ph)
    assert np.abs(v1 * ph - pv).max() < 1e-9


def test_two_site_chain():
    L2 = 2
    st = tebd.make_stepper(L2, D, J, DT, 10)
    est = exact.make_exact_stepper(L2, D, J, DT)
    vec = groundstate.ground_statevector(L2, D, 2, J, 2.5)
    A = mps.from_statevector(vec, L2, D + 1, 10)
    psi = jnp.asarray(vec)
    for i in range(10):
        A = tebd.tebd_step(st, A, 2.5 + i, 3.5 + i, True)
        psi = exact.exact_step(est, psi, 2.5 + i, 3.5 + i, True)
    v1 = np.asarray(mps.to_statevector(A))
    pv = np.asarray(psi)
    ph = np.vdot(v1, pv)
    ph = ph / abs(ph)
    assert np.abs(v1 * ph - pv).max() < 1e-9


def test_apply_site_sum_diag(setup):
    """dH/du application (MPO bond-2 contraction + compress) vs dense."""
    st, est, vec, A = setup
    from optimalcontrolmps.sites import nn1_diag
    C, nrm = mps.apply_site_sum_diag(A, 0.5 * nn1_diag(D))
    dense_op = np.asarray(exact.statevector_nn1_total(L, D)) * 0.5
    vC = np.asarray(mps.to_statevector(C)) * float(nrm)
    assert np.abs(vC - dense_op * vec).max() < 1e-9


def test_sandwich_site_sum(setup):
    st, est, vec, A = setup
    from optimalcontrolmps.sites import nn1_diag
    B = tebd.tebd_step(st, A, 2.0, 11.0, True)
    sv = complex(mps.sandwich_site_sum(B, A, 0.5 * nn1_diag(D)))
    dense_op = np.asarray(exact.statevector_nn1_total(L, D)) * 0.5
    vB = np.asarray(mps.to_statevector(B))
    want = np.vdot(vB, dense_op * vec)
    assert abs(sv - want) < 1e-9


def test_rsvd_truncation(setup):
    """Randomized-subspace truncation (ops/trunc.py "rsvd"): exact in the
    exact-rank regime and svd-quality when truncating."""
    st_r = tebd.make_stepper(L, D, J, DT, CHI, trunc_method="rsvd")
    st_e = tebd.make_stepper(L, D, J, DT, CHI, trunc_method="eigh")
    _, _, vec, A = setup
    u = np.linspace(2.0, 50.0, 11)
    Br, Be = jnp.asarray(A), jnp.asarray(A)
    for i in range(10):
        Br = tebd.tebd_step(st_r, Br, u[i], u[i + 1], True)
        Be = tebd.tebd_step(st_e, Be, u[i], u[i + 1], True)
    ov = abs(complex(mps.overlap(Br, Be)))
    assert abs(ov - 1.0) < 1e-9


def test_brick_sweep_matches_snake(setup):
    """Brick-parallel sweep (disjoint-bond gates vmapped, range-projection
    splits, no gauge moves) == reference-faithful snake sweep in the
    no-truncation regime (chi >= exact rank bound)."""
    chi = tebd.exact_rank_bound(L, D + 1)  # 25 for L=5, p=5
    st_s = tebd.make_stepper(L, D, J, DT, chi, trunc_method="eigh")
    st_b = tebd.make_stepper(L, D, J, DT, chi, trunc_method="range",
                             sweep="brick")
    _, _, vec, _ = setup
    A0 = mps.from_statevector(vec, L, D + 1, chi)
    u = np.linspace(2.0, 50.0, 11)
    Bs, Bb = jnp.asarray(A0), jnp.asarray(A0)
    for i in range(10):
        Bs = tebd.tebd_step(st_s, Bs, u[i], u[i + 1], True)
        Bb = tebd.tebd_step(st_b, Bb, u[i], u[i + 1], True)
    ov = abs(complex(mps.overlap(Bb, Bs)))
    assert abs(ov - 1.0) < 1e-9
    # backward too (co-state convention)
    Bs = tebd.tebd_step(st_s, Bs, u[5], u[4], False)
    Bb = tebd.tebd_step(st_b, Bb, u[5], u[4], False)
    ov = abs(complex(mps.overlap(Bb, Bs)))
    assert abs(ov - 1.0) < 1e-9


def test_brick_guard():
    """brick mode refuses chi below the exact rank bound."""
    with pytest.raises(ValueError):
        tebd.make_stepper(L, D, J, DT, 10, trunc_method="range",
                          sweep="brick")


def test_range_trunc_guarded_for_all_sweeps():
    """'range' is an unordered range projection — only exact when chi >=
    the physical rank bound; make_stepper must reject it for EVERY sweep
    when truncation is real (ADVICE.md round 1)."""
    import pytest
    from optimalcontrolmps import tebd

    # L=4, d=2 -> p=3, bound = min(3^2, 3^2) = 9; chi=4 truncates
    with pytest.raises(ValueError, match="range"):
        tebd.make_stepper(4, 2, 1.0, 0.01, chi=4, trunc_method="range",
                          sweep="snake")
    # exact-rank regime is fine
    tebd.make_stepper(4, 2, 1.0, 0.01, chi=9, trunc_method="range",
                      sweep="snake")


def test_precision_policy_per_call(monkeypatch):
    """The matmul-precision policy is resolved per call: env-var changes
    after import and set_policy() both take effect (ADVICE.md round 1)."""
    from optimalcontrolmps.ops import precision

    monkeypatch.delenv("OCMPS_MATMUL_PRECISION", raising=False)
    precision.set_policy(None)
    assert precision.get_policy() == "highest"
    monkeypatch.setenv("OCMPS_MATMUL_PRECISION", "default")
    assert precision.get_policy() == "default"
    precision.set_policy("high")
    assert precision.get_policy() == "high"
    precision.set_policy(None)
    assert precision.get_policy() == "default"

    seen = {}

    @precision.enforce_matmul_precision
    def probe():
        import jax
        seen["prec"] = jax.config.jax_default_matmul_precision
        return 0

    precision.set_policy("highest")
    probe()
    assert str(seen["prec"]) == "highest"
    precision.set_policy(None)
