"""Sector-engine tests: the dense fixed-N GEMM propagator must reproduce
the reference's golden CostTests anchors, agree with the MPS engine, and
carry correct analytic derivatives (FD + autodiff cross-checks, mirroring
tests/GradientTests.cpp and tests/HessianTests.cpp of the reference).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from optimalcontrolmps import engine, groundstate, sector, seeds, tebd
from optimalcontrolmps import control as controllib

L, NPART, D = 5, 5, 5
J, CSTART, CEND = 1.0, 2.0, 50.0
T, TSTEP = 0.1, 1e-2
N = int(T / TSTEP + 1)  # 11
M = 5

FID_LINEAR = [0.214338, 0.214325, 0.215126, 0.217281, 0.221019, 0.22621,
              0.232328, 0.238484, 0.243617, 0.246862, 0.24801]


@pytest.fixture(scope="module")
def problem():
    st = sector.make_sector_stepper(L, D, NPART, J, TSTEP)
    psi_i = sector.sector_ground_state(L, D, NPART, J, CSTART)
    psi_f = sector.sector_ground_state(L, D, NPART, J, CEND)
    return st, jnp.asarray(psi_i), jnp.asarray(psi_f)


def test_step_unitary(problem):
    st, psi_i, _ = problem
    out = sector.sector_step(st, psi_i, 3.0, 7.0, True)
    assert abs(float(jnp.linalg.norm(out)) - 1.0) < 1e-12
    # backward step inverts the forward step up to the even/odd Trotter
    # commutator (the backward sweep applies even-then-odd like forward,
    # exactly as the reference does, src/BH_tDMRG.cpp:117-124 — the exact
    # adjoint would need odd-then-even)
    back = sector.sector_step(st, out, 7.0, 3.0, False)
    assert abs(complex(jnp.vdot(back, psi_i))) > 1.0 - 1e-6


@pytest.mark.smoke
def test_golden_fidelities(problem):
    """CostTests.cpp:68-98 anchors via the sector engine."""
    st, psi_i, psi_f = problem
    u = jnp.asarray(seeds.linspace(CSTART, CEND, N))
    c = float(sector.cost(st, psi_i, psi_f, u, 0.0))
    fid = np.asarray(sector.fidelities(st, psi_i, psi_f, u))
    np.testing.assert_allclose(c, 0.375995, atol=1e-5)
    np.testing.assert_allclose(fid[:-1], FID_LINEAR[:-1], atol=1e-5)


def test_matches_mps_engine(problem):
    """Sector and MPS engines implement the same Trotter channel: cost and
    gradient must agree to truncation error."""
    st_s, psi_i, psi_f = problem
    chi = 40
    st_m = tebd.make_stepper(L, D, J, TSTEP, chi)
    A_i = groundstate.initialize_state(L, D, NPART, J, CSTART, chi)
    A_f = groundstate.initialize_state(L, D, NPART, J, CEND, chi)
    u = jnp.asarray(seeds.linspace(CSTART, CEND, N))

    c_s = float(sector.cost(st_s, psi_i, psi_f, u, 1e-6))
    c_m = float(engine.cost(st_m, A_i, A_f, u, 1e-6))
    assert abs(c_s - c_m) < 1e-8

    g_s, _ = sector.gradient(st_s, psi_i, psi_f, u, 1e-6)
    g_m, _ = engine.gradient(st_m, A_i, A_f, u, 1e-6)
    np.testing.assert_allclose(np.asarray(g_s), np.asarray(g_m),
                               atol=1e-8, rtol=1e-6)


@pytest.mark.smoke
def test_gradient_vs_fd(problem):
    """Numeric-vs-analytic (GradientTests.cpp style), plus jax.grad of the
    rollout as an independent autodiff cross-check."""
    st, psi_i, psi_f = problem
    rng = np.random.default_rng(7)
    u = jnp.asarray(seeds.linspace(CSTART, CEND, N)
                    + rng.uniform(-0.5, 0.5, N))
    gamma = 1e-4
    g, _ = sector.gradient(st, psi_i, psi_f, u, gamma)
    g = np.asarray(g)

    costj = jax.jit(lambda uu: sector.cost(st, psi_i, psi_f, uu, gamma))
    eps = 1e-6
    fd = np.zeros(N)
    for k in range(N):
        e = np.zeros(N)
        e[k] = eps
        fd[k] = (float(costj(u + e)) - float(costj(u - e))) / (2 * eps)
    # endpoints excluded, as in the reference's loops (1..size-2)
    np.testing.assert_allclose(g[1:-1], fd[1:-1], rtol=2e-5, atol=1e-10)

    g_ad = np.asarray(jax.grad(lambda uu: sector.cost(
        st, psi_i, psi_f, uu, gamma))(u))
    np.testing.assert_allclose(g[1:-1], g_ad[1:-1], rtol=1e-6, atol=1e-12)


def test_hessian_vs_fd(problem):
    """Forward-difference Hessian check on the interior block
    (HessianTests.cpp:131-184 style)."""
    st, psi_i, psi_f = problem
    u = jnp.asarray(seeds.linspace(CSTART, CEND, N))
    gamma = 1e-3
    H = np.asarray(sector.hessian(st, psi_i, psi_f, u, gamma))
    assert H.shape == (N, N)
    np.testing.assert_allclose(H, H.T, atol=1e-12)

    gradj = jax.jit(lambda uu: sector.gradient(st, psi_i, psi_f, uu,
                                               gamma)[0])
    eps = 1e-5
    Hfd = np.zeros((N, N))
    for k in range(N):
        e = np.zeros(N)
        e[k] = eps
        Hfd[:, k] = (np.asarray(gradj(u + e)) -
                     np.asarray(gradj(u - e))) / (2 * eps)
    np.testing.assert_allclose(H[1:-1, 1:-1], Hfd[1:-1, 1:-1],
                               rtol=5e-3, atol=1e-7)


def test_group_pullback(problem):
    """GROUP-mode gradient through the sector engine equals J^T g."""
    st, psi_i, psi_f = problem
    basis = controllib.chopped_sine_basis(
        seeds.linspace(CSTART, CEND, N), TSTEP, T, M)
    c = jnp.asarray(seeds.linspace(0.0, 7.0, M))
    u = basis.convert_control(c)
    g_u, _ = sector.gradient(st, psi_i, psi_f, u, 0.0)
    g_c = np.asarray(basis.convert_gradient(g_u))

    cost_c = jax.jit(lambda cc: sector.cost(
        st, psi_i, psi_f, basis.convert_control(cc), 0.0))
    g_ad = np.asarray(jax.grad(cost_c)(c))
    # adjoint vs autodiff differ at O(dt^2) Trotter-commutator terms
    np.testing.assert_allclose(g_c, g_ad, rtol=1e-4, atol=1e-8)


def test_gradient_lowmem_matches(problem):
    """BFGS-mode single-backward-pass gradient == full adjoint gradient
    (the reference's useBFGS path, OptimalControl.cpp:216-229)."""
    st, psi_i, psi_f = problem
    u = jnp.asarray(seeds.linspace(CSTART, CEND, N))
    g_full, (_, _, divT_f, ov_f) = sector.gradient(st, psi_i, psi_f, u, 1e-4)
    g_low, (_, _, divT_l, ov_l) = sector.gradient_lowmem(st, psi_i, psi_f,
                                                         u, 1e-4)
    np.testing.assert_allclose(np.asarray(g_full), np.asarray(g_low),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(divT_f), np.asarray(divT_l),
                               atol=1e-12)
    assert abs(complex(ov_f) - complex(ov_l)) < 1e-12


def test_batched_vmap(problem):
    """Multistart batching: vmapped cost+grad equals per-ramp loop."""
    st, psi_i, psi_f = problem
    rng = np.random.default_rng(3)
    us = jnp.asarray(seeds.linspace(CSTART, CEND, N)[None, :]
                     + rng.uniform(-1, 1, (4, N)))
    f = jax.jit(jax.vmap(lambda uu: sector.cost_and_gradient(
        st, psi_i, psi_f, uu, 1e-6)[:2]))
    Jb, Gb = f(us)
    for k in range(4):
        Jk, gk, _ = sector.cost_and_gradient(st, psi_i, psi_f, us[k], 1e-6)
        assert abs(float(Jk) - float(Jb[k])) < 1e-12
        np.testing.assert_allclose(np.asarray(gk), np.asarray(Gb[k]),
                                   atol=1e-12)
