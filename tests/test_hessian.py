"""Exact-Hessian tests, ported from the reference's HessianTests
(/root/reference/tests/HessianTests.cpp): numeric differentiation of the
analytic gradient vs the analytic Hessian, GRAPE and GROUP. The reference
checks the interior GRAPE block at 5e-3 relative (HessianTests.cpp:178-184)
and isolates the regularization Hessian by subtraction (197-205).

FD stencils run as ONE vmapped batch of gradient evaluations.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from optimalcontrolmps import groundstate, tebd, engine
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


@pytest.fixture(scope="module")
def pieces():
    # trunc_method="svd": the default eigh/denmat truncation squares the
    # condition of tiny Schmidt values (error ~sqrt(eps) ~ 1e-8 absolute),
    # which is invisible in cost/gradient but shows against an FD check of
    # the *second* derivative at these near-converged magnitudes (~4e-6).
    # ITensor's denmatDecomp has the same property — the reference masks it
    # with a noisier eps=1e-3 forward-difference-of-cost check and a
    # documented "~4 entries may fail" caveat (README.md:21).
    st = tebd.make_stepper(L, D, J, TSTEP, CHI, trunc_method="svd")
    psi_i = groundstate.initialize_state(L, D, NPART, J, CSTART, CHI)
    psi_f = groundstate.initialize_state(L, D, NPART, J, CEND, CHI)
    u0 = seeds.linspace(CSTART, CEND, N)
    basis = controllib.chopped_sine_basis(u0, TSTEP, T, M)

    grad_u = lambda u: engine.gradient(st, psi_i, psi_f, u, 0.0)[0]
    grad_c = lambda c: basis.convert_gradient(
        grad_u(basis.convert_control(c)))
    fns = {
        "grad_u_batch": jax.jit(jax.vmap(grad_u)),
        "grad_c_batch": jax.jit(jax.vmap(grad_c)),
        "hess_u": jax.jit(
            lambda u: engine.hessian(st, psi_i, psi_f, u, 0.0)),
    }
    return st, psi_i, psi_f, basis, fns


def numeric_hessian(grad_batch, x, eps=1e-5):
    """Central difference of the analytic gradient, one vmapped call."""
    n = x.shape[0]
    eye = jnp.eye(n, dtype=x.dtype)
    xs = jnp.concatenate([x[None] + eps * eye, x[None] - eps * eye])
    g = np.asarray(grad_batch(xs))       # (2n, n)
    return (g[:n] - g[n:]).T / (2 * eps)


@pytest.mark.smoke
def test_grape_hessian(pieces):
    """HessianTests.cpp:165-205 (GRAPE interior block)."""
    st, psi_i, psi_f, basis, fns = pieces
    rng = np.random.default_rng(2)
    u = jnp.asarray(seeds.linspace(CSTART, CEND, N)
                    + rng.uniform(-0.5, 0.5, N))
    H = np.asarray(fns["hess_u"](u))
    Hn = numeric_hessian(fns["grad_u_batch"], u)
    np.testing.assert_allclose(H, H.T, atol=1e-12)
    a, b = H[1:-1, 1:-1], Hn[1:-1, 1:-1]
    scale = np.abs(b).max()
    assert np.abs(a - b).max() / scale < 5e-3, np.abs(a - b).max() / scale
    # edges exactly zero for gamma=0 (OptimalControl.cpp:267,341)
    assert np.abs(H[0, :]).max() == 0.0 and np.abs(H[-1, :]).max() == 0.0


def test_group_hessian(pieces):
    """HessianTests.cpp:208-250 (GROUP congruence H_c = B^T H_u B)."""
    st, psi_i, psi_f, basis, fns = pieces
    rng = np.random.default_rng(4)
    c = jnp.asarray(rng.uniform(-0.5, 0.5, M))
    u = basis.convert_control(c)
    H = np.asarray(basis.convert_hessian(fns["hess_u"](u)))
    Hn = numeric_hessian(fns["grad_c_batch"], c)
    np.testing.assert_allclose(H, H.T, atol=1e-12)
    scale = np.abs(Hn).max()
    assert np.abs(H - Hn).max() / scale < 5e-3, np.abs(H - Hn).max() / scale


def test_regularization_hessian():
    """Pure-function check of the tridiagonal/zero-edge structure
    (OptimalControl.cpp:125-143; HessianTests.cpp:197-205 isolates it the
    same way)."""
    Hreg = np.asarray(engine.regularization_hessian(N, 1.0, TSTEP))
    g = 1.0 / TSTEP
    assert Hreg[0].sum() == 0.0 and Hreg[-1].sum() == 0.0
    np.testing.assert_allclose(np.diag(Hreg)[1:-1], 2 * g)
    np.testing.assert_allclose(Hreg[2, 3], -g)
    assert Hreg[1, 0] == 0.0 and Hreg[N - 2, N - 1] == 0.0
    np.testing.assert_allclose(Hreg, Hreg.T)


def test_hessian_reuses_gradient_aux(pieces):
    """hessian(aux=...) from a gradient call equals a cold hessian.

    Runs at a REDUCED horizon (N=6 controls on the same stepper): the
    property under test is aux plumbing, not physics, and the exact
    Hessian costs N_t^2/2 row-propagations per variant (this was the
    single slowest test in the suite at the full fixture horizon)."""
    st, psi_i, psi_f, basis, fns = pieces
    u = jnp.asarray(seeds.linspace(CSTART, CEND, 6))

    def both(uu):
        _, aux = engine.gradient(st, psi_i, psi_f, uu, 0.0)
        H1 = engine.hessian(st, psi_i, psi_f, uu, 0.0, aux=aux)
        H2 = engine.hessian(st, psi_i, psi_f, uu, 0.0)
        return H1, H2

    H1, H2 = jax.jit(both)(u)
    np.testing.assert_allclose(np.asarray(H1), np.asarray(H2),
                               atol=1e-12)


def test_eigh_and_svd_truncation_agree(pieces):
    """The fast eigh/denmat path must agree with the SVD path to the
    sqrt(eps) level its squared conditioning implies. Reduced horizon
    (N=6) — the property is truncation-path equivalence, which every
    bond update exercises identically."""
    _, psi_i, psi_f, basis, fns = pieces
    st_e = tebd.make_stepper(L, D, J, TSTEP, CHI, trunc_method="eigh")
    u = jnp.asarray(seeds.linspace(CSTART, CEND, 6))
    st_s = pieces[0]
    c_e = float(engine.cost(st_e, psi_i, psi_f, u, 0.0))
    c_s = float(engine.cost(st_s, psi_i, psi_f, u, 0.0))
    np.testing.assert_allclose(c_e, c_s, atol=1e-9)
    H_e = np.asarray(jax.jit(
        lambda uu: engine.hessian(st_e, psi_i, psi_f, uu, 0.0))(u))
    H_s = np.asarray(jax.jit(
        lambda uu: engine.hessian(st_s, psi_i, psi_f, uu, 0.0))(u))
    np.testing.assert_allclose(H_e, H_s, atol=1e-6)
