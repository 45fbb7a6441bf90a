"""Call-order / consistency tests — the functional analogue of the
reference's SequencingTest (/root/reference/tests/SequencingTests.cpp).

The reference's `new_control` memoization protocol (cost/grad/Hess share
cached psi_t/xi_t keyed by a staleness flag) does not exist here: the
engine is pure, so the guarantees to test become (a) any call order yields
bit-identical results, (b) values derived from shared aux equal cold
recomputation, (c) jit caching never leaks state between different
controls. Fixture scale mirrors the reference (L=3, d=3, T=0.5,
SequencingTests.cpp:23-49).
"""

import numpy as np
import pytest
import jax.numpy as jnp

from optimalcontrolmps import engine, groundstate, tebd
from optimalcontrolmps import control as controllib
from optimalcontrolmps import seeds
from optimalcontrolmps.problem import OptimalControlProblem

L, D, NPART = 3, 3, 3
T, TSTEP = 0.5, 1e-2
N = int(T / TSTEP + 1)
M = 4
CHI = 16


@pytest.fixture(scope="module")
def oc():
    st = tebd.make_stepper(L, D, 1.0, TSTEP, CHI)
    psi_i = groundstate.initialize_state(L, D, NPART, 1.0, 2.0, CHI)
    psi_f = groundstate.initialize_state(L, D, NPART, 1.0, 50.0, CHI)
    basis = controllib.chopped_sine_basis(
        seeds.linspace(2.0, 50.0, N), TSTEP, T, M)
    return OptimalControlProblem(psi_f, psi_i, st, basis=basis, gamma=1e-4)


def test_all_call_orders_identical(oc):
    """All 6 orderings of {cost, grad, hess} must agree bitwise
    (SequencingTests.cpp:116-198)."""
    c = jnp.asarray(np.linspace(-0.3, 0.4, M))
    import itertools
    ref = None
    for order in itertools.permutations(["cost", "grad", "hess"]):
        out = {}
        for what in order:
            if what == "cost":
                out["cost"] = float(oc.get_cost(c))
            elif what == "grad":
                out["grad"] = np.asarray(oc.get_analytic_gradient(c))
            else:
                out["hess"] = np.asarray(oc.get_hessian(c))
        if ref is None:
            ref = out
        else:
            assert out["cost"] == ref["cost"]
            np.testing.assert_array_equal(out["grad"], ref["grad"])
            np.testing.assert_array_equal(out["hess"], ref["hess"])


def test_new_control_changes_results(oc):
    """Different controls must give different values
    (SequencingTests.cpp:200-236); interleaving controls must not leak
    state (the stale-read semantics of the reference cannot happen)."""
    c1 = jnp.asarray(np.linspace(-0.3, 0.4, M))
    c2 = c1 + 0.25
    v1a = float(oc.get_cost(c1))
    v2 = float(oc.get_cost(c2))
    v1b = float(oc.get_cost(c1))
    assert v1a == v1b
    assert v1a != v2


def test_aux_reuse_is_exact(oc):
    """Hessian from gradient-aux == cold Hessian (the memoization identity
    the reference tests through its flag protocol)."""
    st = oc.stepper
    c = jnp.asarray(np.linspace(-0.1, 0.2, M))
    u = oc.basis.convert_control(c)
    _, aux = engine.gradient(st, oc.psi_init, oc.psi_target, u, 0.0)
    H1 = np.asarray(engine.hessian(st, oc.psi_init, oc.psi_target, u, 0.0,
                                   aux=aux))
    H2 = np.asarray(engine.hessian(st, oc.psi_init, oc.psi_target, u, 0.0))
    np.testing.assert_allclose(H1, H2, atol=1e-13)


def test_bfgs_mode_consistency(oc):
    """BFGS (lowmem) and exact modes agree on cost and gradient
    (SequencingTests.cpp:126-133)."""
    c = jnp.asarray(np.linspace(-0.2, 0.3, M))
    oc_b = OptimalControlProblem(oc.psi_target, oc.psi_init, oc.stepper,
                                 basis=oc.basis, gamma=1e-4, bfgs=True)
    assert abs(float(oc.get_cost(c)) - float(oc_b.get_cost(c))) < 1e-13
    np.testing.assert_allclose(np.asarray(oc.get_analytic_gradient(c)),
                               np.asarray(oc_b.get_analytic_gradient(c)),
                               atol=1e-11)
