"""Site-operator algebra and correlator tests, ported from the reference's
SiteSetTests (/root/reference/tests/SiteSetTests.cpp): exact assertions on
small product states."""

import numpy as np
import jax.numpy as jnp

from optimalcontrolmps import mps, observables
from optimalcontrolmps.sites import op, local_dim, n_diag, nn1_diag


D = 4
P = D + 1


def test_operator_matrices():
    n, a, adag = op("N", D), op("A", D), op("Adag", D)
    # algebra: [a, adag] = 1 on the truncated space except the top level
    comm = a @ adag - adag @ a
    np.testing.assert_allclose(np.diag(comm)[:-1], 1.0, atol=1e-12)
    # N = adag a exactly
    np.testing.assert_allclose(adag @ a, n, atol=1e-12)
    # N(N-1) and NN diagonals
    np.testing.assert_allclose(np.diag(op("N(N-1)", D)), nn1_diag(D))
    np.testing.assert_allclose(np.diag(op("NN", D)),
                               n_diag(D) ** 2, atol=1e-12)
    assert local_dim(D) == P
    # reference "Id" op quirk: matrix element at |0> is 0 in BH_sites.h
    # (loop starts at j=1) — ours is a true identity; assert ours is exact
    np.testing.assert_allclose(op("Id", D), np.eye(P))


def test_expectation_after_ladder_ops():
    """<N> on Fock states and after applying A / Adag
    (SiteSetTests.cpp:101-119)."""
    chi = 8
    psi = jnp.asarray(mps.product_state([2, 1, 0], P, chi))
    n = np.asarray(mps.expectation_values(psi, op("N", D))).real
    np.testing.assert_allclose(n, [2, 1, 0], atol=1e-12)

    # apply A at site 0: |2,1,0> -> sqrt(2)|1,1,0>
    a = jnp.asarray(op("A", D), dtype=psi.dtype)
    psi_a = psi.at[0].set(jnp.einsum('pq,aqb->apb', a, psi[0]))
    nrm = float(mps.norm(psi_a))
    assert abs(nrm - np.sqrt(2)) < 1e-12
    psi_a = mps.normalize(psi_a)
    n2 = np.asarray(mps.expectation_values(psi_a, op("N", D))).real
    np.testing.assert_allclose(n2, [1, 1, 0], atol=1e-12)


def test_product_state_correlators():
    """All two-site correlator pairs on product states
    (SiteSetTests.cpp:122-171): <Op1_i Op2_j> factorizes."""
    chi = 8
    occ = [1, 2]
    psi = jnp.asarray(mps.product_state(occ, P, chi))
    nmat = op("N", D)
    for i in range(2):
        for j in range(2):
            c = complex(observables.correlation_function(psi, nmat, i,
                                                         nmat, j))
            want = occ[i] * occ[j] if i != j else occ[i] ** 2
            assert abs(c - want) < 1e-12
    # <Adag_0 A_1> on a product Fock state is zero
    c = complex(observables.correlation_function(psi, op("Adag", D), 0,
                                                 op("A", D), 1))
    assert abs(c) < 1e-12


def test_condensate_on_mott_states():
    """Condensate eigenvalue on Mott product states across fillings and
    sizes (SiteSetTests.cpp:173-180): largest eigenvalue = filling."""
    for L in (5, 8, 12):
        for filling in (1, 2, 3, 4):
            psi = jnp.asarray(mps.product_state([filling] * L, P, 8))
            lam = float(observables.condensate_fraction(
                psi, op("Adag", D), op("A", D)))
            assert abs(lam - filling) < 1e-10, (L, filling, lam)
