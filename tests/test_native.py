"""Native C++ host kernels vs the pure-Python fallbacks."""

import numpy as np
import pytest

from optimalcontrolmps import native, groundstate


pytestmark = pytest.mark.skipif(native.load() is None,
                                reason="native lib not built")


def _python_sector_basis(L, d, npart):
    states = []

    def rec(prefix, remaining, sites_left):
        if sites_left == 0:
            if remaining == 0:
                states.append(tuple(prefix))
            return
        lo = max(0, remaining - d * (sites_left - 1))
        hi = min(d, remaining)
        for n in range(lo, hi + 1):
            rec(prefix + [n], remaining - n, sites_left - 1)

    rec([], npart, L)
    return np.array(states, dtype=np.int64)


def test_sector_enumeration_matches_python():
    for (L, d, npart) in [(5, 4, 5), (4, 3, 6), (6, 2, 6)]:
        py = _python_sector_basis(L, d, npart)
        nat, flat = native.sector_basis(L, d, npart)
        assert native.sector_count(L, d, npart) == len(py)
        np.testing.assert_array_equal(nat.astype(np.int64), py)
        # flat indices consistent with lexicographic order
        assert (np.diff(flat) > 0).all()


def test_sector_hamiltonian_matches_and_ground_energy():
    L, d, npart = 5, 4, 5
    r, c, v, n = native.sector_hamiltonian_coo(L, d, npart, 1.0, 2.5)
    H = np.zeros((n, n))
    np.add.at(H, (r, c), v)
    assert np.abs(H - H.T).max() < 1e-12
    # groundstate.sector_hamiltonian dispatches to native; both must agree
    # with the known exact ground energy
    E0 = np.linalg.eigvalsh(H)[0]
    E1 = np.linalg.eigvalsh(
        groundstate.sector_hamiltonian(L, d, npart, 1.0, 2.5))[0]
    assert abs(E0 - E1) < 1e-12


def test_sector_dim_dp_matches_enumeration():
    for (L, d, npart) in [(5, 4, 5), (8, 3, 8), (12, 5, 12)]:
        assert groundstate.sector_dim(L, d, npart) == \
            native.sector_count(L, d, npart)


def test_linsigmoid_batch_native():
    b = native.linsigmoid_batch(2.5, 50.0, 201, 8, seed=3)
    assert b.shape == (8, 201)
    assert np.all(np.abs(b[:, 0] - 2.5) < 0.05)
    assert np.all(np.abs(b[:, -1] - 50.0) < 0.05)
    # distinct ramps per batch entry
    assert np.abs(b[0] - b[1]).max() > 0.1
