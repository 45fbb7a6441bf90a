"""Golden cost/fidelity regression tests.

Cross-implementation anchors ported from the reference's CostTests
(/root/reference/tests/CostTests.cpp): same physics (L=5, Npart=5, Fock
cutoff 5, J=1, T=0.1, dt=0.01), same control ramps, and the hardcoded
fidelity/cost vectors "calculated using old version of program".

Tolerance note: the reference prepares its boundary states with DMRG at
cutoff 1e-9 (InitializeState.hpp:53-57), which leaves an O(1e-5) state error
that is baked into the golden numbers; our ground states are *exact*
(126-dim sector eigh, verified against an independent full-space kron
construction). The residual difference is 5.8e-6 max, entirely explained by
the reference's DMRG convergence, so goldens are checked at 1e-5 here and
machine-precision anchoring is done in test_tebd.py (TEBD vs exact
statevector at 1e-9).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from optimalcontrolmps import engine, groundstate, tebd
from optimalcontrolmps import control as controllib
from optimalcontrolmps import seeds

L, NPART, D = 5, 5, 5
J, CSTART, CEND = 1.0, 2.0, 50.0
T, TSTEP = 0.1, 1e-2
N = int(T / TSTEP + 1)  # 11
M = 5
CHI = 40

# tests/CostTests.cpp:75 — fidelities for linear GRAPE ramp 2 -> 50
FID_LINEAR = [0.214338, 0.214325, 0.215126, 0.217281, 0.221019, 0.22621,
              0.232328, 0.238484, 0.243617, 0.246862, 0.24801]
# tests/CostTests.cpp:90 — fidelities for constant control u = 1
FID_CONST1 = [0.214338, 0.214233, 0.213919, 0.213398, 0.212672, 0.211744,
              0.210618, 0.2093, 0.207796, 0.206112, 0.204256]
# tests/CostTests.cpp:124 — GROUP c = linspace(0, 7, 5)
FID_GROUP2 = [0.214338, 0.21411, 0.216706, 0.222581, 0.229759, 0.23623,
              0.242512, 0.249913, 0.256515, 0.259334, 0.259687]


@pytest.fixture(scope="module")
def problem():
    st = tebd.make_stepper(L, D, J, TSTEP, CHI)
    psi_i = groundstate.initialize_state(L, D, NPART, J, CSTART, CHI)
    psi_f = groundstate.initialize_state(L, D, NPART, J, CEND, CHI)
    return st, psi_i, psi_f


@pytest.fixture(scope="module")
def basis():
    u0 = seeds.linspace(CSTART, CEND, N)
    return controllib.chopped_sine_basis(u0, TSTEP, T, M)


def test_grape_fidelities_linear(problem):
    """CostTests.cpp:68-98 (testGRAPEfidelities, first ramp)."""
    st, psi_i, psi_f = problem
    u = jnp.asarray(seeds.linspace(CSTART, CEND, N))
    c = jax.jit(lambda uu: engine.cost(st, psi_i, psi_f, uu, 0.0))(u)
    fid = jax.jit(lambda uu: engine.fidelities(st, psi_i, psi_f, uu))(u)
    assert fid.shape == (N,)
    np.testing.assert_allclose(float(c), 0.375995, atol=1e-5)
    np.testing.assert_allclose(np.asarray(fid), FID_LINEAR, atol=1e-5)


def test_grape_fidelities_const(problem):
    """CostTests.cpp:83-98 (testGRAPEfidelities, u = 1)."""
    st, psi_i, psi_f = problem
    u = jnp.ones(N)
    c = engine.cost(st, psi_i, psi_f, u, 0.0)
    fid = engine.fidelities(st, psi_i, psi_f, u)
    np.testing.assert_allclose(float(c), 0.397872, atol=1e-5)
    np.testing.assert_allclose(np.asarray(fid), FID_CONST1, atol=1e-5)


def test_group_fidelities(problem, basis):
    """CostTests.cpp:102-133 (testGROUPfidelities)."""
    st, psi_i, psi_f = problem
    # c = 0 reproduces u0 = the linear ramp
    u = basis.convert_control(jnp.zeros(M))
    c = engine.cost(st, psi_i, psi_f, u, 0.0)
    np.testing.assert_allclose(float(c), 0.375995, atol=1e-5)

    c2 = jnp.asarray(seeds.linspace(0.0, 7.0, M))
    u2 = basis.convert_control(c2)
    cost2 = engine.cost(st, psi_i, psi_f, u2, 0.0)
    fid2 = engine.fidelities(st, psi_i, psi_f, u2)
    np.testing.assert_allclose(float(cost2), 0.370157, atol=1e-5)
    np.testing.assert_allclose(np.asarray(fid2), FID_GROUP2, atol=1e-5)


def test_grape_regularization(problem):
    """CostTests.cpp:136-167 (testGRAPEregularization, gamma = 1)."""
    st, psi_i, psi_f = problem
    u = jnp.asarray(seeds.linspace(CSTART, CEND, N))
    c = engine.cost(st, psi_i, psi_f, u, 1.0)
    np.testing.assert_allclose(float(c), 11520.4, atol=1e-1)


def test_group_regularization(problem, basis):
    """CostTests.cpp:170-204 (testGROUPregularization, gamma = 1)."""
    st, psi_i, psi_f = problem
    c2 = jnp.asarray(seeds.linspace(0.0, 7.0, M))
    u2 = basis.convert_control(c2)
    cost2 = engine.cost(st, psi_i, psi_f, u2, 1.0)
    np.testing.assert_allclose(float(cost2), 48360.2, atol=1e-1)
