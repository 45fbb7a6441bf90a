"""JAX DMRG (at-scale InitializeState rebuild) vs exact sector
diagonalization."""

import numpy as np
import pytest
import jax.numpy as jnp

from optimalcontrolmps import dmrg, groundstate, mps
from optimalcontrolmps.sites import op


def test_ramp_schedule():
    """Reference maxm ramp 10,20,50,100,200 capped at the target chi
    (InitializeState.hpp:53-57)."""
    assert dmrg.ramp_schedule(200) == [10, 20, 50, 100, 200]
    assert dmrg.ramp_schedule(64) == [10, 20, 50, 64]
    assert dmrg.ramp_schedule(25) == [10, 20, 25]
    assert dmrg.ramp_schedule(8) == [8]


def test_dmrg_matches_exact_small():
    L, d, npart = 5, 4, 5
    E0 = np.linalg.eigvalsh(
        groundstate.sector_hamiltonian(L, d, npart, 1.0, 2.5))[0]
    A, e = dmrg.dmrg_ground_state(L, d, npart, 1.0, 2.5, chi=25, n_sweeps=5)
    assert abs(float(e) - E0) < 1e-9
    vec = groundstate.ground_statevector(L, d, npart, 1.0, 2.5)
    ov = abs(np.vdot(np.asarray(mps.to_statevector(A)), vec))
    assert abs(ov - 1.0) < 1e-8


def test_dmrg_conserves_particle_number():
    """Without the (N-npart)^2 penalty the dense (non-QN) DMRG can drift to
    a neighboring sector; with it the particle number must hold exactly."""
    L, d, npart = 6, 3, 6
    A, e = dmrg.dmrg_ground_state(L, d, npart, 1.0, 3.0, chi=20, n_sweeps=5)
    ntot = float(jnp.sum(mps.expectation_values(A, op("N", d))).real)
    assert abs(ntot - npart) < 1e-6
    assert abs(float(mps.norm(A)) - 1.0) < 1e-9
    # chi=20 truncates (exact middle-bond rank is 64), so the variational
    # energy sits a few 1e-8 above exact — assert from above only
    E0 = np.linalg.eigvalsh(
        groundstate.sector_hamiltonian(L, d, npart, 1.0, 3.0))[0]
    assert E0 - 1e-10 <= float(e) < E0 + 1e-6


@pytest.mark.slow
def test_dmrg_reference_scale_ramp():
    """AnalyzeBondDim-default prep scale (N=20, d=7; chi=32 stage of the
    reference's maxm ramp): energy must decrease monotonically through
    the chi ramp and sweeps, converge by the energy-change criterion
    before the sweep bound, and conserve particle number exactly."""
    L, d, npart, chi = 20, 7, 20, 32
    A, e, hist = dmrg.dmrg_ground_state(L, d, npart, 1.0, 2.5, chi=chi,
                                        e_tol=1e-9, n_sweeps=8,
                                        return_history=True)
    energies = [h[1] for h in hist]
    assert len(energies) < 3 + 8            # converged before the bound
    # variational monotonicity (tiny float-noise allowance)
    assert all(e2 <= e1 + 1e-10 for e1, e2 in zip(energies, energies[1:]))
    # chi ramp visited the reference stages
    assert [h[0] for h in hist[:3]] == [10, 20, 32]
    ntot = float(jnp.sum(mps.expectation_values(A, op("N", d))).real)
    assert abs(ntot - npart) < 1e-6
    assert abs(float(mps.norm(A)) - 1.0) < 1e-9
    # agreement anchor: same ramped solver at a size with an exact answer
    E0 = np.linalg.eigvalsh(
        groundstate.sector_hamiltonian(5, 4, 5, 1.0, 2.5))[0]
    _, e5 = dmrg.dmrg_ground_state(5, 4, 5, 1.0, 2.5, chi=25)
    assert abs(float(e5) - E0) < 1e-9
