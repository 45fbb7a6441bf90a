"""Tests for the batched sector chain (ops/sector_chain.py).

Validation on the CPU backend:
  1. the chain reproduces sector.rollout_final exactly (same merged-phase
     algebra);
  2. the custom-vjp gradient (reversible backward) matches jax.grad
     through sector.cost and through the plain scan, at two shapes;
  3. the chain is plain XLA: no kernel path is left in it.
`test_chain_on_gpu_matches_cpu` runs on the card only (`gpu` marker).
"""

import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from optimalcontrolmps import control, sector, seeds
from optimalcontrolmps.engine import regularization
from optimalcontrolmps.ops import sector_chain as sc

T, DT, M, L, D, NPART, GAMMA = 0.5, 0.01, 8, 5, 4, 5, 1e-6


def _controls(n_lanes, n_steps, seed=5):
    rng = np.random.default_rng(seed)
    ramp = seeds.adiabatic_seed(2.5, 50.0, n_steps)
    return np.asarray([ramp + rng.normal(0, 0.3, n_steps)
                       for _ in range(n_lanes)], dtype=np.float32)


@pytest.fixture(scope="module")
def prob():
    N = int(round(T / DT)) + 1
    st = sector.make_sector_stepper(L, D, NPART, 1.0, DT,
                                    dtype=jnp.complex64)
    psi_i = sector.sector_ground_state(L, D, NPART, 1.0, 2.5,
                                       dtype=np.complex64)
    psi_f = sector.sector_ground_state(L, D, NPART, 1.0, 50.0,
                                       dtype=np.complex64)
    return st, psi_i, psi_f, _controls(4, N)


def _infidelity_sum(chain, st, psi_i, psi_f):
    def batched_cost(u_bt):
        ov = chain(st, u_bt, psi_i) @ jnp.asarray(np.conj(psi_f))
        return jnp.sum(0.5 * (1.0 - (ov * ov.conj()).real))
    return batched_cost


def test_chain_matches_sector_rollout(prob):
    st, psi_i, psi_f, u_bt = prob
    psiT = np.asarray(sc.chain_final(st, u_bt, psi_i))
    for b in range(u_bt.shape[0]):
        ref = np.asarray(sector.rollout_final(st, psi_i, u_bt[b]))
        np.testing.assert_allclose(psiT[b], ref, atol=2e-5)


@pytest.mark.parametrize("n_lanes, n_steps", [(4, 51), (3, 26)])
def test_chain_gradient_matches_autodiff(prob, n_lanes, n_steps):
    st, psi_i, psi_f, _ = prob
    u_bt = _controls(n_lanes, n_steps, seed=n_steps)

    def batched_cost(u_bt):
        psiT = sc.chain_final(st, u_bt, psi_i)
        ov = psiT @ jnp.asarray(np.conj(psi_f))
        fid = (ov * ov.conj()).real
        reg = jax.vmap(lambda u: regularization(u, GAMMA, st.dt))(u_bt)
        return jnp.sum(0.5 * (1.0 - fid) + reg)

    g = np.asarray(jax.grad(batched_cost)(jnp.asarray(u_bt)))
    assert g.shape == u_bt.shape
    for b in range(2):
        g_ref = np.asarray(jax.grad(
            lambda u: sector.cost(st, psi_i, psi_f, u, GAMMA))(
                jnp.asarray(u_bt[b])))
        scale = np.max(np.abs(g_ref))
        np.testing.assert_allclose(g[b], g_ref, atol=3e-5 * max(scale, 1.0))
    # the reversible backward against autodiff through the plain scan
    g_scan = np.asarray(jax.grad(_infidelity_sum(
        sc.chain_final_autodiff, st, psi_i, psi_f))(jnp.asarray(u_bt)))
    g_rev = np.asarray(jax.grad(_infidelity_sum(
        sc.chain_final, st, psi_i, psi_f))(jnp.asarray(u_bt)))
    np.testing.assert_allclose(g_rev, g_scan,
                               atol=3e-5 * max(np.abs(g_scan).max(), 1.0))


def test_chain_has_no_kernel_path(prob):
    """The chain is one XLA scan forward and one backward: no Pallas or
    custom kernel, and no option that selects one."""
    st, psi_i, psi_f, u_bt = prob
    jaxpr = str(jax.make_jaxpr(jax.grad(_infidelity_sum(
        sc.chain_final, st, psi_i, psi_f)))(jnp.asarray(u_bt)))
    assert "pallas_call" not in jaxpr and "custom_call" not in jaxpr
    assert "scan[" in jaxpr
    assert list(inspect.signature(sc.chain_final).parameters) == [
        "st", "u_bt", "psi0"]


@pytest.mark.gpu
def test_chain_on_gpu_matches_cpu(prob, gpu_device):
    """f32 "highest" on the card: a TF32 product would show as ~1e-3."""
    st, psi_i, psi_f, u_bt = prob
    cpu = np.asarray(sc.chain_final(st, u_bt, psi_i))
    with jax.default_device(gpu_device):
        gpu = np.asarray(sc.chain_final(st, jnp.asarray(u_bt), psi_i))
    np.testing.assert_allclose(gpu, cpu, atol=2e-5)


def test_batched_lbfgs_matches_vmapped(prob):
    """minimize_lbfgs_batch must reproduce vmap(minimize_lbfgs) on the
    same objective — lockstep semantics by hand."""
    from optimalcontrolmps.optimize.lbfgs import (minimize_lbfgs,
                                                  minimize_lbfgs_batch)
    st, psi_i, psi_f, _ = prob
    N = int(round(T / DT)) + 1
    rng = np.random.default_rng(11)
    u0 = seeds.linsigmoid_seed(2.5, 50.0, N, rng=np.random.default_rng(1))
    basis = control.chopped_sine_basis(u0, DT, T, M, dtype=np.float32)
    cs = rng.uniform(-0.3, 0.3, size=(6, M)).astype(np.float32)

    def fg(c):
        return jax.value_and_grad(
            lambda c: sector.cost(st, psi_i, psi_f,
                                  basis.convert_control(c), GAMMA))(c)

    def fg_batch(C):
        f, g = jax.vmap(fg)(C)
        return f, g

    r_v = jax.jit(jax.vmap(lambda c: minimize_lbfgs(
        fg, c, max_iter=25, tol=1e-6)))(jnp.asarray(cs))
    r_b = jax.jit(lambda C: minimize_lbfgs_batch(
        fg_batch, C, max_iter=25, tol=1e-6))(jnp.asarray(cs))
    np.testing.assert_allclose(np.asarray(r_b.f), np.asarray(r_v.f),
                               rtol=2e-4, atol=2e-6)
    # both must actually have optimized
    J0, _ = fg_batch(jnp.asarray(cs))
    assert float(jnp.max(r_b.f - J0)) < 0
