"""Sector-engine speed probe: per-step cost variants on the default device.

Measures batched cost+adjoint-gradient throughput of the flagship sector
workload for several step formulations, each with an accuracy check against
the exact complex128 golden (J=0.1292463977 at the probe control, seed 3 —
the sector channel is exact, tools/probe_trunc.py):

  base        — sector.gradient_lowmem as shipped (per-step renorm, highest)
  nonorm      — no per-step normalization (the step is unitary; one final
                normalization pins f32 drift)
  pad128      — ns=126 padded to 128 (whole 128-wide tile)
  nonorm128   — both
  high        — matmul precision "high" instead of "highest"
  high-nn128  — "high" + nonorm + pad128

Usage: python tools/probe_sector_speed.py [batch]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GOLDEN_J = 0.1292463977


def make_variant(norm_every_step: bool, pad: int | None):
    import jax
    import jax.numpy as jnp
    from optimalcontrolmps import control, sector, seeds
    from optimalcontrolmps.engine import (regularization,
                                          regularization_grad)

    T, dt, M, L, d, npart = 2.0, 0.01, 10, 5, 4, 5
    N = int(round(T / dt)) + 1
    st = sector.make_sector_stepper(L, d, npart, 1.0, dt, dtype=jnp.complex64)
    psi_i = sector.sector_ground_state(L, d, npart, 1.0, 2.5,
                                       dtype=np.complex64)
    psi_f = sector.sector_ground_state(L, d, npart, 1.0, 50.0,
                                       dtype=np.complex64)
    basis = control.chopped_sine_basis(seeds.adiabatic_seed(2.5, 50.0, N),
                                       dt, T, M, dtype=jnp.float32)
    gamma = 1e-6

    ns = st.ns
    WJf = np.asarray(st.WJ_fwd)
    nn1 = np.asarray(st.nn1)
    if pad is not None and pad > ns:
        W = np.eye(pad, dtype=WJf.dtype)
        W[:ns, :ns] = WJf
        WJf = W
        nn1 = np.concatenate([nn1, np.zeros(pad - ns, dtype=nn1.dtype)])
        psi_i = np.concatenate([psi_i, np.zeros(pad - ns, psi_i.dtype)])
        psi_f = np.concatenate([psi_f, np.zeros(pad - ns, psi_f.dtype)])
    WJb = np.conj(WJf)
    half = 0.5 * nn1

    def step(psi, u_from, u_to, forward):
        W = WJf if forward else WJb
        uf = u_from if forward else -u_from
        ut = u_to if forward else -u_to
        psi = psi * jnp.exp(-0.25j * uf * dt * half * 2).astype(psi.dtype)
        psi = W @ psi
        psi = psi * jnp.exp(-0.25j * ut * dt * half * 2).astype(psi.dtype)
        if norm_every_step:
            nrm = jnp.linalg.norm(psi)
            psi = psi * (1.0 / nrm).astype(psi.dtype)
        return psi

    def grad_fn(c):
        u = basis.convert_control(c)
        # forward rollout storing psi_t
        def fwd(psi, uu):
            nxt = step(psi, uu[0], uu[1], True)
            return nxt, nxt

        pairs = jnp.stack([u[:-1], u[1:]], axis=1)
        _, traj = jax.lax.scan(fwd, jnp.asarray(psi_i), pairs)
        psi_t = jnp.concatenate([jnp.asarray(psi_i)[None], traj], axis=0)
        if not norm_every_step:
            psi_t = psi_t / jnp.linalg.norm(psi_t, axis=1, keepdims=True)

        def bwd(xi, inp):
            u_i, u_im1, psi_im1 = inp
            xi_next = step(xi, u_i, u_im1, False)
            div = jnp.sum(xi_next.conj() * half * psi_im1)
            return xi_next, div

        inps = (u[1:][::-1], u[:-1][::-1], psi_t[:-1][::-1])
        divT_last = jnp.sum(jnp.asarray(psi_f).conj() * half * psi_t[-1])
        _, divs = jax.lax.scan(bwd, jnp.asarray(psi_f), inps)
        divT = jnp.concatenate([divs[::-1], divT_last[None]])
        ov = jnp.vdot(psi_t[-1], jnp.asarray(psi_f))
        g = dt * (divT * ov * 1j).real + regularization_grad(u, gamma, dt)
        fid = (ov * ov.conj()).real
        J = 0.5 * (1.0 - fid) + regularization(u, gamma, dt)
        return J, basis.convert_gradient(g)

    return grad_fn, basis.M


def run_variant(name, norm_every_step, pad, precision, B):
    import jax

    grad_fn, M = make_variant(norm_every_step, pad)

    def fn(c):
        with jax.default_matmul_precision(precision):
            return grad_fn(c)

    batched = jax.jit(jax.vmap(fn))
    rng = np.random.default_rng(0)
    cs = rng.uniform(-0.05, 0.05, size=(B, M)).astype(np.float32)

    # accuracy: row 0 = the golden probe control (seed 3)
    cg = np.random.default_rng(3).uniform(-0.5, 0.5, 10)
    cs[0] = cg.astype(np.float32)

    t0 = time.time()
    J = np.asarray(batched(cs)[0])
    compile_s = time.time() - t0
    reps = 3
    t0 = time.time()
    for k in range(reps):
        J = np.asarray(batched(cs + np.float32(1e-6 * k))[0])
    dt_b = (time.time() - t0) / reps
    err = abs(float(J[0]) - GOLDEN_J)
    print(f"{name:12s} B={B} evals/s={B / dt_b:10.1f} "
          f"time/batch={dt_b:.3f}s compile={compile_s:.0f}s "
          f"dJ_vs_golden={err:.2e} finite={np.isfinite(J).all()}",
          flush=True)


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    import jax
    print(f"backend={jax.devices()[0].platform}", flush=True)
    run_variant("base", True, None, "highest", B)
    run_variant("nonorm", False, None, "highest", B)
    run_variant("pad128", True, 128, "highest", B)
    run_variant("nonorm128", False, 128, "highest", B)
    run_variant("high", True, None, "high", B)
    run_variant("high-nn128", False, 128, "high", B)


if __name__ == "__main__":
    main()
