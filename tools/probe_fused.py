"""A/B probe: sector gradient_lowmem step formulations on the default device.

All variants use the distinct-nn1-value phase gather.

  old        — round-1 shipped chain: phase, GEMM, phase, norm per step
  fused      — merged-phase carriers (one phase multiply per step, no norm)
               == the shipped sector.gradient_lowmem after the round-2 edit
  fused128   — fused + constants zero-padded to ns=128 (whole 128-wide tiles)

Accuracy vs the exact complex128 golden J=0.1292463977 (seed-3 control,
tools/probe_trunc.py). Usage: python tools/probe_fused.py [batch]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GOLDEN_J = 0.1292463977


def make_fn(variant: str):
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

    if variant == "fused":
        def fn(c):
            u = basis.convert_control(c)
            g_u, (_, _, _, ov) = sector.gradient_lowmem(st, psi_i, psi_f, u,
                                                        gamma)
            fid = (ov * ov.conj()).real
            J = 0.5 * (1.0 - fid) + regularization(u, gamma, st.dt)
            return J, basis.convert_gradient(g_u)
        return fn, basis.M

    WJf = np.asarray(st.WJ_fwd)
    nn1 = np.asarray(st.nn1)
    vals = np.asarray(st.nn1_vals)
    inv = np.asarray(st.nn1_inv)
    ns = st.ns
    pi, pf = psi_i, psi_f
    if variant == "fused128":
        P = 128
        W = np.eye(P, dtype=WJf.dtype)
        W[:ns, :ns] = WJf
        WJf = W
        # padded states have nn1 = 0, which is always among the distinct
        # values (the unit-filling state has every n_i <= 1)
        zi = int(np.where(vals == 0.0)[0][0])
        inv = np.concatenate([inv, np.full(P - ns, zi, np.int32)])
        nn1 = np.concatenate([nn1, np.zeros(P - ns, nn1.dtype)])
        pi = np.concatenate([pi, np.zeros(P - ns, pi.dtype)])
        pf = np.concatenate([pf, np.zeros(P - ns, pf.dtype)])
    WJb = np.conj(WJf)
    half = (0.5 * nn1).astype(np.float32)

    def ph(u, power, dtype):
        small = jnp.exp((-0.25j * power * dt) * u * vals)
        return small[inv].astype(dtype)

    if variant == "old":
        def step(psi, u_from, u_to, forward):
            W = WJf if forward else WJb
            uf = u_from if forward else -u_from
            ut = u_to if forward else -u_to
            psi = psi * ph(uf, 1, psi.dtype)
            psi = W @ psi
            psi = psi * ph(ut, 1, psi.dtype)
            nrm = jnp.linalg.norm(psi)
            return psi * (1.0 / nrm).astype(psi.dtype)

        def fn(c):
            u = basis.convert_control(c)

            def fwd(psi, uu):
                nxt = step(psi, uu[0], uu[1], True)
                return nxt, nxt

            pairs = jnp.stack([u[:-1], u[1:]], axis=1)
            _, traj = jax.lax.scan(fwd, jnp.asarray(pi), pairs)
            psi_t = jnp.concatenate([jnp.asarray(pi)[None], traj], axis=0)

            def bwd(xi, inp):
                u_i, u_im1, psi_im1 = inp
                xi_next = step(xi, u_i, u_im1, False)
                div = jnp.sum(xi_next.conj() * half * psi_im1)
                return xi_next, div

            inps = (u[1:][::-1], u[:-1][::-1], psi_t[:-1][::-1])
            divT_last = jnp.sum(jnp.asarray(pf).conj() * half * psi_t[-1])
            _, divs = jax.lax.scan(bwd, jnp.asarray(pf), inps)
            divT = jnp.concatenate([divs[::-1], divT_last[None]])
            ov = jnp.vdot(psi_t[-1], jnp.asarray(pf))
            g = dt * (divT * ov * 1j).real + regularization_grad(u, gamma, dt)
            fid = (ov * ov.conj()).real
            J = 0.5 * (1.0 - fid) + regularization(u, gamma, dt)
            return J, basis.convert_gradient(g)
        return fn, basis.M

    assert variant == "fused128"

    def fn(c):
        u = basis.convert_control(c)
        dtype = jnp.complex64

        def fwd(h, u_next):
            h = (WJf @ h) * ph(u_next, 2, dtype)
            return h, h

        h0 = jnp.asarray(pi) * ph(u[0], 1, dtype)
        hT, h_traj = jax.lax.scan(fwd, h0, u[1:])
        h_t = jnp.concatenate([h0[None], h_traj], axis=0)

        def bwd(gx, inp):
            u_i, u_im1, h_im1 = inp
            gx = (WJb @ gx) * ph(u_im1, -2, dtype)
            div = jnp.sum(gx.conj() * (ph(u_im1, -2, dtype) * half) * h_im1)
            return gx, div

        gxN = jnp.asarray(pf) * ph(u[-1], -1, dtype)
        divT_last = jnp.sum(gxN.conj() * (ph(u[-1], -2, dtype) * half) * hT)
        inps = (u[1:][::-1], u[:-1][::-1], h_t[:-1][::-1])
        _, divs = jax.lax.scan(bwd, gxN, inps)
        divT = jnp.concatenate([divs[::-1], divT_last[None]])
        ov = jnp.vdot(hT, ph(u[-1], 1, dtype) * jnp.asarray(pf))
        ov = ov / jnp.maximum(jnp.linalg.norm(hT), 1e-16).astype(ov.dtype)
        g = dt * (divT * ov * 1j).real + regularization_grad(u, gamma, dt)
        fid = (ov * ov.conj()).real
        J = 0.5 * (1.0 - fid) + regularization(u, gamma, dt)
        return J, basis.convert_gradient(g)
    return fn, basis.M


def run(variant, B):
    import jax

    fn, M = make_fn(variant)

    def wrapped(c):
        with jax.default_matmul_precision("highest"):
            return fn(c)

    batched = jax.jit(jax.vmap(wrapped))
    rng = np.random.default_rng(0)
    cs = rng.uniform(-0.05, 0.05, size=(B, M)).astype(np.float32)
    cs[0] = np.random.default_rng(3).uniform(-0.5, 0.5, 10).astype(np.float32)

    t0 = time.time()
    J = np.asarray(batched(cs)[0])
    compile_s = time.time() - t0
    reps = 5
    t0 = time.time()
    for k in range(reps):
        J = np.asarray(batched(cs + np.float32(1e-6 * k))[0])
    dt_b = (time.time() - t0) / reps
    err = abs(float(J[0]) - GOLDEN_J)
    print(f"{variant:10s} B={B} evals/s={B / dt_b:10.1f} "
          f"time/batch={dt_b:.4f}s compile={compile_s:.0f}s "
          f"dJ_vs_golden={err:.2e} finite={np.isfinite(J).all()}",
          flush=True)


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    import jax
    print(f"backend={jax.devices()[0].platform}", flush=True)
    for v in ("old", "fused", "fused128", "old", "fused"):
        run(v, B)


if __name__ == "__main__":
    main()
