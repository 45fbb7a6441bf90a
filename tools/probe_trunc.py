"""Accuracy probe: truncation/gauge variants vs an f64 golden.

Runs the flagship cost+gradient (L=5, d=4, T=2.0, 201 steps, GROUP M=10,
chi=32) on the CPU backend for several (trunc_method, gauge_method, dtype)
variants and reports relative errors against the c128 eigh/qr golden.
Used to pick the cheapest accurate hot-path configuration.
"""

import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from optimalcontrolmps import control, engine, groundstate, seeds, tebd  # noqa: E402


def build(dtype, trunc, gauge, sweep="snake"):
    L, d, npart, T, dt, M, chi = 5, 4, 5, 2.0, 0.01, 10, 32
    N = int(round(T / dt)) + 1
    st = tebd.make_stepper(L, d, 1.0, dt, chi, dtype=dtype,
                           trunc_method=trunc, gauge_method=gauge,
                           sweep=sweep)
    psi_i = groundstate.initialize_state(L, d, npart, 1.0, 2.5, chi, dtype=dtype)
    psi_f = groundstate.initialize_state(L, d, npart, 1.0, 50.0, chi, dtype=dtype)
    real = jnp.float64 if dtype == jnp.complex128 else jnp.float32
    basis = control.chopped_sine_basis(seeds.adiabatic_seed(2.5, 50.0, N),
                                       dt, T, M, dtype=real)
    gamma = 1e-6

    @jax.jit
    def fg(c):
        u = basis.convert_control(c)
        g_u, (_, _, _, ov) = engine.gradient_lowmem(st, psi_i, psi_f, u, gamma)
        fid = (ov * ov.conj()).real
        J = 0.5 * (1.0 - fid) + engine.regularization(u, gamma, st.dt)
        return J, basis.convert_gradient(g_u)

    return fg


def main():
    rng = np.random.default_rng(3)
    c64 = rng.uniform(-0.5, 0.5, size=10).astype(np.float64)

    t0 = time.time()
    fg_gold = build(jnp.complex128, "eigh", "qr")
    J0, g0 = jax.block_until_ready(fg_gold(c64))
    J0, g0 = np.asarray(J0), np.asarray(g0)
    print(f"golden c128/eigh/qr: J={J0:.10f} |g|={np.linalg.norm(g0):.6e} "
          f"({time.time()-t0:.1f}s)", flush=True)

    variants = [
        ("c64  eigh   qr      ", jnp.complex64, "eigh", "qr"),
        ("c64  rsvd3  qr      ", jnp.complex64, "rsvd3", "qr"),
        ("c64  rsvd2  qr      ", jnp.complex64, "rsvd2", "qr"),
        ("c64  rsvd1  qr      ", jnp.complex64, "rsvd1", "qr"),
        ("c64  rsvd1  cholesky", jnp.complex64, "rsvd1", "cholesky"),
        ("c64  rsvd2  cholesky", jnp.complex64, "rsvd2", "cholesky"),
        ("c128 rsvd1  qr      ", jnp.complex128, "rsvd1", "qr"),
        ("c64  range  brick   ", jnp.complex64, "range", "qr", "brick"),
        ("c128 range  brick   ", jnp.complex128, "range", "qr", "brick"),
    ]
    for name, dtype, trunc, gauge, *rest in variants:
        sweep = rest[0] if rest else "snake"
        t0 = time.time()
        fg = build(dtype, trunc, gauge, sweep)
        c = c64.astype(np.float32) if dtype == jnp.complex64 else c64
        J, g = jax.block_until_ready(fg(c))
        J, g = float(J), np.asarray(g, dtype=np.float64)
        dJ = abs(J - J0) / max(abs(J0), 1e-30)
        dg = np.linalg.norm(g - g0) / max(np.linalg.norm(g0), 1e-30)
        print(f"{name}: J={J:.10f} relerr J={dJ:.3e} grad={dg:.3e} "
              f"({time.time()-t0:.1f}s)", flush=True)


if __name__ == "__main__":
    main()
