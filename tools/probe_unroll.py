"""Probe lax.scan unroll factors + GEMM formulations for the sector chain.

Variants (scalar-in/scalar-out, pure device compute):
  chain-uN   — gather-phase step chain with scan unroll=N
  real242    — complex GEMM as one real (B,242)@(242,242) block GEMM

Usage: python tools/probe_unroll.py [batch]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS = 400


def timeit(name, fn, reps=5):
    t0 = time.time()
    out = float(np.asarray(fn(np.float32(0.0))))
    compile_s = time.time() - t0
    t0 = time.time()
    for k in range(reps):
        out = float(np.asarray(fn(np.float32(1e-4 * (k + 1)))))
    dt = (time.time() - t0) / reps
    print(f"{name:10s} time/batch={dt * 1e3:8.1f}ms "
          f"us/step={dt / STEPS * 1e6:7.1f} compile={compile_s:.0f}s "
          f"out={out:.4f}", flush=True)


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    import jax
    import jax.numpy as jnp
    from optimalcontrolmps import sector

    print(f"backend={jax.devices()[0].platform} B={B}", flush=True)
    st = sector.make_sector_stepper(5, 4, 5, 1.0, 0.01, dtype=jnp.complex64)
    WT = np.asarray(st.WJ_fwd).T.copy()
    ns = st.ns
    vals = np.asarray(st.nn1_vals)
    inv = np.asarray(st.nn1_inv)
    rng = np.random.default_rng(0)
    psi0 = rng.normal(size=(B, 2, ns)).astype(np.float32)
    us0 = rng.uniform(2.0, 50.0, size=(STEPS, B)).astype(np.float32)
    dt = 0.01

    def make_chain(unroll):
        @jax.jit
        def run(eps):
            p = (psi0[:, 0] + eps + 1j * psi0[:, 1]).astype(np.complex64)

            def body(q, u):
                with jax.default_matmul_precision("highest"):
                    small = jnp.exp(-0.25j * dt * u[:, None] * vals[None, :])
                    ph = small[:, inv]
                    q = q * ph.astype(q.dtype)
                    q = q @ WT
                    q = q * ph.astype(q.dtype)
                    nr = jnp.linalg.norm(q, axis=1, keepdims=True)
                    q = q / nr.astype(q.dtype)
                    return q, None

            q, _ = jax.lax.scan(body, p, us0 + eps, unroll=unroll)
            return jnp.sum(jnp.abs(q[:, 0]))

        return run

    for u in (1, 4, 16):
        timeit(f"chain-u{u}", make_chain(u))

    # real block GEMM: [x_r, x_i] @ [[R, I], [-I, R]]
    R, I = WT.real.astype(np.float32), WT.imag.astype(np.float32)
    Wblk = np.block([[R, I], [-I, R]])  # (2ns, 2ns)

    @jax.jit
    def real242(eps):
        q = jnp.concatenate([psi0[:, 0] + eps, psi0[:, 1]], axis=1)  # (B,2ns)

        def body(p, u):
            with jax.default_matmul_precision("highest"):
                return p @ Wblk, None

        q, _ = jax.lax.scan(body, q, us0 + eps)
        return jnp.sum(jnp.abs(q[:, 0]))

    timeit("real242", real242)

    @jax.jit
    def cplx(eps):
        p = (psi0[:, 0] + eps + 1j * psi0[:, 1]).astype(np.complex64)

        def body(q, u):
            with jax.default_matmul_precision("highest"):
                return q @ WT, None

        q, _ = jax.lax.scan(body, p, us0 + eps)
        return jnp.sum(jnp.abs(q[:, 0]))

    timeit("cplx121", cplx)


if __name__ == "__main__":
    main()
