"""Decompose the sector-step cost on the device: where does a step's time go?

Variants (each a 400-iteration lax.scan at batch B, complex64, highest):
  gemm      — W @ psi only (the FLOP floor)
  gemm+ph   — GEMM + the two diagonal phase multiplies, exp over all ns
  gatherph  — GEMM + phases computed on the ~6 DISTINCT nn1 values then
              gathered to (ns,) (21x fewer transcendentals)
  full      — gemm+ph + per-step norm (the shipped step)
  gfull     — gatherph + per-step norm (candidate shipped step)

Usage: python tools/probe_sector_decomp.py [batch]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS = 400


def bench(name, make_fn, B, ns=121):
    import jax

    rng = np.random.default_rng(0)
    # feed a REAL (B, 2, ns) array and form the complex state inside jit
    psi0 = rng.normal(size=(B, 2, ns)).astype(np.float32)
    nrm = np.linalg.norm(psi0.reshape(B, -1), axis=1, keepdims=True)
    psi0 = psi0 / nrm[:, :, None] if psi0.ndim == 3 else psi0 / nrm
    raw = make_fn(B)

    def fn(p2, us):
        psi = (p2[:, 0] + 1j * p2[:, 1]).astype(np.complex64)
        return raw(psi, us)

    fn = jax.jit(fn)
    us = rng.uniform(2.0, 50.0, size=(B, STEPS + 1)).astype(np.float32)

    t0 = time.time()
    out = np.asarray(fn(psi0, us))
    compile_s = time.time() - t0
    reps = 5
    t0 = time.time()
    for k in range(reps):
        out = np.asarray(fn(psi0, us + np.float32(1e-5 * k)))
    dt_b = (time.time() - t0) / reps
    print(f"{name:10s} B={B} time/batch={dt_b * 1e3:8.1f}ms "
          f"us/step={dt_b / STEPS * 1e6:7.1f} compile={compile_s:.0f}s "
          f"finite={np.isfinite(out).all()}", flush=True)


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    import jax
    import jax.numpy as jnp
    from optimalcontrolmps import sector

    st = sector.make_sector_stepper(5, 4, 5, 1.0, 0.01, dtype=jnp.complex64)
    W = np.asarray(st.WJ_fwd)
    nn1 = np.asarray(st.nn1)
    vals, inv = np.unique(nn1, return_inverse=True)
    print(f"backend={jax.devices()[0].platform} ns={st.ns} "
          f"distinct nn1 values={len(vals)}", flush=True)
    dt = 0.01

    WT = W.T.copy()

    def make_gemm(B):
        def fn(psi, us):
            def body(p, u):
                with jax.default_matmul_precision("highest"):
                    return p @ WT, None

            out, _ = jax.lax.scan(body, psi, us.T[:STEPS])
            return jnp.abs(out[:, 0])

        return fn

    def make_gemm_ph(B, norm=False):
        def fn(psi, us):
            def body(p, u):
                with jax.default_matmul_precision("highest"):
                    ph1 = jnp.exp(-0.25j * dt * u[:, None] * nn1[None, :])
                    p = p * ph1.astype(p.dtype)
                    p = p @ WT
                    p = p * ph1.astype(p.dtype)
                    if norm:
                        nr = jnp.linalg.norm(p, axis=1, keepdims=True)
                        p = p / nr.astype(p.dtype)
                    return p, None

            out, _ = jax.lax.scan(body, psi, us.T[:STEPS])
            return jnp.abs(out[:, 0])

        return fn

    def make_gatherph(B, norm=False):
        def fn(psi, us):
            def body(p, u):
                with jax.default_matmul_precision("highest"):
                    small = jnp.exp(-0.25j * dt * u[:, None]
                                    * vals[None, :])      # (B, k)
                    ph1 = small[:, inv]                    # (B, ns) gather
                    p = p * ph1.astype(p.dtype)
                    p = p @ WT
                    p = p * ph1.astype(p.dtype)
                    if norm:
                        nr = jnp.linalg.norm(p, axis=1, keepdims=True)
                        p = p / nr.astype(p.dtype)
                    return p, None

            out, _ = jax.lax.scan(body, psi, us.T[:STEPS])
            return jnp.abs(out[:, 0])

        return fn

    bench("gemm", make_gemm, B)
    bench("gemm+ph", lambda b: make_gemm_ph(b, False), B)
    bench("gatherph", lambda b: make_gatherph(b, False), B)
    bench("full", lambda b: make_gemm_ph(b, True), B)
    bench("gfull", lambda b: make_gatherph(b, True), B)


if __name__ == "__main__":
    main()
