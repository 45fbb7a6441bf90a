"""Speed probe: snake vs vidal TEBD at production chain sizes.

The vidal brick step replaces ~3L sequential contraction/factorization ops
per Trotter step with 2 batched bond updates. This probe measures wall
time per rollout step at the AnalyzeBondDim-style config (L=20, d=7) for
both sweeps, batched over a small multistart axis.

Usage: python tools/probe_vidal_speed.py [L] [chi] [batch] [steps] [sweeps]
       sweeps: comma list, default "snake,vidal"; a sweep may carry an
       orthonormalization policy suffix, e.g. "vidal:ns" (OCMPS_TRUNC_ORTH)
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp
    from optimalcontrolmps import mps, tebd, vidal
    from optimalcontrolmps.ops import complex_io as cio
    from optimalcontrolmps.profiling import enable_compile_cache

    enable_compile_cache()

    L = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    chi = int(sys.argv[2]) if len(sys.argv) > 2 else 48
    B = int(sys.argv[3]) if len(sys.argv) > 3 else 8
    nsteps = int(sys.argv[4]) if len(sys.argv) > 4 else 50
    d = 7
    p = d + 1
    dt = 5e-3
    print(f"backend={jax.devices()[0].platform} L={L} d={d} chi={chi} "
          f"B={B} steps={nsteps}", flush=True)

    # unit-filling product start (bond growth fills chi within a few steps)
    occ = [1] * L
    A0 = mps.product_state(occ, p, chi, dtype=np.complex64)
    lam0 = np.zeros((L - 1, chi, chi), np.complex64)
    lam0[:, 0, 0] = 1.0  # matrix carriers (matmul-only bond update)
    u = np.linspace(30.0, 2.0, nsteps + 1).astype(np.float32)

    def run(spec):
        sweep, _, orth = spec.partition(":")
        os.environ["OCMPS_TRUNC_ORTH"] = orth or "mgs"
        # both sweeps use the matmul-only 'nssub' truncation; snake
        # gauges via scan-based MGS (ops/matfree.py)
        st = tebd.make_stepper(
            L, d, 1.0, dt, chi, dtype=jnp.complex64, trunc_method="nssub",
            gauge_method="mgs" if sweep == "snake" else "qr",
            sweep=sweep)

        if sweep == "vidal":
            def roll(A, lam, uu):
                s0 = vidal.VidalState(B=A, lam=lam)  # matrix carriers
                def body(s, pair):
                    return vidal.vidal_step(st, s, pair[0], pair[1],
                                            True), None
                pairs = jnp.stack([uu[:-1], uu[1:]], axis=1)
                sT, _ = jax.lax.scan(body, s0, pairs)
                return mps.norm(sT.B)  # scalar download = sync point
            fn = jax.jit(jax.vmap(roll, in_axes=(0, 0, None)))
            # stage via real planes (ops/complex_io.py)
            args = (cio.put(np.broadcast_to(A0, (B,) + A0.shape)),
                    cio.put(np.broadcast_to(lam0, (B,) + lam0.shape)))
        else:
            def roll(A, uu):
                def body(a, pair):
                    return tebd.tebd_step(st, a, pair[0], pair[1], True), None
                pairs = jnp.stack([uu[:-1], uu[1:]], axis=1)
                aT, _ = jax.lax.scan(body, A, pairs)
                return mps.norm(aT)
            fn = jax.jit(jax.vmap(roll, in_axes=(0, None)))
            args = (cio.put(np.broadcast_to(A0, (B,) + A0.shape)),)

        t0 = time.time()
        out = np.asarray(fn(*args, u))
        compile_s = time.time() - t0
        reps = 3
        t0 = time.time()
        for k in range(reps):
            out = np.asarray(fn(*args, u + np.float32(1e-6 * k)))
        per = (time.time() - t0) / reps
        print(f"{spec:9s} rollout={per:.3f}s  ms/step={1e3 * per / nsteps:8.2f} "
              f"compile={compile_s:.0f}s norm[0]={out[0]:.6f} "
              f"finite={np.isfinite(out).all()}", flush=True)
        return per

    sweeps = (sys.argv[5].split(",") if len(sys.argv) > 5
              else ["snake", "vidal"])
    times = {s: run(s) for s in sweeps}
    if len(times) == 2:
        a, b = list(times)
        print(f"speedup {a}/{b} = {times[a] / times[b]:.2f}x", flush=True)


if __name__ == "__main__":
    main()
