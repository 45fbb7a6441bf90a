"""Wall-clock the streaming block Hessian's two hot programs on the chip.

BASELINE configs[3] (N=20, chi=200, T=6.0, GROUP, exact-Hessian IP) is
Hessian-dominated; the per-iteration wall is S(S+1)/2 block-step calls
plus S block-init calls (streaming.BlockHessian). This probe times one
of each at the target shapes and extrapolates the full Hessian so the
run configuration (chi, dt, R) can be chosen honestly BEFORE the
multi-hour background solve is launched.

Usage: python tools/probe_block_hessian.py [chi] [n_steps] [R] [L]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("OCMPS_TRUNC_ORTH", "gram")


def main():
    chi = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 301
    R = int(sys.argv[3]) if len(sys.argv) > 3 else 60
    L = int(sys.argv[4]) if len(sys.argv) > 4 else 20
    d, J, dt = 7, 1.0, 0.02

    import jax
    import jax.numpy as jnp
    import numpy as np

    from optimalcontrolmps import mps, seeds, tebd, vidal
    from optimalcontrolmps.profiling import enable_compile_cache
    enable_compile_cache()

    backend = jax.devices()[0].platform
    dtype = jnp.complex128 if backend == "cpu" else jnp.complex64
    print(f"backend={backend} L={L} chi={chi} n={n} R={R} dtype={dtype}",
          flush=True)

    st = tebd.make_stepper(L, d, J, dt, chi, dtype=dtype, sweep="vidal",
                           trunc_method="nssub")

    # cheap synthetic canonical state (unit filling product, padded):
    # the probe measures FLOPs/shapes, not physics
    occ = np.ones(L, dtype=int)
    A = np.asarray(mps.product_state(occ, d + 1, chi))
    v = vidal.from_mps(A)
    v = vidal.to_matrix_carriers(v)
    from optimalcontrolmps.ops import complex_io as cio
    v = jax.tree_util.tree_map(
        lambda a: cio.put(np.asarray(a, dtype)), v)

    rng = np.random.default_rng(0)
    u = jnp.asarray(seeds.linsigmoid_seed(2.5, 50.0, n, rng=rng),
                    jnp.float64 if backend == "cpu" else jnp.float32)

    t0 = time.time()
    H = vidal.hessian_streaming(
        st, v, v, u, 1e-6, row_block=R,
        progress=lambda c, s: print(
            f"  block c={c} s={s} t={time.time()-t0:.1f}s", flush=True))
    wall = time.time() - t0
    S = (n - 1) // ((n - 1) if R > n - 1 else R)
    print(f"full streaming Hessian wall: {wall:.1f}s "
          f"(n={n}, R={R}, S={S}, sym_err={np.abs(H-H.T).max():.2e})",
          flush=True)


if __name__ == "__main__":
    main()
