"""chi=256 segmented adjoint gradient at reference scale, on chip.

Round-4's AnalyzeBondDim chi=256 gradient ran out of device memory (the
[::-1] stack flips doubled its peak); round 5 replaced the flips with
reverse=True scans. This probe runs EXACTLY the crashed computation —
vidal.gradient_segmented at N=20, d=7, chi=256, T=5, dt=5e-3
(N_t=1001), exp ramp 2.5->50, nssub gram carriers, sqrt(N_t)
checkpointing — WITHOUT the analysis driver's per-step diagnostics
chain (whose XLA lowering alone is tens of CPU-minutes at this width;
the gradient program itself compiles in minutes). Writes the per-t
gradient column next to round-4's fidelity artifacts.

Usage: python tools/probe_chi256_gradient.py [chi]
"""

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("OCMPS_TRUNC_ORTH", "gram")


def main():
    chi = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    L, d, npart, J, T, tstep = 20, 7, 20, 1.0, 5.0, 5e-3
    cp = 64

    import jax
    import jax.numpy as jnp
    import numpy as np

    from optimalcontrolmps import mps as mpslib
    from optimalcontrolmps import seeds, tebd, vidal
    from optimalcontrolmps.drivers.prep_states import (
        ensure_boundary_states)
    from optimalcontrolmps.ops import complex_io as cio
    from optimalcontrolmps.profiling import enable_compile_cache
    enable_compile_cache()

    n = int(T / tstep + 1)
    u = np.asarray(seeds.adiabatic_seed(2.5, 50.0, n))

    cache = os.path.join(REPO, ".state_cache",
                         f"L{L}d{d}n{npart}chi{cp}.npz")
    psi_i_h, psi_f_h = ensure_boundary_states(L, d, npart, J, 2.5, 50.0,
                                              cp, cache, chi_prep=cp)
    np_c = np.complex64

    # canonicalize at the PREP chi (cheap (8*cp, cp) SVDs) and zero-pad
    # the canonical form: padding a VidalState embeds the identical
    # state (zero Schmidt weight in the new directions) — from_mps at
    # the full run chi costs ~25 min/state on this host's reference
    # BLAS for nothing
    def to_padded_vidal(A_h):
        v = vidal.from_mps(np.asarray(A_h).astype(np_c))
        c0 = v.B.shape[1]
        B = np.zeros((L, chi, d + 1, chi), np_c)
        B[:, :c0, :, :c0] = v.B
        lam = np.zeros((L - 1, chi))
        lam[:, :c0] = v.lam
        return vidal.to_matrix_carriers(
            vidal.VidalState(B=B, lam=lam.astype(np_c)))

    vi = to_padded_vidal(psi_i_h)
    vf = to_padded_vidal(psi_f_h)
    st = tebd.make_stepper(L, d, J, tstep, chi, dtype=jnp.complex64,
                           sweep="vidal", trunc_method="nssub")

    put = lambda t: jax.tree_util.tree_map(cio.put, t)
    vi_d, vf_d = put(vi), put(vf)

    gfn = jax.jit(lambda p0, pt, uu: vidal.gradient_segmented(
        st, p0, pt, uu, 0.0)[0])
    print(f"chi={chi} n={n} backend={jax.devices()[0].platform}; "
          "compiling+running gradient...", flush=True)
    t0 = time.time()
    g = np.asarray(gfn(vi_d, vf_d, jnp.asarray(u, jnp.float32)))
    wall = time.time() - t0
    t0 = time.time()
    g2 = np.asarray(gfn(vi_d, vf_d, jnp.asarray(u * 1.000001,
                                                jnp.float32)))
    steady = time.time() - t0
    out = os.path.join(REPO, "artifacts", "abd",
                       f"GradientT{T:.1f}maxM{chi}.txt")
    rows = np.column_stack([np.arange(n) * tstep, u, g])
    with open(out, "w") as fh:
        for r in rows:
            fh.write("\t".join(f"{v:.10g}" for v in r) + "\t\n")
    print(f"chi={chi} gradient: wall {wall:.1f}s (incl compile), steady "
          f"{steady:.1f}s; finite={np.isfinite(g).all()}, "
          f"|g|_max={np.abs(g).max():.4e}, |g|_rms="
          f"{np.sqrt(np.mean(g*g)):.4e} -> {out}", flush=True)


if __name__ == "__main__":
    main()
