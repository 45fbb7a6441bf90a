"""Wall-clock the exact Hessian on the truncating long-chain path.

BASELINE configs[3] asks for the scaled lattice (L=20, chi=200, T=6.0,
GROUP, exact Hessian). The Hessian costs N_t^2 row-propagation steps
through the snake-sweep twin (vidal.hessian), so this probe measures a
reduced horizon and reports the per-row-step cost from which any horizon
extrapolates quadratically. Ground states come from the JAX DMRG on the
host CPU (subprocess-free: prepared in f64 numpy before the device program).

Usage: python tools/probe_hessian_scaled.py [L] [chi] [T] [dt] [M]
"""

import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def prep_main(L, d, npart, J, chi, path):
    """CPU-subprocess ground-state prep (DMRG needs LAPACK)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from optimalcontrolmps.groundstate import initialize_state
    psi_i = np.asarray(initialize_state(L, d, npart, J, 2.5, chi))
    psi_f = np.asarray(initialize_state(L, d, npart, J, 50.0, chi))
    np.savez(path, psi_i=psi_i, psi_f=psi_f)
    print("states written", flush=True)


def main():
    L = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    chi = int(sys.argv[2]) if len(sys.argv) > 2 else 32
    T = float(sys.argv[3]) if len(sys.argv) > 3 else 0.3
    dt = float(sys.argv[4]) if len(sys.argv) > 4 else 0.01
    M = int(sys.argv[5]) if len(sys.argv) > 5 else 8
    d, npart, J, gamma = 7, L, 1.0, 1e-6
    N = int(round(T / dt)) + 1

    import jax
    import jax.numpy as jnp
    from optimalcontrolmps import control, seeds, tebd, vidal
    from optimalcontrolmps.profiling import enable_compile_cache

    enable_compile_cache()
    os.environ.setdefault("OCMPS_TRUNC_ORTH", "gram")

    backend = jax.devices()[0].platform
    print(f"backend={backend} L={L} d={d} chi={chi} T={T} dt={dt} "
          f"N_t={N} M={M}", flush=True)

    # ground states: CPU-subprocess prep, cached by config
    cache = f"/tmp/hess_states_{L}_{d}_{chi}.npz"
    if not os.path.exists(cache):
        t0 = time.time()
        subprocess.run([sys.executable, os.path.abspath(__file__), "PREP",
                        str(L), str(d), str(npart), str(J), str(chi),
                        cache], check=True)
        print(f"state prep {time.time() - t0:.1f}s", flush=True)
    dat = np.load(cache)
    psi_i, psi_f = dat["psi_i"], dat["psi_f"]

    v_i = vidal.to_matrix_carriers(vidal.from_mps(psi_i.astype(np.complex64)))
    v_f = vidal.to_matrix_carriers(vidal.from_mps(psi_f.astype(np.complex64)))

    u0 = seeds.adiabatic_seed(2.5, 50.0, N)
    basis = control.chopped_sine_basis(u0, dt, T, M, dtype=np.float32)
    u = np.asarray(basis.convert_control(np.zeros(M, np.float32)))

    st = tebd.make_stepper(L, d, J, dt, chi, dtype=jnp.complex64,
                           trunc_method="nssub", sweep="vidal")

    # gradient (vidal channel) first — also produces the aux trajectories;
    # every timing below forces np.asarray of a scalar-ish result.
    grad_fn = jax.jit(lambda u: vidal.gradient(st, v_i, v_f, u, gamma))
    t0 = time.time()
    g, aux = grad_fn(u)
    _ = np.asarray(g)
    print(f"gradient: compile+run {time.time() - t0:.1f}s", flush=True)
    t0 = time.time()
    g, aux = grad_fn(u + np.float32(1e-6))
    _ = np.asarray(g)
    t_grad = time.time() - t0
    print(f"gradient steady {t_grad:.2f}s  |g|max={float(jnp.max(jnp.abs(g))):.3e}",
          flush=True)

    hess_fn = jax.jit(lambda u: vidal.hessian(st, v_i, v_f, u, gamma))
    t0 = time.time()
    Hm = np.asarray(hess_fn(u))
    print(f"hessian: compile+run {time.time() - t0:.1f}s", flush=True)
    t0 = time.time()
    Hm = np.asarray(hess_fn(u + np.float32(1e-6)))
    t_hess = time.time() - t0
    sym = np.max(np.abs(Hm - Hm.T)) / max(np.max(np.abs(Hm)), 1e-30)
    row_steps = N * N  # the batched formulation steps every row each j
    print(f"hessian steady {t_hess:.2f}s  ({1e3 * t_hess / row_steps:.2f} "
          f"ms/row-step, {row_steps} row-steps)  sym_resid={sym:.2e} "
          f"finite={np.isfinite(Hm).all()}", flush=True)
    # quadratic extrapolation to the full BASELINE horizon
    for Tx, dtx in ((2.0, 0.01), (6.0, 0.01), (6.0, 5e-3)):
        Nx = int(round(Tx / dtx)) + 1
        est = t_hess * (Nx / N) ** 2
        print(f"  extrapolated T={Tx} dt={dtx} (N_t={Nx}): "
              f"~{est:.0f}s per exact Hessian", flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "PREP":
        prep_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                  float(sys.argv[5]), int(sys.argv[6]), sys.argv[7])
    else:
        main()
