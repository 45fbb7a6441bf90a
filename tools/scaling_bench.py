"""Weak-scaling study of the multistart solve on a virtual device mesh.

BASELINE.md's scale-out target is "4096 concurrent T=2.0 ramp
optimizations ... with >=80% multi-host scaling efficiency". Real
multi-chip hardware is not reachable from this environment, so this
harness measures the DP scaling behavior of the production unit — the
vmapped+sharded multistart L-BFGS solve (parallel/multistart.py) — on an
8-device virtual CPU mesh (xla_force_host_platform_device_count), the
same mechanism the driver's dryrun_multichip validates. Weak scaling:
per-device batch held fixed while devices grow 1 -> 8; efficiency =
t(1 dev) / t(n dev) (ideal = 1.0 since work per device is constant).

Usage: python tools/scaling_bench.py [per_dev_batch] [T] [max_iter]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np


def main():
    per_dev = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    T = float(sys.argv[2]) if len(sys.argv) > 2 else 2.0
    max_iter = int(sys.argv[3]) if len(sys.argv) > 3 else 60

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from optimalcontrolmps import control, sector, seeds
    from optimalcontrolmps.parallel import mesh as meshlib
    from optimalcontrolmps.parallel.multistart import multistart_lbfgs

    dt, M, L, d, npart, gamma = 0.01, 10, 5, 4, 5, 1e-6
    N = int(round(T / dt)) + 1
    st = sector.make_sector_stepper(L, d, npart, 1.0, dt,
                                    dtype=jnp.complex64)
    psi_i = sector.sector_ground_state(L, d, npart, 1.0, 2.5,
                                       dtype=np.complex64)
    psi_f = sector.sector_ground_state(L, d, npart, 1.0, 50.0,
                                       dtype=np.complex64)
    rng = np.random.default_rng(123456789)
    u0 = seeds.linsigmoid_seed(2.5, 50.0, N, rng=rng)
    basis = control.chopped_sine_basis(u0, dt, T, M, dtype=np.float32)

    ndev_all = [n for n in (1, 2, 4, 8) if n <= len(jax.devices())]
    print(f"devices={len(jax.devices())} per_dev_batch={per_dev} T={T} "
          f"max_iter={max_iter}", flush=True)
    t1 = None
    rows = []
    for ndev in ndev_all:
        B = per_dev * ndev
        msh = meshlib.make_mesh(ndev, rows=1)
        cs = rng.uniform(-0.05, 0.05, size=(B, M)).astype(np.float32)

        def run():
            return multistart_lbfgs(st, psi_i, psi_f, basis, cs,
                                    gamma=gamma, max_iter=max_iter,
                                    tol=1e-5, mesh=msh, exact=True)

        t0 = time.time()
        res = run()
        res.best_cost.block_until_ready()
        compile_s = time.time() - t0
        t0 = time.time()
        res = run()
        res.best_cost.block_until_ready()
        wall = time.time() - t0
        if t1 is None:
            t1 = wall
        eff = t1 / wall
        rows.append((ndev, B, wall, B / wall, eff,
                     float(res.best_cost)))
        print(f"ndev={ndev} B={B:4d} wall={wall:7.2f}s "
              f"solves/s={B / wall:8.2f} weak_eff={eff:5.2f} "
              f"best_cost={float(res.best_cost):.6e} "
              f"compile={compile_s:.0f}s", flush=True)

    print("\n| devices | batch | wall (s) | solves/s | weak efficiency |")
    print("|---|---|---|---|---|")
    for ndev, B, wall, rate, eff, _ in rows:
        print(f"| {ndev} | {B} | {wall:.2f} | {rate:.2f} | {eff:.2f} |")


if __name__ == "__main__":
    main()
