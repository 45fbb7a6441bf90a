"""Runtime benchmark harness — rebuild of main/TestRuntimes.cpp.

The reference times cost+gradient and exact-Hessian evaluations for
T in {1,2,3} at thread counts {1,2,4,8} (N=5 sites, d=5, chi<=40,
TestRuntimes.cpp:27-42). Threads do not exist in the rebuild; the analogous
scaling axis is the vmapped BATCH size, so the tables report wall time per
evaluation at batch in {1,2,4,8} plus the cost-consistency check.

    python -m optimalcontrolmps.drivers.test_runtimes
"""

from __future__ import annotations

import sys
import time

import numpy as np

from .. import engine, tebd, groundstate, seeds
from ..config import InputGroup
from .common import (J_HOP, U_INITIAL, U_FINAL, effective_chi,
                     setup_precision)


def run(horizons=(1.0, 2.0, 3.0), batches=(1, 2, 4, 8), dtype=None,
        with_hessian=True) -> dict:
    import jax
    import jax.numpy as jnp

    # the reference's precision (double) unless the caller passes a dtype
    prec = setup_precision(InputGroup("input"))
    if dtype is None:
        dtype = jnp.complex128 if prec == "double" else jnp.complex64
    real = np.float64 if np.dtype(dtype) == np.complex128 else np.float32

    # TestRuntimes.cpp:33-42: N=5, Npart=5, d=5, tstep=1e-2, maxM=40
    L, npart, d, tstep, maxm = 5, 5, 5, 1e-2, 40
    chi = effective_chi(maxm, L, d + 1)
    st = tebd.make_stepper(L, d, J_HOP, tstep, chi, dtype=dtype)
    psi_i = groundstate.initialize_state(L, d, npart, J_HOP, U_INITIAL, chi,
                                         dtype=dtype)
    psi_f = groundstate.initialize_state(L, d, npart, J_HOP, U_FINAL, chi,
                                         dtype=dtype)

    grad_rows, hess_rows, costs = [], [], {}
    for T in horizons:
        n = int(T / tstep + 1)
        u = np.asarray(seeds.adiabatic_seed(U_INITIAL, U_FINAL, n),
                       dtype=real)

        def cg(uu):
            g, (_, _, _, ov) = engine.gradient(st, psi_i, psi_f, uu, 0.0)
            fid = (ov * ov.conj()).real
            return 0.5 * (1.0 - fid), g

        row_g, row_h = [T], [T]
        for B in batches:
            us = np.broadcast_to(u, (B, n)).copy()
            f = jax.jit(jax.vmap(cg))
            out = f(us)
            jax.block_until_ready(out)  # compile
            t0 = time.time()
            out = f(us)
            jax.block_until_ready(out)
            per_eval = (time.time() - t0) / B
            row_g.append(per_eval)
            costs[T] = float(np.asarray(out[0])[0])

            if with_hessian:
                fh = jax.jit(jax.vmap(
                    lambda uu: engine.hessian(st, psi_i, psi_f, uu, 0.0)))
                H = fh(us)
                jax.block_until_ready(H)
                t0 = time.time()
                H = fh(us)
                jax.block_until_ready(H)
                row_h.append((time.time() - t0) / B)
        grad_rows.append(row_g)
        hess_rows.append(row_h)

    def table(title, rows):
        print(f"\n=== {title} (seconds per evaluation) ===")
        print("T\t" + "\t".join(f"batch={b}" for b in batches))
        for r in rows:
            print("\t".join(f"{v:.4g}" for v in r))

    table("Cost+gradient wall time", grad_rows)
    if with_hessian:
        table("Exact Hessian wall time", hess_rows)

    print("\n=== Cost consistency (same value at all batch sizes) ===")
    for T, c in costs.items():
        print(f"T={T}: cost = {c:.10f}")
    return {"grad": grad_rows, "hess": hess_rows, "costs": costs}


def main(argv=None):
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
