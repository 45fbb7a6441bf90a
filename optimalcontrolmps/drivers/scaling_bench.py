"""Multi-device scaling-efficiency harness.

The multi-chip analogue of the reference's TestRuntimes thread sweep
(/root/reference/main/TestRuntimes.cpp:27-42 times 1/2/4/8 threads; this
times 1/2/4/8 devices): runs the sharded multistart train step
(parallel/multistart.make_train_step) on growing sub-meshes with the
PER-DEVICE batch held fixed (weak scaling), and reports throughput and
parallel efficiency. XLA inserts all collectives (best-of-batch
argmin, Hessian-row psums); perfect DP weak scaling = efficiency 1.0.

On a CPU host, set XLA_FLAGS=--xla_force_host_platform_device_count=8 (or
run under pytest's conftest) to get 8 virtual devices; on a GPU host the
real cards are used.

    python -m optimalcontrolmps.drivers.scaling_bench [per_device_batch]
"""

from __future__ import annotations

import sys
import time

import numpy as np


def run(per_device_batch: int = 64, device_counts=None, T: float = 0.1,
        L: int = 3, d: int = 2, npart: int = 3, chi: int = 6, M: int = 4,
        with_hessian: bool = False, steps: int = 3) -> dict:
    import jax
    import jax.numpy as jnp

    from .. import control, groundstate, seeds, tebd
    from ..config import InputGroup
    from ..parallel import make_mesh
    from .common import setup_precision
    from ..parallel.multistart import make_train_step

    devs = jax.devices()
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8) if n <= len(devs)]

    dt = 0.01
    N = int(round(T / dt)) + 1
    # the reference's precision (double)
    prec = setup_precision(InputGroup("input"))
    dtype = jnp.complex128 if prec == "double" else jnp.complex64
    real = np.float32 if dtype == jnp.complex64 else np.float64
    st = tebd.make_stepper(L, d, 1.0, dt, chi, dtype=dtype)
    psi_i = groundstate.initialize_state(L, d, npart, 1.0, 2.5, chi,
                                         dtype=dtype)
    psi_f = groundstate.initialize_state(L, d, npart, 1.0, 50.0, chi,
                                         dtype=dtype)
    basis = control.chopped_sine_basis(
        seeds.adiabatic_seed(2.5, 50.0, N), dt, T, M,
        dtype=jnp.float64 if real == np.float64 else jnp.float32)

    rows = []
    base_rate = None
    for nd in device_counts:
        mesh = make_mesh(nd, devices=devs)
        step, sh = make_train_step(st, psi_i, psi_f, basis, gamma=1e-6,
                                   lr=10.0, mesh=mesh,
                                   with_hessian=with_hessian)
        B = per_device_batch * nd
        rng = np.random.default_rng(0)
        cs = jax.device_put(
            rng.normal(0.0, 0.1, (B, basis.M)).astype(real), sh)
        out = step(cs)
        jax.block_until_ready(out)  # compile
        t0 = time.time()
        for _ in range(steps):
            out = step(cs)
            jax.block_until_ready(out)
            cs = out[0]
        wall = (time.time() - t0) / steps
        rate = B / wall
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * nd)
        rows.append({"devices": nd, "batch": B, "time_per_step": wall,
                     "ramps_per_s": rate, "efficiency": eff})
        print(f"devices={nd:2d} batch={B:5d} step={wall * 1e3:8.1f}ms "
              f"ramps/s={rate:10.1f} weak-scaling eff={eff:6.3f}",
              flush=True)
    return {"rows": rows, "per_device_batch": per_device_batch}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    run(int(argv[0]) if argv else 64)
    return 0


if __name__ == "__main__":
    sys.exit(main())
