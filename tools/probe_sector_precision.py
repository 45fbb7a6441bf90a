"""Matmul-precision A/B for the SECTOR chain: speed + accuracy per policy.

The MPS path needs f32-highest (bf16 passes accumulate ~1e-2 over ~1600
chained bond ops — ops/precision.py). The sector chain is different
arithmetic: ~400 unitary (128,128) GEMMs, no factorizations. If a lower
precision ("high", "default") already sits at the f32 noise floor there,
the flagship bench GEMMs get cheaper.

Per policy in {highest, high, default}: timed vmapped gradient_lowmem at
batch B (scalar-in/scalar-out), plus J at the probe_trunc control
(golden J=0.1292463977, c128 CPU).

Usage: python tools/probe_sector_precision.py [batch] [reps]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GOLDEN_J = 0.1292463977  # tools/probe_trunc.py c128 golden, seed 3


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    import jax
    import jax.numpy as jnp
    from optimalcontrolmps import sector
    from optimalcontrolmps.engine import regularization
    from optimalcontrolmps.ops import precision
    import __graft_entry__ as ge

    print(f"backend={jax.devices()[0].platform} B={B}", flush=True)

    st, psi_i, psi_f, basis = ge._flagship_sector()
    gamma = 1e-6

    def forward(c):
        u = basis.convert_control(c)
        g_u, (_, _, _, ov) = sector.gradient_lowmem(st, psi_i, psi_f, u,
                                                    gamma)
        fid = (ov * ov.conj()).real
        J = 0.5 * (1.0 - fid) + regularization(u, gamma, st.dt)
        return J, basis.convert_gradient(g_u)

    rng = np.random.default_rng(0)
    cs0 = rng.uniform(-0.05, 0.05, size=(B, 10)).astype(np.float32)
    c_acc = np.random.default_rng(3).uniform(-0.5, 0.5, size=10) \
        .astype(np.float32)

    for policy in ("highest", "high", "default"):
        precision.set_policy(policy)

        # fresh closures per policy -> separate jit caches
        def batched(eps, _f=forward):
            J, g = jax.vmap(_f)(cs0 + eps)
            return jnp.sum(J) + jnp.sum(jnp.abs(g))

        bj = jax.jit(batched)
        sj = jax.jit(lambda c, _f=forward: _f(c)[0])

        t0 = time.time()
        float(np.asarray(bj(np.float32(0.0))))
        compile_s = time.time() - t0
        t0 = time.time()
        for k in range(reps):
            out = float(np.asarray(bj(np.float32(1e-4 * (k + 1)))))
        dt = (time.time() - t0) / reps
        J1 = float(np.asarray(sj(c_acc)))
        print(f"{policy:8s} time/batch={dt * 1e3:8.1f}ms "
              f"evals/s={B / dt:9.0f} compile={compile_s:4.0f}s "
              f"dJ_vs_golden={abs(J1 - GOLDEN_J):.3e} out={out:.4f}",
              flush=True)

    precision.set_policy(None)


if __name__ == "__main__":
    main()
