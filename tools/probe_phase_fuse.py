"""Probe: can the per-step control-phase multiply fuse into the GEMM?

The merged-phase sector chain is `q <- (q * ph) @ WT` per step, where
ph[b, s] = exp(c * u_b * nn1_s) takes only k ~ 6 distinct values per batch
row. The question is whether XLA fuses a gather-produced operand into the
matmul, or whether the (B, ns) elementwise pass costs a trip through
device memory of its own.

Variants (all one GEMM + one phase per step, scalar-in/scalar-out so host
transfers stay out of the measurement):
  gemm    — bare GEMM chain (lower bound)
  gather  — current: small (B,k) exp, gather columns via inv
  onehot  — small (B,k) exp, expand via (k,ns) 0/1 matmul: pure
            matmul+mul chain, maximally fusable
  repeat  — basis SORTED by nn1: phase is k contiguous constant blocks,
            built with jnp.repeat (static total length)
  blocks  — sorted basis, no (B,ns) phase at all: (q*ph)@WT as k
            column-block GEMMs, each scaled by the block's (B,1) phase

Usage: python tools/probe_phase_fuse.py [batch] [steps] [variants-csv]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timeit(name, fn, reps=5):
    t0 = time.time()
    out = float(np.asarray(fn(np.float32(0.0))))
    compile_s = time.time() - t0
    t0 = time.time()
    for k in range(reps):
        out = float(np.asarray(fn(np.float32(1e-4 * (k + 1)))))
    dt = (time.time() - t0) / reps
    print(f"{name:8s} time/batch={dt * 1e3:8.1f}ms compile={compile_s:5.0f}s "
          f"out={out:.4f}", flush=True)
    return dt


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 400
    import jax
    import jax.numpy as jnp
    from optimalcontrolmps import sector

    print(f"backend={jax.devices()[0].platform} B={B} steps={steps}",
          flush=True)

    st = sector.make_sector_stepper(5, 4, 5, 1.0, 0.01, dtype=jnp.complex64)
    WT = np.asarray(st.WJ_fwd_p).T.copy()
    ns = st.ns_p
    nn1 = np.asarray(st.nn1_p)
    vals, inv = np.unique(nn1, return_inverse=True)
    k = vals.size
    E = np.zeros((k, ns), dtype=np.float32)
    E[inv, np.arange(ns)] = 1.0

    # sorted-by-nn1 permutation of the padded basis
    perm = np.argsort(inv, kind="stable")
    WT_s = WT[perm][:, perm].copy()
    inv_s = inv[perm]
    counts = [int(np.sum(inv_s == j)) for j in range(k)]
    offs = np.concatenate([[0], np.cumsum(counts)])

    rng = np.random.default_rng(0)
    psi0 = rng.normal(size=(B, 2, ns)).astype(np.float32)
    us0 = rng.uniform(2.0, 50.0, size=(steps, B)).astype(np.float32)
    dt = 0.01

    def make(kind):
        @jax.jit
        def run(eps):
            p = (psi0[:, 0] + eps + 1j * psi0[:, 1]).astype(np.complex64)
            if kind in ("repeat", "blocks"):
                # sorted-basis variants evolve in the permuted basis; apply
                # the same permutation to the initial state (and un-permute
                # the readout below) so the printed out= value matches
                # gather/onehot and doubles as a correctness check
                # (ADVICE.md r2)
                p = p[:, perm]

            def body(q, u):
                with jax.default_matmul_precision("highest"):
                    small = jnp.exp(-0.25j * dt * u[:, None] * vals[None, :])
                    if kind == "gemm":
                        return q @ WT, None
                    if kind == "gather":
                        q = q * small[:, inv].astype(q.dtype)
                        return q @ WT, None
                    if kind == "onehot":
                        ph = small @ E.astype(small.dtype)
                        q = q * ph.astype(q.dtype)
                        return q @ WT, None
                    if kind == "repeat":
                        ph = jnp.repeat(small, np.asarray(counts), axis=1,
                                        total_repeat_length=ns)
                        q = q * ph.astype(q.dtype)
                        return q @ WT_s, None
                    if kind == "blocks":
                        acc = None
                        for j in range(k):
                            lo, hi = int(offs[j]), int(offs[j + 1])
                            part = (q[:, lo:hi] * small[:, j:j + 1]) \
                                @ WT_s[lo:hi]
                            acc = part if acc is None else acc + part
                        return acc, None
                    raise ValueError(kind)

            q, _ = jax.lax.scan(body, p, us0 + eps)
            col = int(np.argsort(perm)[0]) if kind in ("repeat", "blocks") \
                else 0
            return jnp.sum(jnp.abs(q[:, col]))

        return run

    kinds = (sys.argv[3].split(",") if len(sys.argv) > 3
             else ["gemm", "gather", "onehot", "repeat", "blocks"])
    for kind in kinds:
        timeit(kind, make(kind))


if __name__ == "__main__":
    main()
