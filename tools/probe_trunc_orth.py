"""A/B probe: orthonormalization policy inside the vidal bond update.

Times the vidal rollout (L=20, d=7 scaled-lattice config) on the device
for each OCMPS_TRUNC_ORTH policy and checks state accuracy against an f64
CPU golden (vidal with exact eigh truncation). Accuracy = |<golden|psi>|^2
of the final state plus the norm drift.

Usage: python tools/probe_trunc_orth.py [L] [chi] [B] [steps] [variants]
       variants: comma list of mgs,ns,ns+mgs (default all)
Phase "golden" (internal): compute the CPU f64 reference state.
"""

import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GOLD = "/tmp/trunc_orth_golden_{L}_{chi}_{steps}.npz"


def build(L, chi, steps):
    d = 7
    p = d + 1
    occ = [1] * L
    u = np.linspace(30.0, 2.0, steps + 1)
    return d, p, occ, u


def golden(L, chi, steps):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from optimalcontrolmps import mps, tebd, vidal

    d, p, occ, u = build(L, chi, steps)
    A0 = mps.product_state(occ, p, chi, dtype=np.complex128)
    lam0 = np.zeros((L - 1, chi)); lam0[:, 0] = 1.0
    st = tebd.make_stepper(L, d, 1.0, 5e-3, chi, dtype=jnp.complex128,
                           trunc_method="eigh", sweep="vidal")
    s = vidal.VidalState(B=jnp.asarray(A0), lam=jnp.asarray(lam0))
    step = jax.jit(lambda s, a, b: vidal.vidal_step(st, s, a, b, True))
    for i in range(steps):
        s = step(s, u[i], u[i + 1])
    np.savez(GOLD.format(L=L, chi=chi, steps=steps), B=np.asarray(s.B))
    print("golden written", flush=True)


def main():
    L = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    chi = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    B = int(sys.argv[3]) if len(sys.argv) > 3 else 8
    steps = int(sys.argv[4]) if len(sys.argv) > 4 else 30
    variants = (sys.argv[5].split(",") if len(sys.argv) > 5
                else ["mgs", "ns", "ns+mgs"])

    gold_path = GOLD.format(L=L, chi=chi, steps=steps)
    if not os.path.exists(gold_path):
        env = dict(os.environ)
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "GOLDEN", str(L), str(chi), str(steps)],
                       check=True, env=env)

    import jax
    import jax.numpy as jnp
    from optimalcontrolmps import mps, tebd, vidal
    from optimalcontrolmps.ops import complex_io as cio
    from optimalcontrolmps.profiling import enable_compile_cache

    enable_compile_cache()
    gold = np.load(gold_path)["B"]
    d, p, occ, u = build(L, chi, steps)
    A0 = mps.product_state(occ, p, chi, dtype=np.complex64)
    lam0 = np.zeros((L - 1, chi, chi), np.complex64)
    lam0[:, 0, 0] = 1.0
    st = tebd.make_stepper(L, d, 1.0, 5e-3, chi, dtype=jnp.complex64,
                           trunc_method="nssub", sweep="vidal")
    uu = jnp.asarray(u.astype(np.float32))
    print(f"backend={jax.devices()[0].platform} L={L} chi={chi} B={B} "
          f"steps={steps}", flush=True)

    for var in variants:
        os.environ["OCMPS_TRUNC_ORTH"] = var

        def roll(A, lam, uu):
            s0 = vidal.VidalState(B=A, lam=lam)
            def body(s, pair):
                return vidal.vidal_step(st, s, pair[0], pair[1], True), None
            pairs = jnp.stack([uu[:-1], uu[1:]], axis=1)
            sT, _ = jax.lax.scan(body, s0, pairs)
            return sT.B

        fn = jax.jit(jax.vmap(roll, in_axes=(0, 0, None)))
        args = (cio.put(np.broadcast_to(A0, (B,) + A0.shape)),
                cio.put(np.broadcast_to(lam0, (B,) + lam0.shape)))
        t0 = time.time()
        out = cio.get(fn(*args, uu))
        compile_s = time.time() - t0
        reps = 3
        t0 = time.time()
        for k in range(reps):
            out = cio.get(fn(*args, uu + np.float32(1e-7 * k)))
        per = (time.time() - t0) / reps

        # accuracy vs f64 golden (host-side contraction)
        psi = out[0].astype(np.complex128)
        envm = np.tensordot(gold[0].conj(), psi[0], axes=[[0, 1], [0, 1]])
        for s_ in range(1, L):
            tmp = np.tensordot(envm, psi[s_], axes=[[1], [0]])
            envm = np.tensordot(gold[s_].conj(), tmp, axes=[[0, 1], [0, 1]])
        fid = abs(envm[0, 0]) ** 2
        nrm = mps_norm_host(psi)
        print(f"{var:7s} rollout={per:.3f}s ms/step={1e3*per/steps:8.2f} "
              f"compile={compile_s:.0f}s 1-F_vs_f64={1-fid/max(nrm,1e-30):.3e}"
              f" norm={nrm**0.5:.6f}", flush=True)


def mps_norm_host(A):
    L = A.shape[0]
    env = np.tensordot(A[0].conj(), A[0], axes=[[0, 1], [0, 1]])
    for s_ in range(1, L):
        tmp = np.tensordot(env, A[s_], axes=[[1], [0]])
        env = np.tensordot(A[s_].conj(), tmp, axes=[[0, 1], [0, 1]])
    return abs(env[0, 0])


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "GOLDEN":
        golden(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
    else:
        main()
