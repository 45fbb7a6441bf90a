"""Decompose the MPS brick-step cost on the device + probe QR alternatives.

Flagship MPS shapes: L=5, p=5, chi=32; theta per bond = (chi*p, p*chi)
= (160, 160); range split sketches to (160, 32) then orthonormalizes.

Variants (400-step chain equivalents, batch B, scalar-in/out):
  contract  — bond contractions + gate only, no splits (flop floor)
  qr        — full brick step, Householder QR range split (shipped)
  cholqr    — CholeskyQR range split (matmul-only)
  eighwhite — Gram-eigh whitening range split (matmul + (32,32) eigh)
  svdsplit  — jnp.linalg.svd split (reference-accurate, for scale)

Accuracy: each variant reports the final overlap with the qr variant's
c128 CPU... (here: f32 self-consistency via state norm + overlap with
the eigh-truncation snake result is covered by tests; this probe only
times).

Usage: python tools/probe_mps_decomp.py [batch] [steps]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timeit(name, fn, steps, reps=3):
    t0 = time.time()
    out = float(np.asarray(fn(np.float32(0.0))))
    compile_s = time.time() - t0
    t0 = time.time()
    for k in range(reps):
        out = float(np.asarray(fn(np.float32(1e-4 * (k + 1)))))
    dt = (time.time() - t0) / reps
    print(f"{name:10s} time/batch={dt * 1e3:8.1f}ms "
          f"us/step={dt / steps * 1e6:7.1f} compile={compile_s:.0f}s "
          f"out={out:.6f}", flush=True)


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    STEPS = int(sys.argv[2]) if len(sys.argv) > 2 else 400
    import jax
    import jax.numpy as jnp
    from optimalcontrolmps import groundstate, tebd

    L, d, npart, chi, dt = 5, 4, 5, 32, 0.01
    p = d + 1
    st = tebd.make_stepper(L, d, 1.0, dt, chi, dtype=jnp.complex64,
                           trunc_method="range", sweep="brick")
    psi0 = groundstate.initialize_state(L, d, npart, 1.0, 2.5, chi,
                                        dtype=jnp.complex64)
    gate = np.asarray(st.gate_fwd)
    nn1 = np.asarray(st.nn1)
    rng = np.random.default_rng(0)
    us0 = rng.uniform(2.0, 50.0, size=(STEPS, B)).astype(np.float32)

    gr = np.random.default_rng(17).normal(size=(p * chi, 2 * chi))
    OM = (gr[:, :chi] + 1j * gr[:, chi:]).astype(np.complex64)

    def ortho(S, how):
        # S: (m, chi) sketch; return orthonormal(ish) basis of range(S)
        if how == "qr":
            q, _ = jnp.linalg.qr(S)
            return q
        if how == "cholqr":
            G = S.conj().T @ S
            k = G.shape[0]
            scale = jnp.real(jnp.trace(G)) / k + 1e-30
            Lc = jnp.linalg.cholesky(G + (1e-6 * scale)
                                     * jnp.eye(k, dtype=S.dtype))
            return jax.scipy.linalg.solve_triangular(
                Lc, S.conj().T, lower=True).conj().T
        if how == "eighwhite":
            G = S.conj().T @ S
            G = 0.5 * (G + G.conj().T)
            w, V = jnp.linalg.eigh(G)
            scale = jnp.max(w) + 1e-30
            inv = jnp.where(w > 1e-10 * scale, 1.0 / jnp.sqrt(
                jnp.maximum(w, 1e-30)), 0.0)
            return (S @ V) * inv[None, :].astype(S.dtype)
        raise ValueError(how)

    def make_chain(split):
        def apply_bond(Ai, Aj, u):
            l = Ai.shape[0]
            r = Aj.shape[2]
            theta = jnp.einsum('apb,bqc->apqc', Ai, Aj).reshape(
                l, p * p, r)
            theta = jnp.einsum('PQ,aQc->aPc', gate, theta).reshape(
                l * p, p * r)
            if split == "contract":
                # fake split: reshape-only (keeps shapes; wrong math, flop floor)
                left = theta[:, :chi]
                right = theta[:chi, :]
            elif split == "svd":
                uu, s, vh = jnp.linalg.svd(theta, full_matrices=False)
                left = uu[:, :chi]
                right = (s[:chi, None].astype(theta.dtype) * vh[:chi, :])
            else:
                S = theta @ OM[:theta.shape[1], :chi]
                q = ortho(S, split)
                left, right = q, q.conj().T @ theta
            return left.reshape(l, p, chi), right.reshape(chi, p, r)

        def step(A, u):
            with jax.default_matmul_precision("highest"):
                ph = jnp.exp(-0.25j * u * dt * nn1).astype(A.dtype)
                A = A * ph[None, None, :, None]
                T = [A[i] for i in range(L)]
                for b in (0, 2):
                    T[b], T[b + 1] = apply_bond(T[b], T[b + 1], u)
                for b in (1, 3):
                    T[b], T[b + 1] = apply_bond(T[b], T[b + 1], u)
                A = jnp.stack(T) * ph[None, None, :, None]
                # norm via site-0 proxy (cheap stand-in)
                nr = jnp.linalg.norm(A[0])
                return A.at[0].multiply(
                    (1.0 / (nr + 1e-30)).astype(A.dtype))

        def chain(eps):
            A0 = jnp.asarray(psi0)

            def body(A, u):
                return jax.vmap(step, in_axes=(0, 0))(A, u), None

            Ab = jnp.broadcast_to(A0, (B,) + A0.shape) \
                * (1.0 + 0.0 * eps)
            A, _ = jax.lax.scan(body, Ab, us0 + eps)
            return jnp.sum(jnp.abs(A[:, 0, 0, :, 0]))

        return jax.jit(chain)

    print(f"backend={jax.devices()[0].platform} B={B} steps={STEPS}",
          flush=True)
    for split in ("contract", "qr", "cholqr", "eighwhite", "svd"):
        timeit(split, make_chain(split), STEPS)


if __name__ == "__main__":
    main()
