"""Fixed-rank bond truncation kernels.

Static-shape replacement for ITensor's adaptive-rank `denmatDecomp`
(/root/reference/src/BH_tDMRG.cpp:178,191,209). XLA needs static shapes, so we
always keep exactly `chi` singular vectors (padding with zeros when the true
rank is smaller). This keeps *at least* as much weight as the reference's
cutoff-based truncation whenever chi >= the reference's retained rank.

Three methods:
  * "eigh" (default): density-matrix decomposition — eigh of theta@theta^H
    (or theta^H@theta), mathematically identical to denmatDecomp. It runs
    as a batched LAPACK/cuSOLVER eigh.
  * "svd": jnp.linalg.svd; more accurate for tiny singular values at the
    cost of speed.
  * "rsvd": randomized subspace iteration on the density matrix — almost
    entirely matmuls plus one thin QR per iteration and one final
    (k, k) eigh. Exact whenever the true rank is <= chi (one iteration
    reproduces the range of a rank-deficient PSD matrix), and Schmidt
    spectra decay exponentially so a few power iterations on the *squared*
    singular values converge extremely fast. A candidate for large chi.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["split_truncate"]

_RSVD_ITERS = 3
_RSVD_OVERSAMPLE = 8


def _jitter(rho: jnp.ndarray) -> jnp.ndarray:
    """Add delta*mean(diag)*I to a PSD matrix. This leaves every
    eigenVECTOR (hence the kept subspace) exactly unchanged — it only
    shifts the spectrum — but makes zero-padded matrices numerically
    full-rank, which keeps QR/eigh kernels out of their rank-deficient
    corner cases (NaN sources in f32)."""
    m = rho.shape[0]
    delta = 1e-12 if rho.dtype in (jnp.complex128, jnp.float64) else 1e-6
    scale = jnp.real(jnp.trace(rho)) / m + 1e-30
    return rho + (delta * scale) * jnp.eye(m, dtype=rho.dtype)


def cholesky_orthonormalize(B: jnp.ndarray, eps_rel: float = 1e-6):
    """Matmul-only (CholeskyQR) orthonormalization of the columns of B.

    Q = B L^{-H} with L = chol(B^H B + eps I). The eps ridge keeps the
    factorization finite for rank-deficient B (zero-padded MPS ranks); the
    COLUMN SPAN of B is preserved exactly (L is invertible), which is all
    subspace iteration and gauge moves need. Runs as two matmuls + one
    small Cholesky + a triangular solve — no Householder iteration.
    Returns (Q, L) with B = Q L^H.
    """
    k = B.shape[1]
    G = B.conj().T @ B
    scale = jnp.real(jnp.trace(G)) / k + 1e-30
    Gr = G + (eps_rel * scale) * jnp.eye(k, dtype=B.dtype)
    Lc = jnp.linalg.cholesky(Gr)
    Q = jax.scipy.linalg.solve_triangular(
        Lc, B.conj().T, lower=True).conj().T
    return Q, Lc


def _fixed_gaussian(m: int, k: int, dtype):
    """Deterministic test matrix (static shapes -> constant-folded once)."""
    key = jax.random.PRNGKey(17)
    real = jnp.float64 if dtype == jnp.complex128 else jnp.float32
    g = jax.random.normal(key, (m, 2 * k), dtype=real)
    return (g[:, :k] + 1j * g[:, k:]).astype(dtype)


def _thin_qr_q(m: jnp.ndarray) -> jnp.ndarray:
    """Q factor of a thin QR through the linalg policy: Householder
    (LAPACK custom call) on CPU/GPU, scan-based MGS on backends without
    one (ops/matfree.py). Both span range(m) exactly."""
    from .matfree import mgs_orthonormalize, use_matfree
    if use_matfree():
        return mgs_orthonormalize(m)
    return jnp.linalg.qr(m)[0]


def _top_eigenspace_rsvd(rho: jnp.ndarray, chi: int,
                         iters: int = _RSVD_ITERS):
    """Orthonormal basis of (approximately) the top-chi eigenspace of a
    PSD matrix via subspace iteration. Matmul-only except the final small
    (k, k) Rayleigh-Ritz eigh."""
    m = rho.shape[0]
    k = min(m, chi + _RSVD_OVERSAMPLE)
    q = _fixed_gaussian(m, k, rho.dtype)
    # NOTE: Householder QR here, not CholeskyQR: power iterations on rho
    # square the spectrum, so the iterate's Gram matrix has cond(rho)^4 —
    # a ridge-regularized Cholesky then wipes out mid-spectrum Schmidt
    # components (measured 2.6e-2 state error vs 2.7e-13 with QR)
    for _ in range(iters):
        q = _thin_qr_q(rho @ q)
    # Rayleigh-Ritz: small (k, k) eigh orders the basis by eigenvalue
    small = q.conj().T @ (rho @ q)
    small = 0.5 * (small + small.conj().T)
    w, v = jnp.linalg.eigh(small)
    u = q @ v[:, ::-1][:, :chi]
    return u  # (m, chi)


def _eigh_desc(rho: jnp.ndarray, chi: int):
    """Top-`chi` eigenpairs of Hermitian rho, descending order."""
    w, v = jnp.linalg.eigh(rho)  # ascending
    w = w[..., ::-1][..., :chi]
    v = v[..., ::-1][..., :chi]
    return w, v


def split_truncate(theta: jnp.ndarray, chi: int, keep_left: bool,
                   method: str = "eigh"):
    """Split matrix theta (m, n) into (left, right) with inner rank chi.

    keep_left=True  (reference `Fromleft`,  src/BH_tDMRG.cpp:178):
        left is an isometry (left-canonical), right carries the center.
    keep_left=False (reference `Fromright`, src/BH_tDMRG.cpp:191):
        right is an isometry (right-canonical), left carries the center.

    Requires m >= chi and n >= chi (guaranteed by padded MPS shapes).
    Returns (left (m, chi), right (chi, n)) with theta ~= left @ right.
    """
    if method.startswith("rsvd") and method != "rsvd":
        # "rsvdK": K subspace iterations. One iteration is exact whenever
        # rank(theta) <= chi (range of a rank-deficient PSD matrix is
        # recovered in a single application); extra iterations only matter
        # when the Schmidt spectrum is genuinely truncated at chi.
        iters = int(method[4:])
        method = "rsvd"
    else:
        iters = _RSVD_ITERS
    if method == "eigh":
        if keep_left:
            rho = _jitter(theta @ theta.conj().T)  # (m, m)
            _, u = _eigh_desc(rho, chi)  # (m, chi) isometry
            return u, u.conj().T @ theta
        else:
            rho = _jitter(theta.conj().T @ theta)  # (n, n)
            _, v = _eigh_desc(rho, chi)  # (n, chi) isometry
            return theta @ v, v.conj().T
    elif method == "rsvd":
        if keep_left:
            rho = _jitter(theta @ theta.conj().T)
            u = _top_eigenspace_rsvd(rho, chi, iters)
            return u, u.conj().T @ theta
        else:
            rho = _jitter(theta.conj().T @ theta)
            v = _top_eigenspace_rsvd(rho, chi, iters)
            return theta @ v, v.conj().T
    elif method == "nssub":
        # Matmul-only truncation (no dense factorization, see
        # ops/matfree.py). The dominant chi-dim
        # eigenspace of the density matrix is found by subspace iteration
        # with Newton-Schulz orthonormalization; any orthonormal basis of
        # that subspace is a valid (optimal-weight) truncation — the
        # eigen-ORDERING inside the kept block is irrelevant.
        from .matfree import subspace_topk
        if keep_left:
            rho = _jitter(theta @ theta.conj().T)
            u = subspace_topk(rho, chi)
            return u, u.conj().T @ theta
        else:
            rho = _jitter(theta.conj().T @ theta)
            v = subspace_topk(rho, chi)
            return theta @ v, v.conj().T
    elif method == "range":
        # Exact-rank regime (rank(theta) <= chi): ANY orthonormal basis of
        # the range is an exact split — no eigen-ordering, no rho, no
        # Rayleigh-Ritz. One sketch matmul + one thin QR(m, chi). When
        # rank(theta) < chi, QR's tail columns are ARBITRARY orthonormal
        # fill: they project to ~zero rows in the co-factor (harmless for
        # this bond), but left un-zeroed they inflate the matrix rank of
        # the NEIGHBORING bond's theta past chi on the next stage — brick
        # mode has no canonical gauge to kill them, so real Schmidt weight
        # then competes with junk and gets projected out (measured 6e-3
        # overlap error over 10 steps). Masking directions whose co-factor
        # norm is ~0 restores rank(theta) == physical Schmidt rank <= chi
        # at every downstream split. For rank > chi this is a random-
        # projection truncation (suboptimal) — tebd.make_stepper
        # (sweep="brick") verifies the physical rank bound before allowing
        # it.
        eps = 1e-12 if theta.dtype in (jnp.complex128, jnp.float64) else 1e-5
        if keep_left:
            om = _fixed_gaussian(theta.shape[1], chi, theta.dtype)
            q = _thin_qr_q(theta @ om)
            right = q.conj().T @ theta
            rn = jnp.linalg.norm(right, axis=1)
            keep = (rn > eps * jnp.max(rn)).astype(q.dtype)
            return q * keep[None, :], right * keep[:, None]
        else:
            om = _fixed_gaussian(theta.shape[0], chi, theta.dtype)
            v = _thin_qr_q(theta.conj().T @ om.conj())
            left = theta @ v
            ln = jnp.linalg.norm(left, axis=0)
            keep = (ln > eps * jnp.max(ln)).astype(v.dtype)
            return left * keep[None, :], v.conj().T * keep[:, None]
    elif method == "svd":
        u, s, vh = jnp.linalg.svd(theta, full_matrices=False)
        u = u[:, :chi]
        s = s[:chi].astype(theta.dtype)
        vh = vh[:chi, :]
        if keep_left:
            return u, s[:, None] * vh
        else:
            return u * s[None, :], vh
    raise ValueError(f"Unknown truncation method {method!r}")
