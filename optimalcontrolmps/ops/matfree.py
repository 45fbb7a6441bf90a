"""Matmul-only dense linear algebra (no LAPACK custom calls).

Factorization-shaped primitives built from matrix multiplication and
cheap scalar recurrences, for a backend without dense factorizations
(eigh, qr, svd, cholesky, lu/solve). On CPU and GPU the LAPACK/cuSOLVER
routes are the default; these kernels run only when a config asks for
them (truncMethod nssub, OCMPS_LINALG=matfree):

* `ns_orthonormalize` — Newton-Schulz polar iteration: the unitary polar
  factor of a panel, i.e. an orthonormal basis aligned with its range.
  Pure (m,k)x(k,k) matmuls; cubic convergence once singular values are
  O(1); zero singular directions stay exactly zero (a partial isometry —
  better behaved than QR's arbitrary fill on rank-deficient panels).
* `ns_sqrt` — coupled inverse-free Newton-Schulz iteration for the
  principal square root of a Hermitian PSD matrix.
* `subspace_topk` — orthonormal basis of (approximately) the dominant
  k-dimensional eigenspace of a PSD matrix: power iterations +
  Newton-Schulz orthonormalization. The basis is NOT eigen-ordered —
  truncation only needs the subspace, never the ordering.
* `power_eig_max` — dominant eigenvalue of a PSD matrix.
* `chol_solve` — scan-based Cholesky + forward/back substitution for the
  small SPD systems of the interior-point KKT step (M ~ 10-60). Row
  recurrences compile to supported ops on every backend.

All functions are jit/vmap-safe with static iteration counts.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["ns_orthonormalize", "ns_sqrt", "ns_sqrt_inv",
           "gram_orthonormalize", "subspace_topk",
           "power_eig_max", "chol_solve", "use_matfree", "solve_spd",
           "min_eig", "trunc_orth_policy"]


def use_matfree() -> bool:
    """Policy: route small dense solves through the matmul-only kernels?

    OCMPS_LINALG = "matfree" selects the matmul-only kernels; anything
    else ("auto", the default, or "lapack") uses the LAPACK/cuSOLVER
    custom calls. Read per call, at trace time."""
    import os
    return os.environ.get("OCMPS_LINALG", "auto") == "matfree"


def solve_spd(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """SPD solve through the policy: LAPACK lu-solve or scan-Cholesky."""
    if use_matfree():
        return chol_solve(A, b)
    return jnp.linalg.solve(A, b)


def min_eig(H: jnp.ndarray) -> jnp.ndarray:
    """Smallest eigenvalue of a Hermitian matrix through the policy.

    Matmul-only route: lambda_min(H) = c - lambda_max(c I - H) with c the
    Gershgorin upper bound (c I - H is PSD by construction)."""
    if not use_matfree():
        return jnp.linalg.eigvalsh(H)[0]
    c = jnp.max(jnp.diagonal(H).real
                + jnp.sum(jnp.abs(H), axis=1) - jnp.abs(jnp.diagonal(H)))
    n = H.shape[0]
    S = c * jnp.eye(n, dtype=H.dtype) - H
    return c - power_eig_max(S)


def ns_orthonormalize(X: jnp.ndarray, iters: int = 24) -> jnp.ndarray:
    """Orthonormal basis aligned with the range of X (m >= k columns).

    Newton-Schulz polar iteration Y <- 1.5 Y - 0.5 Y (Y^H Y), seeded with
    Y = X/||X||_F (so every singular value is in [0, 1]). Singular values
    flow to 1 (or stay at exactly 0): the limit is the partial isometry of
    the polar decomposition. Directions with tiny singular weight converge
    slowly — after `iters` steps a direction starting at sigma carries
    min(1, 1.5^iters * sigma) of its unit weight; iters=24 resolves
    sigma >= ~6e-5 fully, which is far below any Schmidt weight worth
    keeping in f32.
    """
    nrm = jnp.sqrt(jnp.sum((X * X.conj()).real)) + 1e-30
    Y = X / nrm.astype(X.dtype)

    # fori_loop, not a Python loop: at chi >= 128 the unrolled 24-matmul
    # chain repeated across every bond/sweep/scan-body blows the HLO graph
    # up to hour-scale XLA compiles (round-4 chi=256: ~90 CPU-min
    # lowering); the rolled loop costs nothing at runtime (the matmuls
    # dominate; there is nothing to fuse across NS iterations).
    def _it(_, Y):
        G = Y.conj().T @ Y
        return 1.5 * Y - 0.5 * (Y @ G)

    return jax.lax.fori_loop(0, iters, _it, Y)


def ns_sqrt(S: jnp.ndarray, iters: int = 36) -> jnp.ndarray:
    """Principal square root of a Hermitian PSD matrix, matmul-only.

    Coupled inverse-free Newton-Schulz (Denman-Beavers variant): with
    A = S/c scaled so ||A|| <= 1, iterate
        Y <- 0.5 Y (3 I - Z Y),   Z <- 0.5 (3 I - Z Y) Z
    from Y = A, Z = I; then Y -> sqrt(A), Z -> A^{-1/2} on the support of
    S (zero eigenvalues stay zero). Returns sqrt(c) * Y.

    Tiny eigenvalues pass through a 1.5^k growth phase before quadratic
    convergence kicks in: after k iterations an eigenvalue a (relative to
    the trace scale) is resolved once a > 1.5^(-2k). iters=36 resolves
    relative Schmidt weights down to ~5e-7 — below that, the weight is
    numerically irrelevant even in f64 TEBD.
    """
    n = S.shape[-1]
    c = jnp.sum(jnp.abs(jnp.diagonal(S))) + 1e-30  # trace >= lambda_max
    A = S / c.astype(S.dtype)
    eye = jnp.eye(n, dtype=S.dtype)
    def _it(_, YZ):
        Y, Z = YZ
        T = 1.5 * eye - 0.5 * (Z @ Y)
        return Y @ T, T @ Z

    # rolled (see ns_orthonormalize: compile-size, not runtime)
    Y, _ = jax.lax.fori_loop(0, iters, _it, (A, eye))
    return Y * jnp.sqrt(c).astype(S.dtype)


def ns_sqrt_inv(G: jnp.ndarray, iters: int = 17, ridge: float = 1e-5):
    """(sqrt, inverse-sqrt, eps) of a Hermitian PSD matrix via coupled
    inverse-free Newton-Schulz, RIDGED for rank deficiency.

    The plain coupled iteration's Z -> A^{-1/2} factor grows as 1.5^k on
    the null space of a singular A and overflows f32 by ~iteration 25
    (measured on vidal bond carriers, 2026-08-20). The ridge
    eps = ridge * tr(G) bounds the spectrum away from zero: Z stays
    <= sqrt(c/eps) and the iteration is unconditionally f32-stable.
    `ridge` must DOMINATE the Gram formation noise — inner products of
    length-m f32 vectors carry ~sqrt(m) * eps_f32 * lambda_max ~ 1.4e-6
    relative error at m=512, which shows up as NEGATIVE near-null
    eigenvalues that a smaller ridge lets through to divergence
    (measured: ridge 1e-7 NaNs, 1e-5 is stable). The ridged minimum
    eigenvalue converges at 2.25x/iteration, so iters ~
    log(1/ridge)/log(2.25) + margin = 17 at ridge 1e-5. Eigenvalues >> eps are
    exact; ones at/below eps come out as ~sqrt(eps) (callers can deflate
    with the returned eps). Intended for SMALL (k, k) Gram matrices:
    k^3 work per iteration, so the whole call costs less than ONE of
    the (m, k) GEMMs it replaces."""
    n = G.shape[-1]
    tr = jnp.sum(jnp.abs(jnp.diagonal(G))) + 1e-30
    eps = ridge * tr                             # real
    eye = jnp.eye(n, dtype=G.dtype)
    c = tr * (1.0 + ridge)                       # >= lambda_max(G + eps I)
    A = (G + eps.astype(G.dtype) * eye) / c.astype(G.dtype)
    def _it(_, YZ):
        Y, Z = YZ
        T = 1.5 * eye - 0.5 * (Z @ Y)
        return Y @ T, T @ Z

    # rolled (see ns_orthonormalize: compile-size, not runtime)
    Y, Z = jax.lax.fori_loop(0, iters, _it, (A, eye))
    sc = jnp.sqrt(c).astype(G.dtype)
    return Y * sc, Z / sc, eps


def gram_orthonormalize(X: jnp.ndarray, iters: int = 17,
                        ridge: float = 1e-5, refine: bool = True
                        ) -> jnp.ndarray:
    """Orthonormalize the columns of X via its Gram matrix:
    Q = X (X^H X + eps I)^{-1/2}. TWO (m, k) GEMMs + one small-matrix NS
    loop per pass — the cheapest orthonormalization in GEMMs by an
    order of magnitude. Conditioning: forming the Gram squares
    kappa(X); the ridge softly shrinks directions with sigma^2 near eps
    (sigma/sqrt(sigma^2+eps), never amplifies). `refine=True` adds a
    CholeskyQR2-style second pass: the first pass's output has
    near-unit column scales, so its Gram is mildly conditioned and the
    second pass restores the ridge-shrunk weak columns to unit norm —
    two passes at ridge 1e-5 beat one pass at any smaller ridge, which
    f32 Gram noise (negative near-null eigenvalues ~1.4e-6 * lambda_max
    at m=512) makes divergent."""
    G = X.conj().T @ X
    _, P, _ = ns_sqrt_inv(G, iters=iters, ridge=ridge)
    Q = X @ P
    if refine:
        G2 = Q.conj().T @ Q
        _, P2, _ = ns_sqrt_inv(G2, iters=iters, ridge=ridge)
        Q = Q @ P2
    return Q


def mgs_orthonormalize(X: jnp.ndarray, rel_eps: float = None) -> jnp.ndarray:
    """Exact orthonormalization via modified Gram-Schmidt with
    reorthogonalization (CGS2), as a scan over columns — condition-number
    independent, unlike Newton-Schulz, at the cost of k sequential steps.
    Columns whose residual is below rel_eps * ||X||_F come out as exact
    zeros (partial isometry, matching ns_orthonormalize's semantics).
    Supported ops only: matvecs + elementwise."""
    m, k = X.shape
    if rel_eps is None:
        rel_eps = 1e-7 if X.dtype in (jnp.complex64, jnp.float32) else 1e-13
    scale = jnp.sqrt(jnp.sum((X * X.conj()).real)) + 1e-30

    def step(carry, xs):
        Q, j = carry
        col = xs
        # two projection passes (CGS2): rock-solid orthogonality
        v = col - Q @ (Q.conj().T @ col)
        v = v - Q @ (Q.conj().T @ v)
        n = jnp.sqrt(jnp.sum((v * v.conj()).real))
        q = jnp.where(n > rel_eps * scale, v / (n + 1e-30).astype(v.dtype),
                      jnp.zeros_like(v))
        Q = jax.lax.dynamic_update_slice(Q, q[:, None], (0, j))
        return (Q, j + 1), None

    Q0 = jnp.zeros_like(X)
    (Q, _), _ = jax.lax.scan(step, (Q0, 0), jnp.moveaxis(X, 1, 0))
    return Q


def _fixed_sketch(m: int, k: int, dtype):
    key = jax.random.PRNGKey(23)
    real = jnp.float64 if dtype == jnp.complex128 else jnp.float32
    g = jax.random.normal(key, (m, 2 * k), dtype=real)
    if jnp.issubdtype(dtype, jnp.complexfloating):
        return (g[:, :k] + 1j * g[:, k:]).astype(dtype)
    return g[:, :k].astype(dtype)


def trunc_orth_policy() -> str:
    """Orthonormalization policy for subspace_topk's power rounds.

    OCMPS_TRUNC_ORTH = "mgs" (default) | "ns" | "ns+mgs". Read at trace
    time, like use_matfree().

    * "mgs"    — exact CGS2 per round: condition-independent, the right
      choice for f64 CPU runs where golden tolerances are 1e-6..1e-11. It
      costs k SEQUENTIAL scan steps per round, which can dominate the
      whole bond update.
    * "ns"     — Newton-Schulz polar per round: pure batched GEMMs. Weak
      Schmidt directions below sigma_rel ~ 1e-4 lose weight — but in f32
      those directions are ALREADY below the Gram cancellation floor
      (forming rho = m^H m in f32 squares the spectrum: eps_f32 = 6e-8
      ~ (2.4e-4)^2), so on an f32 path "ns" discards only what f32
      arithmetic had destroyed anyway (tools/probe_trunc_orth.py compares
      the policies' state accuracy against the f64 CPU golden).
    * "ns+mgs" — NS in the power rounds, one exact MGS pass at the end.
    """
    import os
    return os.environ.get("OCMPS_TRUNC_ORTH", "mgs")


def subspace_topk(rho: jnp.ndarray, k: int, iters: int = 3,
                  oversample: int = 8, ns_iters: int = 12,
                  orth: str = None) -> jnp.ndarray:
    """(m, k) orthonormal basis of the dominant eigenspace of PSD rho.

    Power iterations, each re-orthonormalized (policy: `orth` arg or
    OCMPS_TRUNC_ORTH, see trunc_orth_policy): letting components decay
    multiplicatively across un-normalized power steps buries
    weak-but-kept directions below the cancellation floor (measured
    2.4e-4 state error at 3 raw powers in f64; exact-per-round MGS
    restores 1e-11). Exact in one power application when rank(rho) <= k
    (range recovery); for genuinely truncated spectra the subspace error
    decays as (lambda_{k+1}/lambda_k)^iters, improved by oversampling.
    The returned basis spans the subspace but is not eigen-ordered
    (callers never need ordering: all k directions are kept together).
    """
    if orth is None:
        orth = trunc_orth_policy()
    renorm = (mgs_orthonormalize if orth == "mgs"
              else partial(ns_orthonormalize, iters=24))
    m = rho.shape[0]
    kk = min(m, k + oversample)
    q = _fixed_sketch(m, kk, rho.dtype)
    # rolled loops (see ns_orthonormalize: compile-size, not runtime)
    q = jax.lax.fori_loop(0, iters, lambda _, qq: renorm(rho @ qq), q)
    if kk != k:
        # reduce the oversampled basis to the k dominant directions: power
        # selection on the small (kk, kk) compressed matrix. NO
        # gap-sharpening squaring here — squaring doubles the spectral
        # condition (Schmidt^4) and buries weak-but-kept directions below
        # the cancellation floor, the exact failure per-round
        # orthonormalization avoids. Mis-ordering within near-degenerate
        # Schmidt weight is harmless — such directions are interchangeable
        # for truncation.
        small = q.conj().T @ (rho @ q)
        small = 0.5 * (small + small.conj().T)
        v = _fixed_sketch(kk, k, rho.dtype)
        v = jax.lax.fori_loop(0, max(iters, 2),
                              lambda _, vv: renorm(small @ vv), v)
        q = q @ v
    if orth == "ns+mgs":
        q = mgs_orthonormalize(q)
    return q


def power_eig_max(H: jnp.ndarray, squarings: int = 6,
                  iters: int = 8) -> jnp.ndarray:
    """Dominant eigenvalue of a Hermitian PSD matrix, matmul-only.

    Repeated squaring sharpens the spectral gap ((l2/l1)^(2^squarings)),
    then a few power iterations on the sharpened matrix isolate the top
    eigenvector; the Rayleigh quotient is taken with the ORIGINAL matrix."""
    S = H / (jnp.max(jnp.abs(jnp.diagonal(H))) + 1e-30).astype(H.dtype)
    for _ in range(squarings):
        S = S @ S
        S = S / (jnp.max(jnp.abs(jnp.diagonal(S))) + 1e-30).astype(S.dtype)
    v = _fixed_sketch(H.shape[-1], 1, H.dtype)[:, 0]
    for _ in range(iters):
        w = S @ v
        v = w / (jnp.linalg.norm(w) + 1e-30).astype(w.dtype)
    return jnp.real(jnp.vdot(v, H @ v)) / jnp.real(jnp.vdot(v, v))


def _chol_factor(A: jnp.ndarray) -> jnp.ndarray:
    """Cholesky factor of an SPD matrix via the scan row recurrence
    (supported ops only — no LAPACK custom call). O(n^2) scan steps of
    O(n) work; meant for small KKT systems, not bulk tensor math."""
    n = A.shape[0]

    def row(L, i):
        # L holds rows < i finished, rest zero
        a_i = A[i]
        # compute column by column within the row using the recurrence:
        #   L[i, j] = (A[i, j] - sum_{t<j} L[i, t] conj(L[j, t])) / L[j, j]
        def col(carry, j):
            Li = carry
            dot = jnp.sum(Li * L[j].conj())
            v = (a_i[j] - dot) / L[j, j]
            Li = Li.at[j].set(jnp.where(j < i, v, Li[j]))
            return Li, None

        Li0 = jnp.zeros_like(a_i)
        Li, _ = jax.lax.scan(col, Li0, jnp.arange(n))
        diag = jnp.sqrt(jnp.maximum(
            jnp.real(a_i[i] - jnp.sum((Li * Li.conj()).real)), 1e-30)
        ).astype(A.dtype)
        Li = Li.at[i].set(diag)
        L = L.at[i].set(Li)
        return L, None

    L0 = jnp.zeros_like(A)
    L, _ = jax.lax.scan(row, L0, jnp.arange(n))
    return L


def chol_solve(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve SPD A x = b via scan-based Cholesky + substitutions."""
    n = A.shape[0]
    L = _chol_factor(A)

    def fwd(y, i):
        v = (b[i] - jnp.sum(L[i] * y)) / L[i, i]
        return y.at[i].set(v), None

    y, _ = jax.lax.scan(fwd, jnp.zeros_like(b), jnp.arange(n))

    Lh = L.conj().T

    def bwd(x, i):
        v = (y[i] - jnp.sum(Lh[i] * x)) / Lh[i, i]
        return x.at[i].set(v), None

    x, _ = jax.lax.scan(bwd, jnp.zeros_like(b), jnp.arange(n - 1, -1, -1))
    return x
