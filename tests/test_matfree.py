"""Matmul-only linear algebra vs LAPACK ground truth (CPU, f64)."""

import numpy as np
import jax
import jax.numpy as jnp

from optimalcontrolmps.ops import matfree

RNG = np.random.default_rng(7)


def _rand_c(m, n):
    return (RNG.normal(size=(m, n)) + 1j * RNG.normal(size=(m, n))
            ) / np.sqrt(2)


def test_ns_orthonormalize_full_rank():
    X = _rand_c(96, 24)
    Q = np.asarray(matfree.ns_orthonormalize(jnp.asarray(X)))
    assert np.abs(Q.conj().T @ Q - np.eye(24)).max() < 1e-9
    # range preserved: projector onto span(Q) reproduces X
    assert np.abs(Q @ (Q.conj().T @ X) - X).max() < 1e-9


def test_ns_orthonormalize_rank_deficient():
    """Zero singular directions stay exactly zero (partial isometry)."""
    X = _rand_c(64, 8) @ _rand_c(8, 16)  # rank 8 in 16 columns
    Q = np.asarray(matfree.ns_orthonormalize(jnp.asarray(X)))
    s = np.linalg.svd(Q, compute_uv=False)
    assert (s > 0.99).sum() == 8
    assert (s < 1e-6).sum() == 8
    assert np.abs(Q @ (Q.conj().T @ X) - X).max() < 1e-8


def test_ns_sqrt():
    A = _rand_c(32, 32)
    S = A @ A.conj().T
    R = np.asarray(matfree.ns_sqrt(jnp.asarray(S)))
    assert np.abs(R @ R - S).max() / np.abs(S).max() < 1e-7
    # Hermitian PSD output
    assert np.abs(R - R.conj().T).max() < 1e-7


def test_ns_sqrt_singular():
    A = _rand_c(32, 10)
    S = A @ A.conj().T  # rank 10
    R = np.asarray(matfree.ns_sqrt(jnp.asarray(S)))
    assert np.abs(R @ R - S).max() / np.abs(S).max() < 1e-6


def test_subspace_topk_exact_rank():
    """rank <= k: the basis spans the range exactly."""
    X = _rand_c(80, 12)
    rho = np.asarray(X @ X.conj().T)
    V = np.asarray(matfree.subspace_topk(jnp.asarray(rho), 16))
    assert np.abs(V @ (V.conj().T @ X) - X).max() < 1e-8


def test_subspace_topk_truncating():
    """Decaying spectrum: captured energy matches the true top-k energy."""
    n, k = 64, 8
    w = 2.0 ** -np.arange(n)  # strongly decaying
    U = np.linalg.qr(_rand_c(n, n))[0]
    rho = (U * w) @ U.conj().T
    V = np.asarray(matfree.subspace_topk(jnp.asarray(rho), k, iters=4))
    captured = np.trace(V.conj().T @ rho @ V).real
    # criterion: EXTRA truncation error is a small fraction of the
    # inherent truncation error (the discarded tail), not of the total
    tail = w[k:].sum()
    assert w[:k].sum() - captured < 5e-3 * tail


def test_power_eig_max():
    A = _rand_c(48, 48)
    S = np.asarray(A @ A.conj().T)
    lam = float(matfree.power_eig_max(jnp.asarray(S)))
    ref = np.linalg.eigvalsh(S)[-1]
    assert abs(lam - ref) / ref < 1e-6


def test_chol_solve():
    for n in (4, 11, 40):
        A = _rand_c(n, n)
        S = np.asarray(A @ A.conj().T + n * np.eye(n))
        b = _rand_c(n, 1)[:, 0]
        x = np.asarray(matfree.chol_solve(jnp.asarray(S), jnp.asarray(b)))
        assert np.abs(S @ x - b).max() < 1e-8


def test_min_eig_matfree(monkeypatch):
    monkeypatch.setenv("OCMPS_LINALG", "matfree")
    from optimalcontrolmps.ops.matfree import min_eig, solve_spd
    A = RNG.normal(size=(24, 24))
    H = (A + A.T) / 2
    lam = float(min_eig(jnp.asarray(H)))
    ref = np.linalg.eigvalsh(H)[0]
    assert abs(lam - ref) / max(abs(ref), 1e-12) < 1e-4
    S = A @ A.T + 24 * np.eye(24)
    b = RNG.normal(size=24)
    x = np.asarray(solve_spd(jnp.asarray(S), jnp.asarray(b)))
    assert np.abs(S @ x - b).max() < 1e-8


def test_interior_point_matfree_path(monkeypatch):
    """The NLP solver converges with the matmul-only solve/min-eig path."""
    monkeypatch.setenv("OCMPS_LINALG", "matfree")
    import jax
    from optimalcontrolmps.optimize import minimize_interior_point

    n = 6
    A = RNG.normal(size=(n, n))
    Q = A @ A.T + n * np.eye(n)
    c = RNG.normal(size=n)

    def fgh(x):
        g = jnp.asarray(Q) @ x + jnp.asarray(c)
        return 0.5 * x @ (jnp.asarray(Q) @ x) + jnp.asarray(c) @ x, g, \
            jnp.asarray(Q)

    def f(x):
        return 0.5 * x @ (jnp.asarray(Q) @ x) + jnp.asarray(c) @ x

    B = jnp.eye(n)
    res = jax.jit(lambda x0: minimize_interior_point(
        fgh, x0, B=B, u0=10.0 * jnp.ones(n), tol=1e-8, max_iter=80,
        fun=f))(jnp.zeros(n))
    assert bool(res.converged)
    # same problem through the LAPACK path agrees
    monkeypatch.setenv("OCMPS_LINALG", "lapack")
    res2 = jax.jit(lambda x0: minimize_interior_point(
        fgh, x0, B=B, u0=10.0 * jnp.ones(n), tol=1e-8, max_iter=80,
        fun=f))(jnp.zeros(n))
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(res2.x),
                               atol=1e-6)


def test_chol_solve_real_jit_vmap():
    n, B = 12, 5
    A = RNG.normal(size=(B, n, n))
    S = A @ np.swapaxes(A, 1, 2) + n * np.eye(n)
    b = RNG.normal(size=(B, n))
    x = np.asarray(jax.jit(jax.vmap(matfree.chol_solve))(
        jnp.asarray(S), jnp.asarray(b)))
    assert np.abs(np.einsum('bij,bj->bi', S, x) - b).max() < 1e-8


def test_ns_sqrt_inv_rank_deficient_stable():
    """The ridged coupled iteration must stay finite on rank-deficient
    PSD matrices (the un-ridged form overflows f32 by ~iter 25)."""
    rng = np.random.default_rng(9)
    n, r = 64, 3
    X = (rng.standard_normal((n, r)) + 1j * rng.standard_normal((n, r))
         ).astype(np.complex64)
    G = (X @ X.conj().T).astype(np.complex64)  # rank 3 of 64
    S, P, eps = matfree.ns_sqrt_inv(jnp.asarray(G))
    S, P = np.asarray(S), np.asarray(P)
    assert np.isfinite(S).all() and np.isfinite(P).all()
    # sqrt squares back to G + eps I on the support
    np.testing.assert_allclose(S @ S, G + float(eps) * np.eye(n),
                               atol=2e-3 * np.abs(G).max())


def test_gram_orthonormalize_ill_conditioned():
    """Two-pass Gram orthonormalization restores unit columns down to
    sigma^2 ~ ridge (the refine pass re-lifts what the first ridged pass
    shrank; below that, columns carry weight under the f32 Gram noise
    floor and only soft-shrink — never amplify)."""
    rng = np.random.default_rng(4)
    m, k = 512, 48
    U = np.linalg.qr(rng.standard_normal((m, k))
                     + 1j * rng.standard_normal((m, k)))[0]
    sig = np.logspace(0, -2.5, k)
    X = (U * sig).astype(np.complex64)
    Q = np.asarray(matfree.gram_orthonormalize(jnp.asarray(X)))
    G = Q.conj().T @ Q
    np.testing.assert_allclose(G, np.eye(k), atol=5e-3)
    # spans the same space: projector residual small
    P = U @ U.conj().T
    assert np.linalg.norm(Q - P @ Q) < 1e-2
