"""Fixed-rank matrix-product-state core.

Dense, static-shape state representation replacing ITensor's IQMPS. An MPS is a single
stacked array A of shape (L, chi, p, chi):

  * L sites, local dimension p = d+1, bond dimension chi — all static, so XLA
    compiles every contraction to a plain GEMM and `vmap` can batch thousands of
    states (multistart ramps, Hessian rows) with zero reshaping.
  * Boundary bonds are zero-padded: site 0 only uses left index 0, site L-1
    only uses right index 0. Padding flows through contractions/QR/eigh as
    exact zeros, so no masking is ever needed.

Gauge bookkeeping (the reference's leftLim/rightLim dance,
src/BH_tDMRG.cpp:165-219) is implicit in the sweep code: functions that care
about the orthogonality center say so in their docstrings.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .ops.precision import enforce_matmul_precision
from .ops.trunc import split_truncate

__all__ = [
    "product_state", "from_statevector", "to_statevector", "overlap",
    "norm", "normalize", "sandwich_site_sum", "expectation_values",
    "apply_site_sum_diag", "move_right", "move_left", "entanglement_entropies",
]


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def product_state(occupations, p: int, chi: int, dtype=jnp.complex128):
    """Padded MPS for the product Fock state |n_0, n_1, ...>.

    Mirrors the unit-filling initial guess of InitializeState
    (/root/reference/include/InitializeState.hpp:28-38).
    """
    L = len(occupations)
    A = np.zeros((L, chi, p, chi), dtype=np.complex128)
    for i, n in enumerate(occupations):
        A[i, 0, int(n), 0] = 1.0
    return A.astype(np.dtype(dtype))  # host numpy; device placement at jit


def from_statevector(vec: np.ndarray, L: int, p: int, chi: int,
                     dtype=jnp.complex128):
    """Exact MPS (padded to chi) from a dense state vector of dim p**L.

    Host-side setup utility (successive SVDs) used to convert exact-diag
    ground states into MPS form — the rebuild's counterpart of handing a DMRG
    result to the propagator. Requires chi >= min(p**k, p**(L-k)) for all k
    if the conversion is to be exact; otherwise truncates.
    """
    vec = np.asarray(vec, dtype=np.complex128).reshape(-1)
    assert vec.size == p ** L
    A = np.zeros((L, chi, p, chi), dtype=np.complex128)
    m = vec.reshape(1, -1)  # (left_rank, rest)
    rank = 1
    for i in range(L - 1):
        m = m.reshape(rank * p, -1)
        u, s, vh = np.linalg.svd(m, full_matrices=False)
        keep = min(chi, (s > 1e-14).sum() or 1)
        u, s, vh = u[:, :keep], s[:keep], vh[:keep, :]
        A[i, :rank, :, :keep] = u.reshape(rank, p, keep)
        m = (s[:, None] * vh)
        rank = keep
    A[L - 1, :rank, :, 0] = m.reshape(rank, p)
    return A.astype(np.dtype(dtype))  # host numpy; device placement at jit


def pad_chi(A: np.ndarray, chi_new: int) -> np.ndarray:
    """Zero-pad an (L, chi, p, chi) MPS into a larger bond dimension —
    an EXACT embedding (boundary convention uses index 0, and all
    contractions see zeros in the new directions). Host-side numpy.

    Used to hand a chi-ramped DMRG stage result to the next stage
    (InitializeState.hpp:53-57 maxm ramp) and to embed cheap-prep ground
    states into large-chi propagation studies."""
    A = np.asarray(A)
    L, chi, p, _ = A.shape
    if chi_new == chi:
        return A
    if chi_new < chi:
        raise ValueError(f"pad_chi cannot shrink chi {chi} -> {chi_new}")
    out = np.zeros((L, chi_new, p, chi_new), A.dtype)
    out[:, :chi, :, :chi] = A
    return out


@enforce_matmul_precision
def to_statevector(A) -> jnp.ndarray:
    """Contract an MPS back to a dense vector (testing / small L only)."""
    L = A.shape[0]
    psi = A[0][0]  # (p, chi)
    for i in range(1, L):
        psi = jnp.einsum('...a,apb->...pb', psi, A[i])
    return psi[..., 0].reshape(-1)


# ---------------------------------------------------------------------------
# contractions
# ---------------------------------------------------------------------------

@enforce_matmul_precision
def overlap(phi, psi):
    """<phi|psi> (phi conjugated), matching ITensor overlapC argument order
    (src/OptimalControl.cpp:450)."""
    L = phi.shape[0]
    env = jnp.einsum('apb,apc->bc', phi[0].conj(), psi[0])
    for i in range(1, L):
        env = jnp.einsum('ac,apb,cpd->bd', env, phi[i].conj(), psi[i])
    return jnp.trace(env)


@enforce_matmul_precision
def norm(psi):
    return jnp.sqrt(jnp.abs(overlap(psi, psi)).real)


def normalize(psi):
    n = norm(psi)
    scale = jnp.where(n > 1e-16, 1.0 / n, 1.0)
    # scale one site only (cheap, like psi.normalize() on a canonical MPS)
    return psi.at[0].multiply(scale.astype(psi.dtype))


def _left_envs(phi, psi):
    """L_i = contraction of sites < i of <phi|psi>; list of (chi, chi)."""
    L = phi.shape[0]
    chi = phi.shape[1]
    envs = [jnp.eye(chi, dtype=psi.dtype)]
    env = envs[0]
    for i in range(L - 1):
        env = jnp.einsum('ac,apb,cpd->bd', env, phi[i].conj(), psi[i])
        envs.append(env)
    return envs


def _right_envs(phi, psi):
    """R_i = contraction of sites > i; list indexed by site."""
    L = phi.shape[0]
    chi = phi.shape[1]
    envs = [None] * L
    env = jnp.eye(chi, dtype=psi.dtype)
    envs[L - 1] = env
    for i in range(L - 1, 0, -1):
        env = jnp.einsum('apb,cpd,bd->ac', phi[i].conj(), psi[i], env)
        envs[i - 1] = env
    return envs


@enforce_matmul_precision
def sandwich_site_sum(phi, psi, opdiag):
    """sum_i <phi| O_i |psi> for a diagonal single-site operator O.

    This evaluates <xi| dH/du |psi> with dH/du = sum_i 0.5 n_i(n_i-1) in one
    O(L chi^3) pass — the rebuild of overlapC(xi, propDeriv-MPO, psi)
    (src/OptimalControl.cpp:416) without MPO machinery.
    """
    L = phi.shape[0]
    lenvs = _left_envs(phi, psi)
    renvs = _right_envs(phi, psi)
    o = jnp.asarray(opdiag, dtype=psi.dtype)
    total = jnp.zeros((), dtype=psi.dtype)
    for i in range(L):
        mid = jnp.einsum('ac,apb,p,cpd->bd', lenvs[i], phi[i].conj(), o, psi[i])
        total = total + jnp.einsum('bd,bd->', mid, renvs[i])
    return total


@enforce_matmul_precision
def expectation_values(psi, opmat):
    """<psi| O_i |psi> for each site i, for a dense (p, p) operator.

    Rebuild of expectationValues (/root/reference/include/correlations.hpp:
    99-117). Assumes psi is normalized; works in any gauge via environments.
    """
    L = psi.shape[0]
    lenvs = _left_envs(psi, psi)
    renvs = _right_envs(psi, psi)
    o = jnp.asarray(opmat, dtype=psi.dtype)
    vals = []
    for i in range(L):
        mid = jnp.einsum('ac,aqb,qp,cpd->bd', lenvs[i], psi[i].conj(), o, psi[i])
        vals.append(jnp.einsum('bd,bd->', mid, renvs[i]))
    return jnp.stack(vals)


# ---------------------------------------------------------------------------
# gauge moves (QR-based center shifts)
# ---------------------------------------------------------------------------

def move_right(Ai, Aj, method: str = "qr"):
    """Shift orthogonality center from site i to site j=i+1.

    Ai (center) -> left-isometry Q;  Aj -> R @ Aj (new center).
    method "qr" = Householder QR; "cholesky" = matmul-only CholeskyQR
    (exact factorization Ai Aj == Ai' Aj' either way — gauge moves only
    need an invertible split, and orthonormality quality merely tunes
    truncation optimality).
    """
    chi, p, r = Ai.shape
    m = Ai.reshape(chi * p, r)
    if method == "cholesky":
        from .ops.trunc import cholesky_orthonormalize
        q, Lc = cholesky_orthonormalize(m)
        rmat = Lc.conj().T
    elif method == "mgs":
        # matmul/scan-only exact QR (ops/matfree.py) for backends with no
        # LAPACK: MGS spans range(m) exactly, so q (q^H m) == m
        from .ops.matfree import mgs_orthonormalize
        q = mgs_orthonormalize(m)
        rmat = q.conj().T @ m
    else:
        q, rmat = jnp.linalg.qr(m)
    Ai_new = q.reshape(chi, p, r)
    Aj_new = jnp.einsum('ab,bpc->apc', rmat, Aj)
    return Ai_new, Aj_new


def move_left(Ai, Aj, method: str = "qr"):
    """Shift orthogonality center from site j=i+1 to site i.

    Aj (center) -> right-isometry;  Ai -> Ai @ L (new center).
    """
    l, p, chi = Aj.shape
    m = Aj.reshape(l, p * chi)
    if method == "cholesky":
        from .ops.trunc import cholesky_orthonormalize
        q, Lc = cholesky_orthonormalize(m.conj().T)  # m^H = q Lc^H
        Aj_new = q.conj().T.reshape(l, p, chi)
        Ai_new = jnp.einsum('apb,bc->apc', Ai, Lc)
    elif method == "mgs":
        from .ops.matfree import mgs_orthonormalize
        q = mgs_orthonormalize(m.conj().T)           # m^H = q (q^H m^H)
        Aj_new = q.conj().T.reshape(l, p, chi)
        Ai_new = jnp.einsum('apb,bc->apc', Ai, (q.conj().T @ m.conj().T
                                                ).conj().T)
    else:
        qT, rT = jnp.linalg.qr(m.conj().T)          # m^H = qT rT
        Aj_new = qT.conj().T.reshape(l, p, chi)     # right-isometric
        Ai_new = jnp.einsum('apb,bc->apc', Ai, rT.conj().T)
    return Ai_new, Aj_new


# ---------------------------------------------------------------------------
# operator application
# ---------------------------------------------------------------------------

def apply_site_sum_diag(psi, opdiag, method: str = "eigh"):
    """(sum_i O_i)|psi> as an MPS truncated back to chi, plus its norm.

    Rebuild of exactApplyMPO(propDeriv, psi) (src/OptimalControl.cpp:257,361):
    the operator sum is a bond-dimension-2 MPO; we contract it exactly
    (bond 2*chi) then compress back to chi with a canonicalize+truncate sweep.
    Returns (mps_normalized, norm).
    """
    L, chi, p, _ = psi.shape
    o = jnp.asarray(opdiag, dtype=psi.dtype)

    # Exact MPO x MPS product, bond dimension 2*chi. MPO bond state:
    # block 0 = "operator not yet placed", block 1 = "placed".
    # W[0,0] = Id, W[0,1] = O, W[1,1] = Id; left boundary fixes 0, right 1.
    B = []
    for i in range(L):
        a = psi[i]
        oa = a * o[None, :, None]
        if i == 0:
            t = jnp.concatenate([a, oa], axis=2)                # (chi,p,2chi)
        elif i == L - 1:
            t = jnp.concatenate([oa, a], axis=0)                # (2chi,p,chi)
        else:
            top = jnp.concatenate([a, oa], axis=2)              # a=0 row
            zero = jnp.zeros_like(a)
            bot = jnp.concatenate([zero, a], axis=2)            # a=1 row
            t = jnp.concatenate([top, bot], axis=0)             # (2chi,p,2chi)
        B.append(t)

    # pass 1: right-canonicalize (exact, ranks stay 2*chi)
    for i in range(L - 1, 0, -1):
        B[i - 1], B[i] = move_left(B[i - 1], B[i])

    # pass 2: truncate left-to-right back to chi; center ends at site L-1
    out = []
    for i in range(L - 1):
        l, _, r = B[i].shape
        left, right = split_truncate(B[i].reshape(l * p, r), chi,
                                     keep_left=True, method=method)
        out.append(left.reshape(l, p, chi))
        B[i + 1] = jnp.einsum('ab,bpc->apc', right, B[i + 1])
    out.append(B[-1])  # (chi, p, chi)

    res = jnp.stack(out)
    nrm = norm(res)
    scale = jnp.where(nrm > 1e-16, 1.0 / nrm, 1.0)
    res = res.at[L - 1].multiply(scale.astype(res.dtype))
    return res, nrm


# ---------------------------------------------------------------------------
# entanglement
# ---------------------------------------------------------------------------

@enforce_matmul_precision
def entanglement_entropies(psi):
    """Von Neumann entropy at every bond (rebuild of entanglementEntropy,
    /root/reference/include/correlations.hpp:119-149)."""
    L, chi, p, _ = psi.shape
    A = [psi[i] for i in range(L)]
    # bring to right-canonical form so the center can sweep left->right
    for i in range(L - 1, 0, -1):
        A[i - 1], A[i] = move_left(A[i - 1], A[i])
    ents = []
    for i in range(L - 1):
        theta = jnp.einsum('apb,bqc->apqc', A[i], A[i + 1])
        m = theta.reshape(chi * p, p * chi)
        s = jnp.linalg.svd(m, compute_uv=False)
        p2 = s * s
        p2 = p2 / jnp.sum(p2)
        ent = -jnp.sum(jnp.where(p2 > 1e-12, p2 * jnp.log(p2), 0.0))
        ents.append(ent)
        A[i], A[i + 1] = move_right(A[i], A[i + 1])
    return jnp.stack(ents)
