"""Vidal-form parallel TEBD: truncation-capable brick evolution.

The reference's snake sweep (/root/reference/src/BH_tDMRG.cpp:127-230)
serializes the L-1 bond updates of every Trotter step to keep the
orthogonality center adjacent to the active bond — the canonical form is
what makes each truncation globally optimal. That serialization is the
wrong trade on an accelerator: at production chain lengths every step
becomes ~3L sequential contraction/factorization ops.

This module keeps the canonical data *in the state* instead of in a
roving center: the Vidal / canonical form stores right-canonical site
tensors B[i] together with the Schmidt values lam[b] of every bond
(Vidal, PRL 91, 147902). With lam at hand, the two-site wavefunction of
ANY bond b is

    theta_b = diag(lam[b-1]) B[b] B[b+1]

whose left factor is built from left-isometries and right factor from
right-isometries — so the top-chi eigendecomposition of theta^H theta is
the globally optimal truncation, for every bond independently. All even
bonds therefore update as ONE vmapped batch, then all odd bonds: a full
Trotter step is 2 batched bond updates instead of ~3L sequential ops,
with real truncation (unlike sweep="brick", which requires the
no-truncation regime).

The update uses Hastings' formulation (J. Math. Phys. 50, 095207) to
avoid dividing by small Schmidt values: with th = gate . (B[b] B[b+1])
(no left lam) and V = top-chi right eigenvectors of theta^H theta,

    B[b]   <- th @ V          (approximately right-isometric)
    B[b+1] <- V^H             (exactly right-isometric)
    lam[b] <- sqrt(top-chi eigenvalues), renormalized.

The gate product (even bonds, then odd bonds, control phases applied to
all sites before/after) is the same second-order Trotter channel as
tebd.tebd_step / BH_tDMRG::step (src/BH_tDMRG.cpp:111-124); in the
no-truncation regime it is algebraically identical to the snake sweep
(validated against the golden CostTests vectors in tests/test_vidal.py).

States are `VidalState(B, lam)` pytrees; `B` alone is a valid plain MPS
(product of right-canonical tensors), so all mps.py observables apply
directly. The derivative engine below mirrors engine.py
(OptimalControl<BH_tDMRG> formulas, src/OptimalControl.cpp) on Vidal
states; the exact Hessian stays on the snake/sector engines (its row
states are not Vidal-form — see hessian()).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from . import mps as mpslib
from .engine import (regularization, regularization_grad,
                     regularization_hessian as engine_reg_hessian)
from .ops.precision import enforce_matmul_precision
from .ops.trunc import _jitter
from .tebd import TEBDStepper

__all__ = [
    "VidalState", "from_mps", "to_mps", "vidal_step",
    "rollout", "rollout_final", "costate_rollout",
    "cost", "fidelities", "fidelities_streaming", "hessian_streaming",
    "bond_renyi2",
    "rollout_diagnostics", "gradient", "gradient_lowmem",
    "gradient_segmented", "hessian",
]


class VidalState(NamedTuple):
    """Canonical-form MPS: right-canonical tensors + per-bond Schmidt data.

    B:   (L, chi, p, chi) — product B[0]...B[L-1] is the state (so B is a
         valid mps.py MPS array on its own).
    lam: per-bond canonical carrier, one of two layouts:
         (L-1, chi) real — unit-2-norm Schmidt VALUES (trunc_method="eigh";
         the classic Vidal form), or
         (L-1, chi, chi) complex — Hermitian PSD bond MATRICES M_b with
         unit Frobenius norm, whose spectra are the Schmidt values
         (trunc_method="nssub", the matmul-only form: the bond update
         never eigen-orders, so the carrier is the Schmidt weight
         expressed in whatever orthonormal basis subspace iteration
         returned — diag(lam) is the special case of an eigen-ordered
         basis). theta_b = M_{b-1} B_b B_{b+1} holds in both layouts.
    """
    B: jnp.ndarray
    lam: jnp.ndarray


def to_matrix_carriers(state: VidalState) -> VidalState:
    """Vector Schmidt carrier -> diagonal matrix carrier (for the
    matmul-only trunc_method='nssub' stepper). Host (numpy) states stay
    on host."""
    if state.lam.ndim == 3:
        return state
    if isinstance(state.lam, np.ndarray):
        dtype = np.asarray(state.B).dtype
        M = np.stack([np.diag(l) for l in np.asarray(state.lam)])
        return VidalState(B=state.B, lam=M.astype(dtype))
    lam = jnp.asarray(state.lam)
    M = jax.vmap(jnp.diag)(lam.astype(state.B.dtype))
    return VidalState(B=state.B, lam=M)


def schmidt_values(state: VidalState) -> np.ndarray:
    """(L-1, chi) descending Schmidt values from either carrier layout
    (host-side eigvalsh for matrix carriers — analysis path, not hot)."""
    lam = np.asarray(state.lam)
    if lam.ndim == 2:
        return np.sort(lam, axis=1)[:, ::-1]
    w = np.linalg.eigvalsh(lam)  # M's spectrum IS the Schmidt spectrum
    return np.maximum(w[:, ::-1], 0.0)


def to_mps(state: VidalState) -> jnp.ndarray:
    return state.B


def from_mps(A: np.ndarray, cutoff: float = 1e-12) -> VidalState:
    """Host-side (numpy, f64) conversion of a plain MPS into canonical form.

    Used at state-prep time (ground states from groundstate/dmrg) — not a
    hot path. Two sweeps: right-canonicalize, then left-to-right SVDs
    recording Schmidt values; B-form via lam^{-1} A lam with tiny Schmidt
    directions masked to zero (they carry no weight).
    """
    A = np.asarray(A)
    L, chi, p, _ = A.shape
    work = np.complex128
    T = [A[i].astype(work) for i in range(L)]

    # sweep 1: right-canonicalize (center ends at site 0)
    for i in range(L - 1, 0, -1):
        m = T[i].reshape(chi, p * chi)
        u, s, vh = np.linalg.svd(m, full_matrices=False)
        k = min(chi, s.size)
        Bi = np.zeros((chi, p * chi), work)
        Bi[:k] = vh[:k]
        T[i] = Bi.reshape(chi, p, chi)
        carry = np.zeros((chi, chi), work)
        carry[:, :k] = u[:, :k] * s[:k]
        T[i - 1] = np.einsum('apb,bc->apc', T[i - 1], carry)

    # sweep 2: left-to-right, recording Schmidt values; A-form tensors
    lams = np.zeros((L - 1, chi))
    Aform = [None] * L
    C = T[0]
    for b in range(L - 1):
        m = C.reshape(chi * p, chi)
        u, s, vh = np.linalg.svd(m, full_matrices=False)
        k = min(chi, s.size)
        nrm = np.linalg.norm(s[:k]) or 1.0
        lams[b, :k] = s[:k] / nrm
        Ab = np.zeros((chi * p, chi), work)
        Ab[:, :k] = u[:, :k]
        Aform[b] = Ab.reshape(chi, p, chi)
        sv = np.zeros((chi, chi), work)
        sv[:k, :k] = np.diag(s[:k] / nrm)
        C = np.einsum('ab,bc,cpd->apd', sv, _pad_rows(vh[:k], chi), T[b + 1])
    Aform[L - 1] = C

    # B-form: B[b] = lam[b-1]^{-1} A[b] lam[b] (masked inverse)
    B = np.zeros((L, chi, p, chi), work)
    lam_prev = None
    for b in range(L):
        Ab = Aform[b]
        if b < L - 1:
            Ab = Ab * lams[b][None, None, :]
        if lam_prev is not None:
            inv = np.where(lam_prev > cutoff, 1.0 / np.maximum(lam_prev,
                                                               cutoff), 0.0)
            Ab = Ab * inv[:, None, None]
        B[b] = Ab
        lam_prev = lams[b] if b < L - 1 else None
    return VidalState(B=B.astype(A.dtype), lam=lams.astype(
        np.float64 if A.dtype == np.complex128 else np.float32))


def _pad_rows(m: np.ndarray, rows: int) -> np.ndarray:
    out = np.zeros((rows, m.shape[1]), m.dtype)
    out[:m.shape[0]] = m
    return out


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _bond_update(Bi, Bj, lam_left, gate, chi, p):
    """Hastings update of one bond (eigh form); returns
    (Bi', Bj', lam', disc) where disc is the relative discarded weight
    1 - sum(kept Schmidt weights)/sum(all) of this truncation — the
    adaptive-rank diagnostic (ITensor reports it as "truncerr")."""
    th = jnp.einsum('apb,bqc->apqc', Bi, Bj).reshape(chi, p * p, chi)
    th = jnp.einsum('PQ,aQc->aPc', gate, th)          # gate . (Bi Bj)
    theta = lam_left[:, None, None].astype(th.dtype) * th
    m = theta.reshape(chi * p, p * chi)
    rho = _jitter(m.conj().T @ m)                     # (p chi, p chi) PSD
    w, v = jnp.linalg.eigh(rho)                       # ascending
    w_all = jnp.maximum(w, 0.0)
    w = w[::-1][:chi]
    V = v[:, ::-1][:, :chi]                           # (p chi, chi)
    total = jnp.sum(w_all)
    kept = jnp.sum(w_all[::-1][:chi])
    disc = jnp.maximum(0.0, 1.0 - kept / jnp.maximum(total, 1e-30))
    lam = jnp.sqrt(jnp.maximum(w, 0.0))
    lam = lam / jnp.maximum(jnp.linalg.norm(lam), 1e-30)
    Bj_new = V.conj().T.reshape(chi, p, chi)          # exactly right-iso
    Bi_new = (th.reshape(chi * p, p * chi) @ V).reshape(chi, p, chi)
    real = jnp.float64 if th.dtype == jnp.complex128 else jnp.float32
    return Bi_new, Bj_new, lam.astype(real), disc.astype(real)


def _bond_update_matfree(Bi, Bj, M_left, gate, chi, p):
    """Matmul-only Hastings update (no LAPACK — see ops/matfree.py).

    The left Schmidt weight is a Hermitian PSD MATRIX M_left (any square
    root of the left reduced density matrix in the current bond basis);
    theta = M_left . gate . (Bi Bj) still has left/right factors built
    from isometries, so the dominant chi-dim right-eigenspace V of
    theta^H theta is the globally optimal truncation. V comes from
    subspace iteration (unordered — ordering is irrelevant, all chi
    directions are kept); the new bond carrier is the matrix square root
        M_b = sqrt(V^H theta^H theta V) = sqrt((theta V)^H (theta V)),
    whose spectrum is exactly the kept Schmidt values."""
    from .ops.matfree import ns_sqrt, subspace_topk

    th = jnp.einsum('apb,bqc->apqc', Bi, Bj).reshape(chi, p * p, chi)
    th = jnp.einsum('PQ,aQc->aPc', gate, th)
    theta = jnp.einsum('ab,bPc->aPc', M_left.astype(th.dtype), th)
    m = theta.reshape(chi * p, p * chi)
    rho = _jitter(m.conj().T @ m)
    V = subspace_topk(rho, chi)                       # (p chi, chi)
    W = V.conj().T @ (rho @ V)
    W = 0.5 * (W + W.conj().T)
    total = jnp.sum((m * m.conj()).real)
    kept = jnp.trace(W).real
    disc = jnp.maximum(0.0, 1.0 - kept / jnp.maximum(total, 1e-30))
    M = ns_sqrt(W)
    M = 0.5 * (M + M.conj().T)
    fro = jnp.sqrt(jnp.sum((M * M.conj()).real))
    M = M / jnp.maximum(fro, 1e-30).astype(M.dtype)
    Bj_new = V.conj().T.reshape(chi, p, chi)          # exactly right-iso
    Bi_new = (th.reshape(chi * p, p * chi) @ V).reshape(chi, p, chi)
    real = jnp.float64 if th.dtype == jnp.complex128 else jnp.float32
    return Bi_new, Bj_new, M, disc.astype(real)


def _bond_update_matfree_ns(Bi, Bj, M_left, gate, chi, p):
    """GEMM-only Hastings update tuned for f32 (policy "ns").

    Two fixes over _bond_update_matfree, both driven by f32 rounding
    (tools/probe_trunc_orth.py):

    * The kept subspace comes from sketching theta^H DIRECTLY — its
      singular values are the Schmidt values lambda, so Newton-Schulz
      orthonormalization has to equalize condition ~lambda, not the
      lambda^2 of rho = theta^H theta subspace iteration (which needs
      ~2x the iterations and, early in a rollout where theta is near
      rank-1 with lambda_2/lambda_1 ~ 1e-2..1e-4, never converges in
      f32). Directions below the NS resolution sigma_rel ~ 6e-5 carry
      state weight < 4e-9 — below the f32 floor regardless.
    * The bond carrier is the Hermitian polar factor M = U^H X of
      X = theta V (U = NS partial isometry of X): equal to
      sqrt(V^H theta^H theta V) on its support with NO inverse iterate —
      ns_sqrt's coupled Z -> A^{-1/2} factor grows as 1.5^k on the null
      space of a rank-deficient carrier and overflows f32 into NaN by
      ~iteration 25 (measured; f64 CPU never hit it). The polar form is
      unconditionally stable: null singular directions stay exactly 0.
    """
    import os

    from .ops.matfree import _fixed_sketch, ns_orthonormalize

    # NS iteration count: accuracy knob (f32, L=20 chi=64, 30-step
    # rollout vs f64 golden: 24 -> 8.4e-4, 32 -> 2.6e-4 (= the mgs f32
    # floor), 40 -> 1.0e-4). Cost is ~2 small GEMMs per iteration.
    it = int(os.environ.get("OCMPS_NS_ITERS", "32"))
    th = jnp.einsum('apb,bqc->apqc', Bi, Bj).reshape(chi, p * p, chi)
    th = jnp.einsum('PQ,aQc->aPc', gate, th)
    theta = jnp.einsum('ab,bPc->aPc', M_left.astype(th.dtype), th)
    m = theta.reshape(chi * p, p * chi)
    sk = _fixed_sketch(chi * p, chi, m.dtype)
    q = ns_orthonormalize(m.conj().T @ sk, iters=it)  # sigma ~ lambda
    V = ns_orthonormalize(m.conj().T @ (m @ q), iters=it)  # power round
    X = m @ V                                         # (chi p, chi)
    U = ns_orthonormalize(X, iters=it)
    M = U.conj().T @ X                                # sqrt(X^H X)|support
    M = 0.5 * (M + M.conj().T)
    kept = jnp.sum((X * X.conj()).real)
    total = jnp.sum((m * m.conj()).real)
    disc = jnp.maximum(0.0, 1.0 - kept / jnp.maximum(total, 1e-30))
    fro = jnp.sqrt(jnp.sum((M * M.conj()).real))
    M = M / jnp.maximum(fro, 1e-30).astype(M.dtype)
    Bj_new = V.conj().T.reshape(chi, p, chi)
    Bi_new = (th.reshape(chi * p, p * chi) @ V).reshape(chi, p, chi)
    real = jnp.float64 if th.dtype == jnp.complex128 else jnp.float32
    return Bi_new, Bj_new, M, disc.astype(real)


def _bond_update_matfree_gram(Bi, Bj, M_left, gate, chi, p):
    """GEMM-bound Hastings update (policy "gram"): every
    orthonormalization/sqrt goes through a (chi, chi) Gram matrix and a
    RIDGED small-matrix Newton-Schulz loop (ops/matfree.ns_sqrt_inv) —
    ~10 large GEMMs per bond update total, vs ~100 for policy "ns"
    (whose per-iteration Gram products dominate the vidal step).

    Numerics: identical structure to _bond_update_matfree_ns — sketch of
    theta^H (condition ~ lambda), one power round, polar-free carrier
    sqrt(V^H theta^H theta V) — but each orthonormalization is
    Q = X (X^H X + eps I)^{-1/2}. The ridge keeps the inverse bounded on
    rank-deficient spectra (early TEBD bonds are near rank-1); columns
    below the f32 Gram floor come out softly shrunk instead of exactly
    zero, which costs state weight < ridge (1e-7) per bond."""
    import os

    from .ops.matfree import _fixed_sketch, gram_orthonormalize, ns_sqrt_inv

    it = int(os.environ.get("OCMPS_NS_ITERS", "17"))
    th = jnp.einsum('apb,bqc->apqc', Bi, Bj).reshape(chi, p * p, chi)
    th = jnp.einsum('PQ,aQc->aPc', gate, th)
    theta = jnp.einsum('ab,bPc->aPc', M_left.astype(th.dtype), th)
    m = theta.reshape(chi * p, p * chi)
    sk = _fixed_sketch(chi * p, chi, m.dtype)
    # side-ALTERNATING subspace iteration: every intermediate panel has
    # singular values ~ lambda (never lambda^2), so each Gram sees
    # condition lambda^2 — a raw power round m^H (m q) would hand the
    # Gram lambda^4 and squash every direction below lambda_rel ~ 0.06
    # (measured: 1-F = 0.63 after 30 steps; alternating restores 2e-4)
    q = gram_orthonormalize(m.conj().T @ sk, iters=it)   # right space
    w = gram_orthonormalize(m @ q, iters=it)             # left space
    V = gram_orthonormalize(m.conj().T @ w, iters=it)    # right space
    X = m @ V                                         # (chi p, chi)
    G = X.conj().T @ X
    M, _, eps = ns_sqrt_inv(G, iters=it)              # sqrt on support
    # deflate the ridge's spurious sqrt(eps) weight on null directions
    # (sqrt(lam+eps) - sqrt(eps) >= 0, exact at lam=0, bias eps/2sqrt(lam)
    # on resolved directions)
    M = M - jnp.sqrt(eps).astype(M.dtype) * jnp.eye(chi, dtype=M.dtype)
    M = 0.5 * (M + M.conj().T)
    kept = jnp.trace(G).real
    total = jnp.sum((m * m.conj()).real)
    disc = jnp.maximum(0.0, 1.0 - kept / jnp.maximum(total, 1e-30))
    fro = jnp.sqrt(jnp.sum((M * M.conj()).real))
    M = M / jnp.maximum(fro, 1e-30).astype(M.dtype)
    Bj_new = V.conj().T.reshape(chi, p, chi)
    Bi_new = (th.reshape(chi * p, p * chi) @ V).reshape(chi, p, chi)
    real = jnp.float64 if th.dtype == jnp.complex128 else jnp.float32
    return Bi_new, Bj_new, M, disc.astype(real)


_MATFREE_UPDATES = {"ns": _bond_update_matfree_ns,
                    "gram": _bond_update_matfree_gram}


def _stage(st, T, lam, bonds, gate, disc=None, shard=None):
    """Update a set of DISJOINT bonds as one vmapped batch. `disc`, when
    given, is a dict collecting per-bond discarded weight (unused outputs
    are dead-code-eliminated by XLA on the hot path). `shard`, when
    given, is a NamedSharding annotated onto the stacked bond batch —
    the tensor-parallel path (see vidal_step's tp_mesh)."""
    if not bonds:
        return T, lam
    chi, p = st.chi, st.p
    matrix_form = lam[0].ndim == 2
    Bi = jnp.stack([T[b] for b in bonds])
    Bj = jnp.stack([T[b + 1] for b in bonds])
    if shard is not None:
        Bi = jax.lax.with_sharding_constraint(Bi, shard)
        Bj = jax.lax.with_sharding_constraint(Bj, shard)
    if matrix_form:
        from .ops.matfree import trunc_orth_policy
        eye = jnp.eye(chi, dtype=T[0].dtype)
        Ll = jnp.stack([lam[b - 1] if b > 0 else eye for b in bonds])
        upd = _MATFREE_UPDATES.get(trunc_orth_policy(),
                                   _bond_update_matfree)
    else:
        real = lam[0].dtype
        Ll = jnp.stack([lam[b - 1] if b > 0 else jnp.ones((chi,), real)
                        for b in bonds])
        upd = _bond_update
    Bi2, Bj2, lam2, disc2 = jax.vmap(
        lambda a, b, c: upd(a, b, c, gate, chi, p))(Bi, Bj, Ll)
    for k, b in enumerate(bonds):
        T[b] = Bi2[k]
        T[b + 1] = Bj2[k]
        lam[b] = lam2[k]
        if disc is not None:
            disc[b] = disc2[k]
    return T, lam


@enforce_matmul_precision
def vidal_step(st: TEBDStepper, state: VidalState, u_from, u_to,
               forward: bool = True, diag: bool = False, tp_mesh=None):
    """One full Trotter step on a canonical-form state. Same operator
    product as tebd.tebd_step (src/BH_tDMRG.cpp:111-124): half-interaction
    phases D(u_from), even J-bonds, odd J-bonds, D(u_to); backward negates
    the controls and conjugates the J-gates. Single-site diagonal phases
    commute with the bond structure, so they preserve canonical form
    exactly and apply to all sites at once.

    diag=True additionally returns the (L-1,) per-bond discarded weight
    of this step's truncations (state, disc) — the honest analogue of
    ITensor's adaptive-rank truncation error for the analysis drivers.

    tp_mesh: a ("batch", "rows") jax.sharding.Mesh enables TENSOR
    PARALLELISM over the lattice — each brick stage's disjoint-bond
    batch is sharded across the mesh's "rows" axis, so per-chip FLOPs
    and device memory for the bond updates scale as (L/n_rows) * chi^2 * p^2.
    The even/odd stages couple only through neighbor site tensors; the
    sharding constraint lets XLA insert the halo collectives.
    This is the scale-out for chains where a single card's memory cannot
    hold the chi >= 256 working set (SURVEY.md parallelism inventory,
    TP row)."""
    L, chi = st.L, st.chi
    shard = None
    if tp_mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        shard = NamedSharding(tp_mesh, PartitionSpec("rows"))
    gate = st.gate_fwd if forward else st.gate_bwd
    uf = jnp.asarray(u_from) if forward else -jnp.asarray(u_from)
    ut = jnp.asarray(u_to) if forward else -jnp.asarray(u_to)
    ph_from = jnp.exp(-0.25j * uf * st.dt * st.nn1).astype(state.B.dtype)
    ph_to = jnp.exp(-0.25j * ut * st.dt * st.nn1).astype(state.B.dtype)

    A = state.B * ph_from[None, None, :, None]
    T = [A[i] for i in range(L)]
    lam = [state.lam[b] for b in range(L - 1)]
    disc = {} if diag else None
    T, lam = _stage(st, T, lam, list(range(0, L - 1, 2)), gate, disc,
                    shard)
    T, lam = _stage(st, T, lam, list(range(1, L - 1, 2)), gate, disc,
                    shard)
    A = jnp.stack(T) * ph_to[None, None, :, None]

    # per-step renormalization (the reference normalizes every step,
    # src/BH_tDMRG.cpp:226-229 — required so divT/ov weights match across
    # time indices). Truncation makes the step non-unitary, so this is an
    # exact norm contraction, not drift control.
    nrm = mpslib.norm(A)
    A = A.at[0].multiply(jnp.where(nrm > 1e-16, 1.0 / nrm, 1.0
                                   ).astype(A.dtype))
    out = VidalState(B=A, lam=jnp.stack(lam))
    if diag:
        return out, jnp.stack([disc[b] for b in range(L - 1)])
    return out


# ---------------------------------------------------------------------------
# derivative engine (engine.py formulas on Vidal states)
# ---------------------------------------------------------------------------

@enforce_matmul_precision
def rollout(st: TEBDStepper, psi0: VidalState, u):
    """psi_t for all N_t times (calcPsi, src/OptimalControl.cpp:375-390)."""
    def body(psi, uu):
        nxt = vidal_step(st, psi, uu[0], uu[1], forward=True)
        return nxt, nxt

    pairs = jnp.stack([u[:-1], u[1:]], axis=1)
    _, traj = jax.lax.scan(body, psi0, pairs)
    return jax.tree_util.tree_map(
        lambda a, t: jnp.concatenate([a[None], t], axis=0), psi0, traj)


@enforce_matmul_precision
def rollout_final(st: TEBDStepper, psi0: VidalState, u):
    def body(psi, uu):
        return vidal_step(st, psi, uu[0], uu[1], forward=True), None

    pairs = jnp.stack([u[:-1], u[1:]], axis=1)
    psiT, _ = jax.lax.scan(body, psi0, pairs)
    return psiT


@enforce_matmul_precision
def rollout_final_tp(st: TEBDStepper, psi0: VidalState, u, mesh):
    """rollout_final with TENSOR-PARALLEL bond updates: each Trotter
    step's brick stages shard their disjoint-bond batch over the mesh's
    "rows" axis (see vidal_step tp_mesh). Must run inside jit; values
    are identical to rollout_final (tests/test_parallel.py)."""
    def body(psi, uu):
        return vidal_step(st, psi, uu[0], uu[1], forward=True,
                          tp_mesh=mesh), None

    pairs = jnp.stack([u[:-1], u[1:]], axis=1)
    psiT, _ = jax.lax.scan(body, psi0, pairs)
    return psiT


@enforce_matmul_precision
def costate_rollout(st: TEBDStepper, psi_target: VidalState, u):
    """xi_t backward from the target (calcXi, OptimalControl.cpp:392-407)."""
    def body(xi, uu):
        nxt = vidal_step(st, xi, uu[0], uu[1], forward=False)
        return nxt, nxt

    pairs = jnp.stack([u[1:][::-1], u[:-1][::-1]], axis=1)
    _, traj = jax.lax.scan(body, psi_target, pairs)
    full = jax.tree_util.tree_map(
        lambda a, t: jnp.concatenate([a[None], t], axis=0), psi_target, traj)
    return jax.tree_util.tree_map(lambda x: x[::-1], full)


@enforce_matmul_precision
def cost(st: TEBDStepper, psi0: VidalState, psi_target: VidalState, u, gamma):
    psiT = rollout_final(st, psi0, u)
    ov = mpslib.overlap(psi_target.B, psiT.B)
    fid = (ov * ov.conj()).real
    return 0.5 * (1.0 - fid) + regularization(u, gamma, st.dt)


@enforce_matmul_precision
def fidelities(st: TEBDStepper, psi0: VidalState, psi_target: VidalState, u):
    psi_t = rollout(st, psi0, u)
    ovs = jax.vmap(lambda p: mpslib.overlap(psi_target.B, p))(psi_t.B)
    return (ovs * ovs.conj()).real


@enforce_matmul_precision
def fidelities_streaming(st: TEBDStepper, psi0: VidalState,
                         psi_target: VidalState, u):
    """|<target|psi(t_i)>|^2 for every i with ONE state in flight (never
    stacks the N_t trajectory — the reference-scale HBM policy, see
    streaming.py)."""
    from .streaming import rollout_measure

    def measure(s):
        ov = mpslib.overlap(psi_target.B, s.B)
        return (ov * ov.conj()).real

    return rollout_measure(
        lambda s, ua, ub: vidal_step(st, s, ua, ub, forward=True),
        psi0, u, measure)


def bond_renyi2(state: VidalState):
    """(L-1,) per-bond Renyi-2 entanglement entropy
    S2_b = -log tr(rho_b^2) = -log(sum lam^4 / (sum lam^2)^2), computed
    directly from the Schmidt carrier — matmul-only (one (chi,chi) GEMM
    per bond for matrix carriers), with no SVD as in
    mps.entanglement_entropies.
    exp(S2_b) is the participation (effective) bond rank — the
    fixed-rank analogue of the reference's per-bond `linkInd(psi,b).m()`
    log (/root/reference/main/AnalyzeBondDim.cpp:138-141)."""
    lam = state.lam
    if lam.ndim == 2:                   # vector Schmidt values
        w2 = lam * lam
        tr2 = (jnp.sum(w2 * w2, axis=1)
               / jnp.maximum(jnp.square(jnp.sum(w2, axis=1)), 1e-30))
        return -jnp.log(tr2)
    M2 = jnp.einsum('bij,bjk->bik', lam, lam)
    tr_rho = jnp.einsum('bii->b', M2).real          # sum lam^2
    tr_rho2 = jnp.sum((M2 * M2.conj()).real, axis=(1, 2))   # sum lam^4
    return -jnp.log(tr_rho2 / jnp.maximum(tr_rho * tr_rho, 1e-30))


def bond_vn_entropy(state: VidalState):
    """(L-1,) per-bond von Neumann entropy from a VECTOR Schmidt carrier
    (exact, on-device). Matrix carriers would need an eigendecomposition
    — use bond_renyi2 on device and host-side vidal.schmidt_values for
    sampled exact vN there."""
    lam = state.lam
    if lam.ndim != 2:
        raise ValueError("bond_vn_entropy needs the vector Schmidt "
                         "carrier; matrix carriers: use bond_renyi2 "
                         "(device) or schmidt_values (host)")
    w = lam * lam
    w = w / jnp.maximum(jnp.sum(w, axis=1, keepdims=True), 1e-30)
    return -jnp.sum(jnp.where(w > 1e-14,
                              w * jnp.log(jnp.maximum(w, 1e-30)), 0.0),
                    axis=1)


@enforce_matmul_precision
def rollout_diagnostics(st: TEBDStepper, psi0: VidalState, u,
                        psi_target: VidalState = None):
    """Streaming per-step truncation/entanglement diagnostics.

    Returns (final_state, diag) where diag is a dict of stacked arrays:
      fid   (N_t,)       |<target|psi_i>|^2 (only if psi_target given)
      s2    (N_t, L-1)   per-bond Renyi-2 entropy
      disc  (N_t, L-1)   per-bond discarded weight of step i
                         (row 0 is zeros — no step produced psi_0)
    One state in flight; the honest rebuild of AnalyzeBondDim's per-t
    per-bond records (/root/reference/main/AnalyzeBondDim.cpp:125-148).
    """
    Lm1 = st.L - 1
    zero_disc = jnp.zeros((Lm1,), bond_renyi2(psi0).dtype)

    def measure(s, disc):
        out = {"s2": bond_renyi2(s), "disc": disc}
        if psi_target is not None:
            ov = mpslib.overlap(psi_target.B, s.B)
            out["fid"] = (ov * ov.conj()).real
        return out

    def body(s, uu):
        nxt, disc = vidal_step(st, s, uu[0], uu[1], forward=True,
                               diag=True)
        return nxt, measure(nxt, disc)

    pairs = jnp.stack([u[:-1], u[1:]], axis=1)
    sT, ms = jax.lax.scan(body, psi0, pairs)
    m0 = measure(psi0, zero_disc)
    diag = jax.tree_util.tree_map(
        lambda a, t: jnp.concatenate([a[None], t], axis=0), m0, ms)
    return sT, diag


@enforce_matmul_precision
def gradient_segmented(st: TEBDStepper, psi0: VidalState,
                       psi_target: VidalState, u, gamma, seg=None):
    """Adjoint gradient with O(sqrt(N_t)) state memory (two-level
    checkpointing, see streaming.segmented_adjoint_gradient) — the only
    gradient path that fits reference-scale chains (N=20, chi>=128,
    N_t=1001) in HBM. Returns (g, (psiT, divT, ov))."""
    from .streaming import segmented_adjoint_gradient
    half_nn1 = 0.5 * st.nn1
    return segmented_adjoint_gradient(
        lambda s, ua, ub: vidal_step(st, s, ua, ub, forward=True),
        lambda x, ui, uim1: vidal_step(st, x, ui, uim1, forward=False),
        lambda x, s: mpslib.sandwich_site_sum(x.B, s.B, half_nn1),
        lambda sT, tgt: mpslib.overlap(sT.B, tgt.B),
        lambda uu: regularization_grad(uu, gamma, st.dt),
        psi0, psi_target, u, st.dt, seg=seg)


def _div_t(st: TEBDStepper, xi_B, psi_B):
    half_nn1 = 0.5 * st.nn1
    return jax.vmap(lambda x, p: mpslib.sandwich_site_sum(x, p, half_nn1))(
        xi_B, psi_B)


@enforce_matmul_precision
def gradient(st: TEBDStepper, psi0: VidalState, psi_target: VidalState,
             u, gamma):
    """Adjoint gradient (OptimalControl.cpp:204-249) on Vidal states."""
    psi_t = rollout(st, psi0, u)
    xi_t = costate_rollout(st, psi_target, u)
    divT = _div_t(st, xi_t.B, psi_t.B)
    ov = mpslib.overlap(psi_t.B[-1], psi_target.B)
    g = st.dt * (divT * ov * 1j).real + regularization_grad(u, gamma, st.dt)
    return g, (psi_t, xi_t, divT, ov)


@enforce_matmul_precision
def gradient_lowmem(st: TEBDStepper, psi0: VidalState,
                    psi_target: VidalState, u, gamma):
    """BFGS-mode gradient: xi never stored (src/OptimalControl.cpp:216-229).
    """
    half_nn1 = 0.5 * st.nn1
    psi_t = rollout(st, psi0, u)

    def body(xi, inp):
        u_i, u_im1, psiB_im1 = inp
        xi_next = vidal_step(st, xi, u_i, u_im1, forward=False)
        div = mpslib.sandwich_site_sum(xi_next.B, psiB_im1, half_nn1)
        return xi_next, div

    divT_last = mpslib.sandwich_site_sum(psi_target.B, psi_t.B[-1], half_nn1)
    inps = (u[1:][::-1], u[:-1][::-1], psi_t.B[:-1][::-1])
    _, divs = jax.lax.scan(body, psi_target, inps)
    divT = jnp.concatenate([divs[::-1], divT_last[None]])
    ov = mpslib.overlap(psi_t.B[-1], psi_target.B)
    g = st.dt * (divT * ov * 1j).real + regularization_grad(u, gamma, st.dt)
    return g, (psi_t, None, divT, ov)


def _snake_twin(st: TEBDStepper) -> TEBDStepper:
    """A snake-sweep stepper with the SAME physics constants (gates, nn1,
    chi, dt) as a vidal stepper — the row-propagation channel for the
    exact Hessian. Reuses the prebuilt gate arrays; only the sweep policy
    and truncation method change (the Hastings carriers don't apply to
    non-canonical row states). A matfree vidal stepper (trunc 'nssub')
    keeps the matmul-only truncation with the MGS gauge — the snake
    combination that needs no dense factorization."""
    import dataclasses as _dc
    if st.trunc_method == "nssub":
        return _dc.replace(st, sweep="snake", trunc_method="nssub",
                           gauge_method="mgs")
    trunc = st.trunc_method if st.trunc_method in ("eigh", "svd", "rsvd") \
        else "eigh"
    return _dc.replace(st, sweep="snake", trunc_method=trunc,
                       gauge_method="qr")


def hessian(st: TEBDStepper, psi0: VidalState, psi_target: VidalState,
            u, gamma, aux=None, row_sharding=None):
    """Exact dense Hessian on the truncating long-chain path (the reference
    computes exact Hessians through its truncating stepper everywhere,
    src/OptimalControl.cpp:251-372).

    Hybrid row propagation: the psi/xi trajectories and divT come from the
    VIDAL channel (canonical-form parallel-brick truncation — this module's
    gradient()), while the dH|psi_i> row states propagate through a
    snake-sweep twin of the same physics (engine.hessian's vmapped row
    batch). Rows cannot stay in Vidal form — applying the dH MPO destroys
    the Schmidt structure, exactly as exactApplyMPO leaves ITensor's
    canonical flags stale in the reference (OptimalControl.cpp:256-263) —
    so the roving-center sweep is the correct propagator for them. In the
    no-truncation regime the two channels are algebraically identical; with
    real truncation they differ at the truncation-error scale, which is the
    Hessian's own error floor (validated vs finite differences at the
    reference's 5e-3 tolerance, /root/reference/tests/HessianTests.cpp:
    178-184, in tests/test_vidal.py)."""
    from . import engine as _engine

    if aux is None:
        _, aux = gradient(st, psi0, psi_target, u, gamma)
    psi_t, xi_t, divT, ov = aux
    psi_B = psi_t.B if hasattr(psi_t, "B") else psi_t
    xi_B = xi_t.B if hasattr(xi_t, "B") else xi_t
    st_snake = _snake_twin(st)
    return _engine.hessian(st_snake, psi0.B, psi_target.B, u, gamma,
                           aux=(psi_B, xi_B, divT, ov),
                           row_sharding=row_sharding)


_BLOCK_HESS_CACHE: dict = {}


def hessian_streaming(st: TEBDStepper, psi0: VidalState,
                      psi_target: VidalState, u, gamma, aux=None,
                      row_block: int = 64, progress=None):
    """Streaming exact Hessian on the truncating long-chain path —
    vidal.hessian's hybrid channel (vidal psi/xi trajectories, snake
    row propagation; see that docstring) with O(row_block) live states
    instead of the O(N_t) all-rows carry that OOMs HBM at N=20,
    chi>=128, N_t=601. Host-driven block dispatches — pair with
    optimize.minimize_interior_point_host. Returns host numpy
    (N_t, N_t)."""
    import numpy as np

    from . import engine as _engine
    from .ops.precision import enforce_matmul_precision as _emp
    from .streaming import (BlockHessian, assemble_hessian,
                            pick_row_block)
    u = jnp.asarray(u)
    n = u.shape[0]
    R = pick_row_block(n - 1, row_block)
    if aux is None:
        # jit the recompute with the states as ARGUMENTS: un-traced lax
        # tails would execute op-by-op, and device-array closures would
        # be embedded as program constants
        _, aux = jax.jit(lambda p0, pt, uu: gradient_segmented(
            st, p0, pt, uu, gamma))(psi0, psi_target, u)
    _, divT, ov = aux

    key = (id(st), n, R)
    hit = _BLOCK_HESS_CACHE.get(key)
    if hit is not None:
        bh = hit[0]
    else:
        st_row = _snake_twin(st)
        half_nn1 = 0.5 * st.nn1
        from .tebd import tebd_step as _tstep
        bh = BlockHessian(
            n, R,
            fwd=lambda s, a, b: vidal_step(st, s, a, b, forward=True),
            bwd=lambda s, a, b: vidal_step(st, s, a, b, forward=False),
            get_b=lambda s: s.B,
            apply_dh=lambda B: mpslib.apply_site_sum_diag(
                B, half_nn1, method=st_row.trunc_method),
            row_step=jax.vmap(
                lambda A, a, b: _tstep(st_row, A, a, b, True),
                in_axes=(0, None, None)))
        _BLOCK_HESS_CACHE[key] = (bh, st)

    from .ops import complex_io as cio
    ov_data = _emp(bh.ov_data)
    ovm, row_n, xih_n, diag_ov = ov_data(psi0, psi_target, u,
                                         progress=progress)
    real = np.float64 if u.dtype == jnp.float64 else np.float32
    reg = np.asarray(engine_reg_hessian(n, gamma, st.dt,
                                        dtype=jnp.float64))
    return assemble_hessian(ovm, row_n, xih_n, diag_ov,
                            cio.get(divT), complex(cio.get(ov)), st.dt,
                            reg_hess=reg).astype(real)
