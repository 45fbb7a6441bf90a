"""Second-order Suzuki-Trotter TEBD propagator for the Bose-Hubbard chain.

JAX rebuild of BH_tDMRG (reference include/BH_tDMRG.hpp:16-40,
/root/reference/src/BH_tDMRG.cpp). One step applies

    psi <- D(u_to) * (odd J-gates) * (even J-gates) * D(u_from) * psi

where D(u) = prod_i exp(-0.25 * u * dt * i * n_i(n_i-1)) is the split-step
half interaction (src/BH_tDMRG.cpp:74-108) and the J-gates are
exp(-i dt h_bond) on even bonds left-to-right then odd bonds right-to-left
with truncation to fixed chi (src/BH_tDMRG.cpp:127-230).

Design note (equivalence proof): the reference interleaves the diagonal
single-site U-phases into the J-gate sweeps. Because single-site unitaries on
either side of a bond never change that bond's Schmidt spectrum, applying all
D(u_from) phases before the sweeps and all D(u_to) phases after is *exactly*
equivalent — including every truncation decision. We exploit that to keep the
sweep a pure chain of bond ops (better XLA fusion, no per-site bookkeeping).

Backward propagation (co-state sweep) negates both the controls and dt,
matching src/BH_tDMRG.cpp:117-124.

The sweep maintains canonical form with QR center moves (the reference's
manual leftLim/rightLim bookkeeping, src/BH_tDMRG.cpp:165-219), and
renormalizes the center after every truncation (src/BH_tDMRG.cpp:183-213).
All shapes are static; a step jit-compiles to a fixed chain of (chi*p) x
(chi*p) contractions + eigh factorizations that vmap over batches of states.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .ops.gates import j_gate
from .ops.precision import enforce_matmul_precision
from .ops.trunc import split_truncate
from .sites import nn1_diag
from . import mps as mpslib

__all__ = ["TEBDStepper", "make_stepper", "tebd_step"]


@partial(jax.tree_util.register_dataclass,
         data_fields=["gate_fwd", "gate_bwd", "nn1"],
         meta_fields=["L", "p", "chi", "dt", "trunc_method",
                      "gauge_method", "sweep"])
@dataclasses.dataclass(frozen=True)
class TEBDStepper:
    """Precomputed constants of the propagator (the reference's BH_tDMRG
    object state: constant J-gates + dH/du diagonal, src/BH_tDMRG.cpp:3-15).
    """
    gate_fwd: jnp.ndarray   # (p*p, p*p) exp(-i dt h)
    gate_bwd: jnp.ndarray   # conj, for backward sweeps
    nn1: jnp.ndarray        # (p,) n(n-1) diagonal (dH/du = 0.5 * sum_i this)
    L: int
    p: int
    chi: int
    dt: float
    trunc_method: str
    gauge_method: str = "qr"
    sweep: str = "snake"


def exact_rank_bound(L: int, p: int) -> int:
    """Largest possible Schmidt rank over all bonds of an L-site chain with
    local dimension p: max_k min(p^k, p^(L-k))."""
    best = 1
    for k in range(1, L):
        best = max(best, min(p ** k, p ** (L - k)))
    return best


def make_stepper(L: int, d: int, J: float, dt: float, chi: int,
                 dtype=jnp.complex128, trunc_method: str = "eigh",
                 gauge_method: str = "qr", sweep: str = "snake"
                 ) -> TEBDStepper:
    """Build a stepper; mirrors BH_tDMRG's constructor (src/BH_tDMRG.cpp:3).

    sweep="snake": the reference's sequential even-L2R / odd-R2L sweep with
    canonical-center bookkeeping (src/BH_tDMRG.cpp:127-230) — required
    whenever truncation is real (chi < exact rank bound).
    sweep="brick": gates on disjoint bonds commute exactly, so when chi >=
    the physical rank bound (no truncation ever happens) the sequential
    sweep is a serialization artifact — the same Trotter product applies as
    two vmapped brick stages (all even bonds at once, then all odd bonds),
    with exact range-projection splits and no gauge moves. Identical
    channel in exact arithmetic; ~4x less sequential work per step.
    sweep="vidal": canonical-form brick updates WITH truncation — per-bond
    Schmidt values carried in the state make every bond's truncation
    globally optimal without a roving center (see vidal.py). States are
    vidal.VidalState; step with vidal.vidal_step, engine = vidal module.
    """
    if sweep not in ("snake", "brick", "vidal"):
        raise ValueError(f"unknown sweep {sweep!r}")
    if sweep == "vidal" and trunc_method not in ("eigh", "nssub"):
        # the Hastings bond update needs the Schmidt weights themselves:
        # "eigh" keeps them as eigenvalues (vector carrier), "nssub" as a
        # matmul-only matrix square root (matrix carrier — the only form
        # available on backends with no LAPACK at all, see ops/matfree.py)
        raise ValueError("sweep='vidal' supports trunc_method 'eigh' or "
                         f"'nssub'; got {trunc_method!r}")
    if sweep == "brick" and chi < exact_rank_bound(L, d + 1):
        raise ValueError(
            f"sweep='brick' requires chi >= exact rank bound "
            f"{exact_rank_bound(L, d + 1)} (L={L}, p={d + 1}); got chi={chi}. "
            f"Use sweep='snake' when truncation is real.")
    if trunc_method == "range" and chi < exact_rank_bound(L, d + 1):
        # 'range' is an unordered range projection: exact when
        # rank(theta) <= chi, but for rank > chi it degrades to a random-
        # projection truncation that discards dominant Schmidt weight.
        # Valid only in the exact-rank regime, for every sweep.
        raise ValueError(
            f"trunc_method='range' is only exact when chi >= the exact "
            f"rank bound {exact_rank_bound(L, d + 1)} (L={L}, p={d + 1}); "
            f"got chi={chi}. Use 'eigh'/'svd'/'rsvd' when truncation is "
            f"real.")
    if sweep == "brick" and trunc_method != "range":
        # Only the 'range' split masks the junk directions QR/eigh/svd leave
        # in their factors when rank < chi; with no canonical gauge to kill
        # them, unmasked junk inflates the neighboring bond's theta rank
        # past chi on the next stage (see ops/trunc.py 'range' note).
        raise ValueError("sweep='brick' requires trunc_method='range'; "
                         f"got {trunc_method!r}")
    # Constants stay as HOST numpy arrays, placed on the device at jit
    # trace time (constant inlining); numpy leaves are valid pytree
    # leaves for jit/vmap.
    np_dtype = np.dtype(dtype)
    real_np = np.float64 if np_dtype == np.complex128 else np.float32
    gf = j_gate(J, d, dt).astype(np_dtype)
    return TEBDStepper(
        gate_fwd=gf,
        gate_bwd=np.conj(gf),
        nn1=nn1_diag(d).astype(real_np),
        L=L, p=d + 1, chi=chi, dt=float(dt), trunc_method=trunc_method,
        gauge_method=gauge_method, sweep=sweep,
    )


def _apply_bond(Ai, Aj, gate, chi, keep_left, method, renorm=True):
    """Contract two sites, apply the bond gate, truncate back to chi.

    Snake mode: the orthogonality center must lie on site i or j;
    afterwards it sits on j (keep_left=True) or i (keep_left=False),
    renormalized. Brick mode passes renorm=False (exact splits preserve the
    norm; one global normalization happens at the end of the step).
    """
    l, p, _ = Ai.shape
    _, q, r = Aj.shape
    theta = jnp.einsum('apb,bqc->apqc', Ai, Aj).reshape(l, p * q, r)
    theta = jnp.einsum('PQ,aQc->aPc', gate, theta).reshape(l * p, q * r)
    left, right = split_truncate(theta, chi, keep_left=keep_left, method=method)
    Ai_new = left.reshape(l, p, chi)
    Aj_new = right.reshape(chi, q, r)
    if not renorm:
        return Ai_new, Aj_new
    if keep_left:
        nrm = jnp.linalg.norm(Aj_new)
        Aj_new = Aj_new * jnp.where(nrm > 1e-16, 1.0 / nrm, 1.0).astype(Aj_new.dtype)
    else:
        nrm = jnp.linalg.norm(Ai_new)
        Ai_new = Ai_new * jnp.where(nrm > 1e-16, 1.0 / nrm, 1.0).astype(Ai_new.dtype)
    return Ai_new, Aj_new


def _brick_stage(T, bonds, gate, chi, method):
    """Apply the bond gate to a set of DISJOINT bonds as one vmapped batch
    (they commute exactly, so any order — including simultaneous — yields
    the same operator product as the reference's sequential sweep)."""
    if not bonds:
        return T
    Ai = jnp.stack([T[b] for b in bonds])
    Aj = jnp.stack([T[b + 1] for b in bonds])
    Ai2, Aj2 = jax.vmap(
        lambda a, b: _apply_bond(a, b, gate, chi, keep_left=True,
                                 method=method, renorm=False))(Ai, Aj)
    for k, b in enumerate(bonds):
        T[b] = Ai2[k]
        T[b + 1] = Aj2[k]
    return T


@enforce_matmul_precision
def tebd_step(st: TEBDStepper, A: jnp.ndarray, u_from, u_to,
              forward: bool = True) -> jnp.ndarray:
    """One full Trotter step. A: (L, chi, p, chi), center at site 0 on entry
    and exit. Matches BH_tDMRG::step (src/BH_tDMRG.cpp:111-124).
    """
    if st.sweep == "vidal":
        raise TypeError("sweep='vidal' states are VidalState pytrees; "
                        "step them with vidal.vidal_step")
    L, chi, method = st.L, st.chi, st.trunc_method
    gauge = st.gauge_method
    # Backward propagation negates the controls (initUGates(-from,-to),
    # src/BH_tDMRG.cpp:121) and uses the negative-dt J-gates — NOT a double
    # negation: the U-phase exponent keeps +dt.
    gate = st.gate_fwd if forward else st.gate_bwd
    uf = jnp.asarray(u_from) if forward else -jnp.asarray(u_from)
    ut = jnp.asarray(u_to) if forward else -jnp.asarray(u_to)

    ph_from = jnp.exp(-0.25j * uf * st.dt * st.nn1).astype(A.dtype)   # (p,)
    ph_to = jnp.exp(-0.25j * ut * st.dt * st.nn1).astype(A.dtype)

    # half-step interaction phases (all sites; see equivalence note above)
    A = A * ph_from[None, None, :, None]
    T = [A[i] for i in range(L)]

    if st.sweep == "brick":
        # Parallel brick stages: even bonds as one vmapped batch, then odd
        # bonds. Valid only in the no-truncation regime (checked in
        # make_stepper); gauge moves are unnecessary because no optimality-
        # sensitive truncation happens — splits are exact range
        # projections. Even-then-odd matches the reference's gate product.
        T = _brick_stage(T, list(range(0, L - 1, 2)), gate, chi, method)
        T = _brick_stage(T, list(range(1, L - 1, 2)), gate, chi, method)
        A = jnp.stack(T)
        A = A * ph_to[None, None, :, None]
        nrm = mpslib.norm(A)  # no canonical center in brick mode
        A = A.at[0].multiply(
            jnp.where(nrm > 1e-16, 1.0 / nrm, 1.0).astype(A.dtype))
        return A

    if L == 2:
        T[0], T[1] = _apply_bond(T[0], T[1], gate, chi, keep_left=False,
                                 method=method)
        pos = 0
    else:
        # even sweep, left to right (src/BH_tDMRG.cpp:141-186)
        pos = 0
        even_bonds = list(range(0, L - 1, 2))
        for b in even_bonds:
            while pos < b:
                T[pos], T[pos + 1] = mpslib.move_right(T[pos], T[pos + 1],
                                                       method=gauge)
                pos += 1
            T[b], T[b + 1] = _apply_bond(T[b], T[b + 1], gate, chi,
                                         keep_left=True, method=method)
            pos = b + 1

        # odd sweep, right to left (src/BH_tDMRG.cpp:44-58, 164-219)
        odd_bonds = list(range(L - 2 - (L % 2 == 0), 0, -2))
        for b in odd_bonds:
            while pos > b + 1:
                T[pos - 1], T[pos] = mpslib.move_left(T[pos - 1], T[pos],
                                                      method=gauge)
                pos -= 1
            T[b], T[b + 1] = _apply_bond(T[b], T[b + 1], gate, chi,
                                         keep_left=False, method=method)
            pos = b

        # gauge center back to site 0 (reference: psi.position(1))
        while pos > 0:
            T[pos - 1], T[pos] = mpslib.move_left(T[pos - 1], T[pos],
                                                  method=gauge)
            pos -= 1

    A = jnp.stack(T)
    A = A * ph_to[None, None, :, None]

    # final exact normalization (center is site 0; src/BH_tDMRG.cpp:226-229)
    nrm = jnp.linalg.norm(A[0])
    A = A.at[0].multiply(jnp.where(nrm > 1e-16, 1.0 / nrm, 1.0).astype(A.dtype))
    return A
