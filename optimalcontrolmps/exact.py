"""Exact dense state-vector propagator for small chains.

Applies the *same* Trotter product as tebd.tebd_step — D(u_to) * J_odd *
J_even * D(u_from) — to the full p**L vector, with no truncation. For L <= ~8
this is both the ground truth for validating the MPS path and a fast
path: every gate application is a (p^2 x p^2) x (p^2 x rest) matmul,
and thousands of states batch along a leading axis.

There is no reference counterpart (the reference is MPS-only); this module
exists because the flagship config (L=5, d=4 => dim 3125) is exactly solvable
and the cross-check anchors the TEBD implementation far more tightly than the
golden test vectors alone.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .ops.gates import j_gate
from .sites import nn1_diag

__all__ = ["ExactStepper", "make_exact_stepper", "exact_step",
           "statevector_nn1_total"]


def statevector_nn1_total(L: int, d: int) -> np.ndarray:
    """Diagonal of sum_i n_i(n_i-1) over the full p**L basis."""
    p = d + 1
    per_site = nn1_diag(d)
    tot = np.zeros((1,), dtype=np.float64)
    for _ in range(L):
        tot = (tot[:, None] + per_site[None, :]).reshape(-1)
    return tot


@partial(jax.tree_util.register_dataclass,
         data_fields=["gate_fwd", "gate_bwd", "nn1_total"],
         meta_fields=["L", "p", "dt"])
@dataclasses.dataclass(frozen=True)
class ExactStepper:
    gate_fwd: jnp.ndarray    # (p^2, p^2)
    gate_bwd: jnp.ndarray
    nn1_total: jnp.ndarray   # (p**L,) sum_i n_i(n_i-1) per basis state
    L: int
    p: int
    dt: float


def make_exact_stepper(L: int, d: int, J: float, dt: float,
                       dtype=jnp.complex128) -> ExactStepper:
    # host numpy constants (see tebd.make_stepper note)
    np_dtype = np.dtype(dtype)
    real_np = np.float64 if np_dtype == np.complex128 else np.float32
    gf = j_gate(J, d, dt).astype(np_dtype)
    return ExactStepper(
        gate_fwd=gf, gate_bwd=np.conj(gf),
        nn1_total=statevector_nn1_total(L, d).astype(real_np),
        L=L, p=d + 1, dt=float(dt),
    )


def _apply_bond_dense(psi, gate, i, L, p):
    """Apply a two-site gate on sites (i, i+1) to a dense vector."""
    left = p ** i
    right = p ** (L - i - 2)
    m = psi.reshape(left, p * p, right)
    m = jnp.einsum('PQ,aQb->aPb', gate, m)
    return m.reshape(-1)


def exact_step(st: ExactStepper, psi: jnp.ndarray, u_from, u_to,
               forward: bool = True) -> jnp.ndarray:
    """One Trotter step on a dense vector; same operator product as
    tebd.tebd_step (src/BH_tDMRG.cpp:111-230) with chi = infinity."""
    L, p = st.L, st.p
    # backward: negated controls with +dt phases, negative-dt J-gates
    # (matches tebd.tebd_step / src/BH_tDMRG.cpp:117-124)
    gate = st.gate_fwd if forward else st.gate_bwd
    uf = jnp.asarray(u_from) if forward else -jnp.asarray(u_from)
    ut = jnp.asarray(u_to) if forward else -jnp.asarray(u_to)

    psi = psi * jnp.exp(-0.25j * uf * st.dt * st.nn1_total).astype(psi.dtype)
    for i in range(0, L - 1, 2):         # even bonds
        psi = _apply_bond_dense(psi, gate, i, L, p)
    for i in range(L - 2 - (L % 2 == 0), 0, -2):  # odd bonds
        psi = _apply_bond_dense(psi, gate, i, L, p)
    psi = psi * jnp.exp(-0.25j * ut * st.dt * st.nn1_total).astype(psi.dtype)
    nrm = jnp.linalg.norm(psi)
    return psi * jnp.where(nrm > 1e-16, 1.0 / nrm, 1.0).astype(psi.dtype)
