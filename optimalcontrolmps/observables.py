"""Correlation functions and physics observables.

Rebuild of /root/reference/include/correlations.hpp:10-149 on the padded
fixed-rank MPS: two-point correlators via environment contraction,
correlation matrices, condensate fraction (largest eigenvalue), per-site
expectation values and bond entanglement entropies.

Operator-ordering convention matches correlationFunction (correlations.hpp:
10-55): `correlation_function(psi, op1, i, op2, j)` returns
<psi| Op1_i Op2_j |psi> with Op2 applied first when i == j (so
("Adag", i, "A", i) gives <n_i>, making the single-particle density matrix
Hermitian with occupation diagonal).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .mps import (_left_envs, _right_envs, expectation_values,
                  entanglement_entropies)

__all__ = [
    "correlation_function", "correlation_matrix", "window_correlations",
    "condensate_fraction", "expectation_values", "entanglement_entropies",
    "mean_density_deviation", "number_fluctuation",
]


def correlation_function(psi, op1, i: int, op2, j: int):
    """<psi| Op1_i Op2_j |psi> for dense (p, p) operators, static i, j.

    Mirrors correlations.hpp:10-55 (gauge-free via environments).
    """
    op1 = jnp.asarray(op1, dtype=psi.dtype)
    op2 = jnp.asarray(op2, dtype=psi.dtype)
    if i == j:
        o = op1 @ op2  # Op2 acts first (correlations.hpp:20-22)
        lenvs = _left_envs(psi, psi)
        renvs = _right_envs(psi, psi)
        mid = jnp.einsum('ac,aqb,qp,cpd->bd', lenvs[i], psi[i].conj(), o,
                         psi[i])
        return jnp.einsum('bd,bd->', mid, renvs[i])
    if i > j:
        i, j, op1, op2 = j, i, op2, op1
    lenvs = _left_envs(psi, psi)
    renvs = _right_envs(psi, psi)
    env = jnp.einsum('ac,aqb,qp,cpd->bd', lenvs[i], psi[i].conj(), op1,
                     psi[i])
    for k in range(i + 1, j):
        env = jnp.einsum('ac,apb,cpd->bd', env, psi[k].conj(), psi[k])
    env = jnp.einsum('ac,aqb,qp,cpd->bd', env, psi[j].conj(), op2, psi[j])
    return jnp.einsum('bd,bd->', env, renvs[j])


def correlation_matrix(psi, op1, op2):
    """(L, L) matrix C_ij = <Op1_i Op2_j> (correlations.hpp:57-80):
    C_ii = <Op1 Op2> (product), C_ij for j > i, C_ji = conj(C_ij).

    One O(L^2) pass sharing left environments; all contractions batch
    under jit/vmap.
    """
    L = psi.shape[0]
    op1 = jnp.asarray(op1, dtype=psi.dtype)
    op2 = jnp.asarray(op2, dtype=psi.dtype)
    lenvs = _left_envs(psi, psi)
    renvs = _right_envs(psi, psi)

    rows = []
    for i in range(L):
        row = [None] * L
        # diagonal
        o = op1 @ op2
        mid = jnp.einsum('ac,aqb,qp,cpd->bd', lenvs[i], psi[i].conj(), o,
                         psi[i])
        row[i] = jnp.einsum('bd,bd->', mid, renvs[i])
        # upper triangle: carry the op1-inserted environment rightward
        env = jnp.einsum('ac,aqb,qp,cpd->bd', lenvs[i], psi[i].conj(), op1,
                         psi[i])
        for j in range(i + 1, L):
            term = jnp.einsum('ac,aqb,qp,cpd->bd', env, psi[j].conj(), op2,
                              psi[j])
            row[j] = jnp.einsum('bd,bd->', term, renvs[j])
            if j < L - 1:
                env = jnp.einsum('ac,apb,cpd->bd', env, psi[j].conj(),
                                 psi[j])
        rows.append(row)

    C = jnp.zeros((L, L), dtype=psi.dtype)
    for i in range(L):
        for j in range(L):
            if j >= i:
                C = C.at[i, j].set(rows[i][j])
            else:
                C = C.at[i, j].set(rows[j][i].conj())
    return C


def window_correlations(psi, op_a, op_adag, op_n, start: int, end: int):
    """Streaming quench measure: all correlators AnalyzeQuench records
    (/root/reference/main/AnalyzeQuench.cpp:128-183) for a site window,
    sharing ONE pass of environments (vs one full env rebuild per pair
    through correlation_function — O(L) contractions instead of
    O(L * window^2); this runs per Trotter step inside lax.scan).

    Returns (sp, dd, rdd) for j in (start, end]:
      sp_j  = <adag_start a_j>           single-particle correlator
      dd_j  = <n_start n_j>              density-density
      rdd_j = dd_j - <n_start><n_j>      rescaled (connected)
    All contraction-only (einsum).
    """
    op_a = jnp.asarray(op_a, dtype=psi.dtype)
    op_adag = jnp.asarray(op_adag, dtype=psi.dtype)
    op_n = jnp.asarray(op_n, dtype=psi.dtype)
    lenvs = _left_envs(psi, psi)
    renvs = _right_envs(psi, psi)

    def site_exp(j, o):
        mid = jnp.einsum('ac,aqb,qp,cpd->bd', lenvs[j], psi[j].conj(), o,
                         psi[j])
        return jnp.einsum('bd,bd->', mid, renvs[j])

    exp_n = {j: site_exp(j, op_n) for j in range(start, end + 1)}
    env_sp = jnp.einsum('ac,aqb,qp,cpd->bd', lenvs[start],
                        psi[start].conj(), op_adag, psi[start])
    env_dd = jnp.einsum('ac,aqb,qp,cpd->bd', lenvs[start],
                        psi[start].conj(), op_n, psi[start])
    sp, dd, rdd = [], [], []
    for j in range(start + 1, end + 1):
        term = jnp.einsum('ac,aqb,qp,cpd->bd', env_sp, psi[j].conj(),
                          op_a, psi[j])
        spj = jnp.einsum('bd,bd->', term, renvs[j])
        term = jnp.einsum('ac,aqb,qp,cpd->bd', env_dd, psi[j].conj(),
                          op_n, psi[j])
        ddj = jnp.einsum('bd,bd->', term, renvs[j])
        sp.append(spj.real)
        dd.append(ddj.real)
        rdd.append((ddj - exp_n[start] * exp_n[j]).real)
        if j < end:
            env_sp = jnp.einsum('ac,apb,cpd->bd', env_sp, psi[j].conj(),
                                psi[j])
            env_dd = jnp.einsum('ac,apb,cpd->bd', env_dd, psi[j].conj(),
                                psi[j])
    return jnp.stack(sp), jnp.stack(dd), jnp.stack(rdd)


def condensate_fraction(psi, op1, op2):
    """Largest eigenvalue of the correlation matrix (correlationTerm,
    correlations.hpp:82-97). For ("Adag", "A") this is the condensate
    occupation; divide by Npart for the fraction."""
    C = correlation_matrix(psi, op1, op2)
    from .ops.matfree import power_eig_max, use_matfree
    if use_matfree():
        # matmul-only route: the correlation matrix is Hermitian PSD and
        # only its TOP eigenvalue is needed
        return power_eig_max(C)
    w = jnp.linalg.eigvalsh(C)
    return w[-1].real


def mean_density_deviation(psi, n_op, filling: float = 1.0):
    """rho = sum_i |<n_i> - filling| / L (CalculateDefects.cpp:88-96)."""
    n = expectation_values(psi, n_op).real
    return jnp.mean(jnp.abs(n - filling))


def number_fluctuation(psi, n_op, nn_op):
    """sum_i (<n_i^2> - <n_i>^2) / L — the F2 defect metric
    (CalculateDefects.cpp:97-104) before normalization by its initial
    value."""
    n = expectation_values(psi, n_op).real
    n2 = expectation_values(psi, nn_op).real
    return jnp.mean(n2 - n * n)
