"""Bose-Hubbard local Hilbert space and site operators.

Dense replacement for the reference's BosonSiteSet/BosonSite
(/root/reference/include/BH_sites.h:9-177). Instead of ITensor IQTensors with
U(1) block structure, operators are dense (d+1)x(d+1) matrices: at d <= 7 the
local dimension is tiny, so dense matmuls are strictly better and
symmetry blocking would only add dynamic shapes. Particle-number conservation
is still exact in the dynamics because every gate built from these operators
commutes with total N.

Conventions match BH_sites.h:114-176:
  basis states |0>, |1>, ..., |d>  (occupation number),
  N      |n> = n |n>
  A      |n> = sqrt(n) |n-1>         (annihilation)
  Adag   |n> = sqrt(n+1) |n+1>       (creation)
  N(N-1) |n> = n(n-1) |n>            (pair counting)
  NN     |n> = n^2 |n>
  Id     = identity
"""

from __future__ import annotations

import numpy as np

__all__ = ["local_dim", "op", "n_diag", "nn1_diag", "hop_two_site"]


def local_dim(d: int) -> int:
    """Local Hilbert-space dimension for Fock cutoff d (occupations 0..d)."""
    return d + 1


def n_diag(d: int) -> np.ndarray:
    """Diagonal of the number operator: [0, 1, ..., d]."""
    return np.arange(d + 1, dtype=np.float64)


def nn1_diag(d: int) -> np.ndarray:
    """Diagonal of the pair-counting operator N(N-1): n*(n-1)."""
    n = np.arange(d + 1, dtype=np.float64)
    return n * (n - 1.0)


def op(name: str, d: int) -> np.ndarray:
    """Dense (d+1, d+1) matrix for the named site operator.

    Mirrors the operator set of BH_sites.h:114-176 ("N", "A", "Adag",
    "N(N-1)", "NN", "Id").
    """
    p = d + 1
    n = np.arange(p, dtype=np.float64)
    if name == "N":
        return np.diag(n)
    if name == "A":
        # A|n> = sqrt(n)|n-1>  =>  <n-1|A|n> = sqrt(n)
        return np.diag(np.sqrt(n[1:]), k=1)
    if name == "Adag":
        return np.diag(np.sqrt(n[1:]), k=-1)
    if name == "N(N-1)":
        return np.diag(n * (n - 1.0))
    if name == "NN":
        return np.diag(n * n)
    if name == "Id":
        return np.eye(p)
    raise ValueError(f"Operator {name!r} not recognized")


def hop_two_site(J: float, d: int) -> np.ndarray:
    """Two-site hopping Hamiltonian h = -J (A x Adag + Adag x A).

    Returns a real-symmetric (p^2, p^2) matrix, p = d+1. This is the bond
    Hamiltonian whose exponential forms the reference's J-gates
    (/root/reference/src/BH_tDMRG.cpp:18-58).
    """
    a = op("A", d)
    adag = op("Adag", d)
    h = -J * (np.kron(a, adag) + np.kron(adag, a))
    return h
