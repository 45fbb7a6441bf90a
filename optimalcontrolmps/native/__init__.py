"""ctypes bindings for the native host kernels (libocmps_native.so).

`load()` runs `make -C optimalcontrolmps/native` before it opens the
library (a no-op when the library is newer than its source), so a library
built from an older `ocmps_native.cpp` is never loaded. Every entry point
has a pure-numpy fallback in groundstate.py / seeds.py, used when the
build fails (no compiler); the native paths take over for large sectors
where Python enumeration is the bottleneck.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libocmps_native.so")
_lib = None


def _build():
    subprocess.run(["make", "-C", _DIR], check=True,
                   capture_output=True, text=True)


def load():
    """Load the native library, rebuilt first if its source changed;
    None if it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    try:
        _build()
    except (OSError, subprocess.CalledProcessError):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    lib.ocmps_sector_count.restype = ctypes.c_int64
    lib.ocmps_sector_count.argtypes = [ctypes.c_int] * 3
    lib.ocmps_sector_enumerate.restype = ctypes.c_int64
    lib.ocmps_sector_enumerate.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.ocmps_sector_hamiltonian.restype = ctypes.c_int64
    lib.ocmps_sector_hamiltonian.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double)]
    lib.ocmps_linsigmoid_batch.restype = None
    lib.ocmps_linsigmoid_batch.argtypes = [
        ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64, ctypes.POINTER(ctypes.c_double)]
    _lib = lib
    return lib


def sector_count(L: int, d: int, npart: int) -> int | None:
    lib = load()
    if lib is None:
        return None
    return int(lib.ocmps_sector_count(L, d, npart))


def sector_basis(L: int, d: int, npart: int):
    """(states uint8 (n, L), flat int64 (n,)) like groundstate.sector_basis;
    None if the native lib is unavailable."""
    lib = load()
    if lib is None:
        return None
    n = lib.ocmps_sector_count(L, d, npart)
    states = np.empty((n, L), dtype=np.uint8)
    got = lib.ocmps_sector_enumerate(
        L, d, npart, states.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n)
    assert got == n, (got, n)
    p = d + 1
    weights = (p ** np.arange(L - 1, -1, -1)).astype(np.int64)
    flat = states.astype(np.int64) @ weights
    return states, flat


def sector_hamiltonian_coo(L: int, d: int, npart: int, J: float, U: float):
    """(rows, cols, vals, n_states) in COO form; None if unavailable."""
    lib = load()
    if lib is None:
        return None
    out = sector_basis(L, d, npart)
    states, _ = out
    n = states.shape[0]
    cap = n * (1 + 2 * (L - 1))
    rows = np.empty(cap, dtype=np.int64)
    cols = np.empty(cap, dtype=np.int64)
    vals = np.empty(cap, dtype=np.float64)
    nnz = lib.ocmps_sector_hamiltonian(
        L, d, npart, states.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, J, U,
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return rows[:nnz], cols[:nnz], vals[:nnz], n


def linsigmoid_batch(u_start: float, u_end: float, length: int, batch: int,
                     seed: int = 0):
    lib = load()
    if lib is None:
        return None
    out = np.empty((batch, length), dtype=np.float64)
    lib.ocmps_linsigmoid_batch(
        u_start, u_end, length, batch, seed,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out
