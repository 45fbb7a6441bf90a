"""Boundary ground-state prep as a CPU subprocess.

Ground-state prep (ramped DMRG / exact diagonalization) runs in f64 on
the CPU, once per problem, and is cached: it is off every timed path. A
JAX process cannot switch platforms after backend init, so drivers whose
default device is an accelerator shell out to

    python -m optimalcontrolmps.drivers.prep_states \
        L d npart J U_i U_f chi out.npz [chi_prep]

which forces the CPU platform BEFORE touching jax, runs the ramped DMRG
(or exact sector diag when it fits), zero-pad-embeds the states to the
requested propagation chi, and writes psi_i/psi_f (+ energies) to the
npz. The npz doubles as a cache: `ensure_boundary_states` (the library
entry) skips the subprocess when a file with matching parameters exists
— the reference's MPS serialization role (include/BH_sites.h:39-53).
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np


def compute(L: int, d: int, npart: int, J: float, u_i: float, u_f: float,
            chi: int, chi_prep: int | None = None):
    """CPU-process body: returns dict of host arrays (f64/c128)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from .. import groundstate, mps

    cp = min(chi, chi_prep) if chi_prep else chi
    out = {}
    for tag, u in (("psi_i", u_i), ("psi_f", u_f)):
        A = np.asarray(groundstate.initialize_state(L, d, npart, J,
                                                    float(u), cp))
        out[tag] = mps.pad_chi(A, chi)
    out["meta"] = np.asarray([L, d, npart, chi, cp], dtype=np.int64)
    out["controls"] = np.asarray([J, u_i, u_f], dtype=np.float64)
    return out


def ensure_boundary_states(L, d, npart, J, u_i, u_f, chi, cache_path,
                           chi_prep=None, timeout=7200):
    """Load (psi_i, psi_f) from cache_path, or compute them in a CPU
    subprocess and cache. Returns host complex128 arrays at bond
    dimension chi."""
    want_meta = np.asarray(
        [L, d, npart, chi, min(chi, chi_prep) if chi_prep else chi],
        dtype=np.int64)
    want_ctl = np.asarray([J, u_i, u_f], dtype=np.float64)
    if cache_path and os.path.exists(cache_path):
        z = np.load(cache_path)
        if (np.array_equal(z["meta"], want_meta)
                and np.allclose(z["controls"], want_ctl)):
            return z["psi_i"], z["psi_f"]
        print(f"NOTE: state cache {cache_path} has different parameters; "
              "recomputing")
    import jax
    if jax.default_backend() == "cpu":
        out = compute(L, d, npart, J, u_i, u_f, chi, chi_prep)
    else:
        args = [sys.executable, "-m",
                "optimalcontrolmps.drivers.prep_states",
                str(L), str(d), str(npart), repr(J), repr(u_i), repr(u_f),
                str(chi), cache_path]
        if chi_prep:
            args.append(str(chi_prep))
        r = subprocess.run(args, timeout=timeout, capture_output=True,
                           text=True)
        if r.returncode != 0:
            raise RuntimeError(f"prep_states subprocess failed:\n"
                               f"{r.stdout}\n{r.stderr}")
        z = np.load(cache_path)
        return z["psi_i"], z["psi_f"]
    if cache_path:
        os.makedirs(os.path.dirname(os.path.abspath(cache_path)),
                    exist_ok=True)
        np.savez(cache_path, **out)
    return out["psi_i"], out["psi_f"]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 8:
        print(__doc__)
        return 2
    L, d, npart = int(argv[0]), int(argv[1]), int(argv[2])
    J, u_i, u_f = float(argv[3]), float(argv[4]), float(argv[5])
    chi, out_path = int(argv[6]), argv[7]
    chi_prep = int(argv[8]) if len(argv) > 8 else None
    out = compute(L, d, npart, J, u_i, u_f, chi, chi_prep)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez(out_path, **out)
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
