"""Shared driver setup: config -> physics problem.

Mirrors the common preamble of every reference executable
(main/OptimizeRamp.cpp:27-90): parse the InputFile, build the site space,
seed ramp, basis, boundary ground states and stepper. The physics constants
J = 1.0, U_i = 2.5, U_f = 50 are hardcoded exactly as in the reference
(OptimizeRamp.cpp:36-38).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import control as controllib
from .. import groundstate, seeds, tebd
from ..backends import sector_fits
from ..config import InputGroup

J_HOP = 1.0
U_INITIAL = 2.5
U_FINAL = 50.0


def setup_precision(cfg: InputGroup) -> str:
    """Make the config's `precision` key honest.

    The reference is f64 LAPACK throughout; `precision = double` (the
    default) must actually run in f64/c128, so it enables x64. Both
    precisions run on JAX's default device; a `backend <name>` key (e.g.
    `backend cpu`) selects another platform explicitly. Called by every
    driver main BEFORE any jax array is built. Returns the precision
    string.
    """
    import jax

    prec = cfg.get_string("precision", "double")
    backend = cfg.get_string("backend", "")
    if backend:
        jax.config.update("jax_platforms", backend)
        want = backend.split(",")[0]
        active = jax.default_backend()
        if active != {"cuda": "gpu", "rocm": "gpu"}.get(want, want):
            raise RuntimeError(
                f"requested backend '{backend}' but the active "
                f"platform is '{active}' (backends already initialized?); "
                "set the backend before any jax computation")
    if prec == "double":
        jax.config.update("jax_enable_x64", True)
    return prec


@dataclasses.dataclass
class ProblemSetup:
    cfg: InputGroup
    L: int
    npart: int
    d: int
    T: float
    tstep: float
    n_steps: int
    M: int
    gamma: float
    chi: int
    threshold: float
    stepper: object
    psi_i: object
    psi_f: object
    basis: object
    u0: np.ndarray
    seed: int
    dtype: object
    kind: str = "mps"  # "mps" (TEBD engine) or "sector" (fixed-N GEMM)


def effective_chi(max_bond_dim: int, L: int, p: int) -> int:
    """Static bond dimension: the requested maxBondDim capped at the exact
    maximal Schmidt rank p**(L//2) (beyond which padding is pure waste —
    ITensor's adaptive truncation never exceeds it either)."""
    cap = p ** (L // 2)
    return int(min(max_bond_dim, cap))


def build_problem(cfg: InputGroup, seed: int = 1, dtype=None,
                  u0=None, engine: str = "mps",
                  state_cache: str = None) -> ProblemSetup:
    """engine: "mps" (reference-faithful snake TEBD path — required by the
    analysis drivers that compute MPS observables), "vidal" (canonical-form
    parallel-brick TEBD with truncation — the long-chain production path,
    see vidal.py), "sector" (fixed-N GEMM engine, see sector.py), or
    "auto" (sector when the U(1) sector fits on chip, else mps).

    state_cache: optional npz path for the boundary ground states — loaded
    when present with a matching problem fingerprint, else computed and
    saved. Resume runs skip the DMRG/eigh state prep entirely (the
    reference's MPS read() serialization, include/BH_sites.h:39-53)."""
    import jax.numpy as jnp

    from .. import io as iolib

    tstep = cfg.get_real("tstep", 1e-2)
    T = cfg.get_real("T")
    L = cfg.get_int("N")
    npart = cfg.get_int("Npart")
    d = cfg.get_int("d")
    M = cfg.get_int("M", 1)
    gamma = cfg.get_real("gamma", 0.0)
    max_bond = cfg.get_int("maxBondDim", 100)
    threshold = cfg.get_real("threshold", 1e-7)

    if dtype is None:
        prec = cfg.get_string("precision", "double")
        dtype = jnp.complex128 if prec == "double" else jnp.complex64
    real = np.float64 if np.dtype(dtype) == np.complex128 else np.float32

    n_steps = int(T / tstep + 1)
    chi = effective_chi(max_bond, L, d + 1)

    # reference: srand(123456789*seed) then linsigmoidSeed
    # (OptimizeRamp.cpp:60,83); counter-based numpy RNG replaces libc rand
    rng = np.random.default_rng(123456789 * seed)
    if u0 is None:
        u0 = seeds.linsigmoid_seed(U_INITIAL, U_FINAL, n_steps, rng=rng)

    basis = controllib.chopped_sine_basis(u0, tstep, T, M, dtype=real)
    if engine == "auto":
        # Pick the exact (chi = infinity) sector engine only when the MPS
        # path would be truncation-free anyway (effective chi >= the exact
        # Schmidt rank bound) — otherwise the config's maxBondDim is a real
        # truncation channel and auto must honor it (ADVICE.md round 1).
        truncation_free = chi >= tebd.exact_rank_bound(L, d + 1)
        engine = ("sector" if sector_fits(L, d, npart) and truncation_free
                  else "mps")
    elif engine == "sector" and chi < tebd.exact_rank_bound(L, d + 1):
        print(f"NOTE: engine=sector is exact (chi = sector dim); "
              f"maxBondDim={max_bond} (effective chi={chi}) is superseded "
              f"and no truncation occurs.")
    trunc = cfg.get_string("truncMethod", "eigh")
    state_meta = {"L": L, "d": d, "npart": npart, "chi": chi,
                  "engine": engine, "trunc": trunc,
                  "u_ends": [float(u0[0]), float(u0[-1])],
                  "dtype": str(np.dtype(dtype))}
    cached = (iolib.load_states(state_cache, state_meta)
              if state_cache else None)

    if engine == "sector":
        from .. import sector
        stepper = sector.make_sector_stepper(L, d, npart, J_HOP, tstep,
                                             dtype=dtype)
        if cached is not None:
            psi_i, psi_f = cached
        else:
            psi_i = sector.sector_ground_state(
                L, d, npart, J_HOP, float(u0[0]), dtype=np.dtype(dtype))
            psi_f = sector.sector_ground_state(
                L, d, npart, J_HOP, float(u0[-1]), dtype=np.dtype(dtype))
    else:
        sweep = "vidal" if engine == "vidal" else "snake"
        # truncMethod (vidal): "eigh" (classic Vidal: LAPACK/cuSOLVER
        # eigh) or "nssub" (matmul-only matrix carriers, ops/matfree.py)
        stepper = tebd.make_stepper(L, d, J_HOP, tstep, chi, dtype=dtype,
                                    sweep=sweep, trunc_method=trunc)
        if cached is not None:
            psi_i, psi_f = cached
        else:
            psi_i = groundstate.initialize_state(L, d, npart, J_HOP,
                                                 float(u0[0]), chi,
                                                 dtype=dtype)
            psi_f = groundstate.initialize_state(L, d, npart, J_HOP,
                                                 float(u0[-1]), chi,
                                                 dtype=dtype)
            if engine == "vidal":
                from .. import vidal
                psi_i = vidal.from_mps(psi_i)
                psi_f = vidal.from_mps(psi_f)
                if trunc == "nssub":
                    psi_i = vidal.to_matrix_carriers(psi_i)
                    psi_f = vidal.to_matrix_carriers(psi_f)
    if state_cache and cached is None:
        iolib.save_states(state_cache, psi_i, psi_f, state_meta)

    return ProblemSetup(cfg=cfg, L=L, npart=npart, d=d, T=T, tstep=tstep,
                        n_steps=n_steps, M=M, gamma=gamma, chi=chi,
                        threshold=threshold, stepper=stepper, psi_i=psi_i,
                        psi_f=psi_f, basis=basis, u0=np.asarray(u0),
                        seed=seed, dtype=dtype, kind=engine)


def print_banner(p: ProblemSetup, extra=None):
    """Config banner like OptimizeRamp.cpp:62-79."""
    print("Performing optimal control of Bose-Hubbard model ... \n")
    print(" ******* Parameters used ******* ")
    rows = [
        ("Number of sites", p.L), ("Number of particles", p.npart),
        ("Local Fock space dimension", p.d), ("Control duration", p.T),
        ("Time-step size", p.tstep), ("GROUP dimension", p.M),
        ("Gamma (regularisation)", p.gamma),
        ("Bond dimension (static chi)", p.chi),
        ("Seed", p.seed),
    ]
    for k, v in (rows + (list(extra.items()) if extra else [])):
        print(f"{k:.<33} {v}")
    print()


def time_axis(p: ProblemSetup) -> np.ndarray:
    return np.arange(p.n_steps) * p.tstep


def exp_ramp(u_i: float, u_f: float, length: int) -> np.ndarray:
    """expRamp (AnalyzeBondDim.cpp:15-26): a*exp(b*i), b = log(Uf/Ui)/len."""
    b = np.log(u_f / u_i) / length
    return u_i * np.exp(b * np.arange(length))


def quench_ramp(u_i: float, u_f: float, length: int) -> np.ndarray:
    """quenchRamp (AnalyzeQuench.cpp:18-23): constant Uf except first."""
    r = np.full(length, u_f)
    r[0] = u_i
    return r
