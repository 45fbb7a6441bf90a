"""Fixed particle-number sector engine: dense GEMM propagator + derivatives.

Fast path for the problem sizes the reference actually optimizes
(its flagship config is L=5, Npart=5, d=4 — README.md:30-45 of the
reference — whose U(1) sector holds only 126 states). The reference pays
the full MPS machinery (BH_tDMRG.cpp snake sweeps + denmatDecomp SVDs) for
a state that fits in a 126-vector; this module exploits the symmetry the
reference encodes in its IQTensor quantum numbers (BH_sites.h:78-88)
head-on:

* Every two-site J-gate exp(-i dt h_bond) conserves n_i + n_{i+1}, hence
  total N — its projection onto the fixed-N sector is exact.
* The J-gates are control-independent (BH_tDMRG.cpp:18-58), so the entire
  even-then-odd gate product of one Trotter step collapses into ONE
  precomputed (ns, ns) sector matrix WJ.
* The control phases D(u) = exp(-0.25j u dt sum_i n_i(n_i-1)) are diagonal
  in the Fock basis.

One Trotter step therefore is:  psi <- D(u_to) . WJ . D(u_from) . psi
— an elementwise phase, one GEMM, an elementwise phase. Batched over a
multistart axis this is a (ns, ns) x (ns, B) matmul chain: pure GEMM work
with none of the QR/eigh factorizations the MPS path needs. The operator
product is ALGEBRAICALLY IDENTICAL to tebd.tebd_step (same Trotter
splitting, src/BH_tDMRG.cpp:111-230) with chi = infinity, so it reproduces
the reference's propagator up to truncation error — validated against the
golden CostTests vectors and the MPS engine in tests/test_sector.py.

The derivative engine mirrors engine.py (OptimalControl<BH_tDMRG>,
src/OptimalControl.cpp): adjoint gradient (204-249), vmapped-row exact
Hessian (251-372), identical regularization stencils.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp

from .engine import (regularization, regularization_grad,
                     regularization_hessian, resolve_use_remat)
from .groundstate import sector_basis, sector_hamiltonian
from .ops.gates import j_gate
from .ops.precision import enforce_matmul_precision

__all__ = [
    "SectorStepper", "make_sector_stepper", "sector_step",
    "sector_ground_state", "rollout", "rollout_final", "costate_rollout",
    "cost", "fidelities", "gradient", "gradient_lowmem",
    "cost_and_gradient", "cost_and_gradient_exact", "hessian",
    "SECTOR_MAX_DIM",
]

# above this sector dimension the precomputed WJ (ns^2 complex) and the
# host-side gate-product build stop being cheap; use the MPS engine
SECTOR_MAX_DIM = 4096


@lru_cache(maxsize=32)
def _sector_jgate_product(L: int, d: int, npart: int, J: float,
                          dt: float) -> np.ndarray:
    """(ns, ns) matrix of (odd-bond J-gates) . (even-bond J-gates) in the
    sector basis — the constant part of one Trotter step
    (src/BH_tDMRG.cpp:18-58 prebuilds these gates; we prebuild their
    product). Host-side numpy, cached per problem."""
    states, _ = sector_basis(L, d, npart)
    states = np.asarray(states)
    ns = states.shape[0]
    p = d + 1
    lookup = {tuple(int(x) for x in s): k for k, s in enumerate(states)}
    g = j_gate(J, d, dt)  # (p*p, p*p), exp(-i dt h_bond)

    def bond_matrix(i: int) -> np.ndarray:
        W = np.zeros((ns, ns), dtype=np.complex128)
        for k in range(ns):
            s = states[k]
            a, b = int(s[i]), int(s[i + 1])
            col = g[:, a * p + b]  # amplitudes to all (c, dd)
            tot = a + b
            lo = max(0, tot - d)
            hi = min(d, tot)
            for c in range(lo, hi + 1):
                dd = tot - c
                amp = col[c * p + dd]
                if amp == 0.0:
                    continue
                t = s.copy()
                t[i], t[i + 1] = c, dd
                W[lookup[tuple(int(x) for x in t)], k] += amp
        return W

    # even bonds L->R then odd bonds R->L (order within a stage is
    # irrelevant: disjoint-bond gates commute) — src/BH_tDMRG.cpp:127-230
    WJ = np.eye(ns, dtype=np.complex128)
    for i in range(0, L - 1, 2):
        WJ = bond_matrix(i) @ WJ
    for i in range(1, L - 1, 2):
        WJ = bond_matrix(i) @ WJ
    return WJ


@partial(jax.tree_util.register_dataclass,
         data_fields=["WJ_fwd", "WJ_bwd", "nn1", "occ", "nn1_vals",
                      "nn1_inv", "WJ_fwd_p", "WJ_bwd_p", "nn1_p",
                      "nn1_inv_p"],
         meta_fields=["L", "d", "npart", "ns", "ns_p", "dt"])
@dataclasses.dataclass(frozen=True)
class SectorStepper:
    """Precomputed step constants (the sector analogue of TEBDStepper).

    The `*_p` fields are the same constants zero/identity-padded to
    ns_p = the next multiple of 128 (only when ns >= 64; below that the
    padding costs more than it saves). The scan chains run on padded
    vectors — GEMMs of whole 128-wide tiles, also a power-of-two width
    should a kernel take the chain over — padding inputs once and slicing
    outputs. When no padding applies the `*_p` fields alias
    the logical ones.
    """
    WJ_fwd: jnp.ndarray   # (ns, ns) J-gate product
    WJ_bwd: jnp.ndarray   # conj (inverse product, for co-state sweeps)
    nn1: jnp.ndarray      # (ns,) sum_i n_i(n_i-1) per sector state
    occ: jnp.ndarray      # (ns, L) occupation numbers per sector state
    nn1_vals: jnp.ndarray  # (k,) DISTINCT values of nn1 (k ~ #partitions)
    nn1_inv: jnp.ndarray   # (ns,) index of each state's nn1 into nn1_vals
    WJ_fwd_p: jnp.ndarray  # (ns_p, ns_p), identity on the pad block
    WJ_bwd_p: jnp.ndarray
    nn1_p: jnp.ndarray     # (ns_p,), zero on the pad block
    nn1_inv_p: jnp.ndarray  # (ns_p,), pad entries index a 0.0 in nn1_vals
    L: int
    d: int
    npart: int
    ns: int
    ns_p: int
    dt: float


def make_sector_stepper(L: int, d: int, npart: int, J: float, dt: float,
                        dtype=jnp.complex128) -> SectorStepper:
    states, _ = sector_basis(L, d, npart)
    states = np.asarray(states)
    ns = states.shape[0]
    if ns > SECTOR_MAX_DIM:
        raise ValueError(
            f"sector dim {ns} > SECTOR_MAX_DIM={SECTOR_MAX_DIM}; "
            "use the MPS engine (tebd/engine) for this problem size")
    np_dtype = np.dtype(dtype)
    real_np = np.float64 if np_dtype == np.complex128 else np.float32
    WJ = _sector_jgate_product(L, d, npart, float(J), float(dt))
    nn1 = np.sum(states * (states - 1.0), axis=1)
    # nn1 takes only ~#partitions distinct values (6 for the flagship);
    # computing the control phases on the distinct values and gathering
    # cuts the per-step transcendental count by ns/k ~ 20x
    vals, inv = np.unique(nn1, return_inverse=True)

    # explicit 128-lane padding (see SectorStepper docstring)
    ns_p = int(-(-ns // 128) * 128) if ns >= 64 else ns
    if ns_p > ns:
        WJp = np.eye(ns_p, dtype=WJ.dtype)
        WJp[:ns, :ns] = WJ
        nn1_p = np.concatenate([nn1, np.zeros(ns_p - ns, nn1.dtype)])
        # pad states carry phase exp(0) = 1: their nn1 must gather a 0.0
        zw = np.where(vals == 0.0)[0]
        if zw.size == 0:
            vals = np.concatenate([vals, [0.0]])
            zi = vals.size - 1
        else:
            zi = int(zw[0])
        inv_p = np.concatenate([inv, np.full(ns_p - ns, zi, inv.dtype)])
    else:
        WJp, nn1_p, inv_p = WJ, nn1, inv

    # host numpy constants; device placement at jit trace time (see
    # tebd.make_stepper)
    return SectorStepper(
        WJ_fwd=WJ.astype(np_dtype), WJ_bwd=np.conj(WJ).astype(np_dtype),
        nn1=nn1.astype(real_np), occ=states.astype(real_np),
        nn1_vals=vals.astype(real_np),
        nn1_inv=inv.astype(np.int32),
        WJ_fwd_p=WJp.astype(np_dtype), WJ_bwd_p=np.conj(WJp).astype(np_dtype),
        nn1_p=nn1_p.astype(real_np), nn1_inv_p=inv_p.astype(np.int32),
        L=L, d=d, npart=npart, ns=ns, ns_p=ns_p, dt=float(dt))


def sector_ground_state(L: int, d: int, npart: int, J: float, U: float,
                        dtype=jnp.complex128) -> np.ndarray:
    """(ns,) exact sector ground state (InitializeState parity without the
    MPS detour; same matrix groundstate.ground_statevector diagonalizes)."""
    H = sector_hamiltonian(L, d, npart, J, U)
    w, v = np.linalg.eigh(H)
    g = v[:, 0]
    k = int(np.argmax(np.abs(g)))
    g = g * np.sign(g[k])
    return g.astype(np.dtype(dtype))


def expectation_n(st: SectorStepper, psi: jnp.ndarray) -> jnp.ndarray:
    """Per-site <n_i> of an (ns,) sector vector (expectationValues parity,
    /root/reference/include/correlations.hpp:99-117). Diagonal in the Fock
    basis: sum_k |psi_k|^2 occ[k, i]."""
    w = (psi * psi.conj()).real
    return w @ st.occ


def _inv(st: SectorStepper, padded: bool) -> jnp.ndarray:
    return st.nn1_inv_p if padded else st.nn1_inv


def _phase(st: SectorStepper, u, dtype, padded: bool = False) -> jnp.ndarray:
    """(ns,) diagonal half-interaction phase exp(-0.25j u dt nn1), computed
    on the distinct nn1 values then gathered (20x fewer
    transcendentals)."""
    small = jnp.exp(-0.25j * u * st.dt * st.nn1_vals)
    return small[_inv(st, padded)].astype(dtype)


def _phase_p(st: SectorStepper, u, power, dtype,
             padded: bool = False) -> jnp.ndarray:
    """(ns,) gathered phase exp(-0.25j * power * u * dt * nn1). power=2 is
    the MERGED phase D(u)^2: the trailing half-phase of step i and the
    leading half-phase of step i+1 both evaluate at the same control value
    u_{i+1} (split-step evaluation, /root/reference/include/BH_tDMRG.hpp:
    10-14), so the scan chains below carry half-phased states and pay ONE
    (B, ns) elementwise pass per step instead of two."""
    small = jnp.exp((-0.25j * power * st.dt) * u * st.nn1_vals)
    return small[_inv(st, padded)].astype(dtype)


def _phase_rows(st: SectorStepper, u, power, dtype,
                padded: bool = False) -> jnp.ndarray:
    """(len(u), ns) stacked gathered phases (vectorized trajectory fix-up)."""
    small = jnp.exp((-0.25j * power * st.dt) * u[:, None] * st.nn1_vals[None])
    return small[:, _inv(st, padded)].astype(dtype)


def _pad(st: SectorStepper, v: jnp.ndarray) -> jnp.ndarray:
    """Zero-pad the last axis of a logical (ns,) / (..., ns) vector to ns_p."""
    if st.ns_p == st.ns:
        return jnp.asarray(v)
    v = jnp.asarray(v)
    widths = [(0, 0)] * (v.ndim - 1) + [(0, st.ns_p - st.ns)]
    return jnp.pad(v, widths)


def sector_step(st: SectorStepper, psi: jnp.ndarray, u_from, u_to,
                forward: bool = True) -> jnp.ndarray:
    """One Trotter step on an (ns,) sector vector. Same operator product as
    tebd.tebd_step / BH_tDMRG::step (src/BH_tDMRG.cpp:111-124): backward
    negates the controls and uses the conjugate (negative-dt) J-product.
    Accepts either logical (ns,) or padded (ns_p,) vectors — the shape is
    static at trace time, so callers that batch padded rows (hessian) pay
    no per-step pad/slice."""
    padded = psi.shape[-1] == st.ns_p and st.ns_p != st.ns
    if padded:
        W = st.WJ_fwd_p if forward else st.WJ_bwd_p
    else:
        W = st.WJ_fwd if forward else st.WJ_bwd
    uf = jnp.asarray(u_from) if forward else -jnp.asarray(u_from)
    ut = jnp.asarray(u_to) if forward else -jnp.asarray(u_to)
    psi = psi * _phase(st, uf, psi.dtype, padded)
    psi = W @ psi
    psi = psi * _phase(st, ut, psi.dtype, padded)
    # the step is unitary; normalize only to pin f32 drift
    # (the reference normalizes every step, src/BH_tDMRG.cpp:226-229)
    nrm = jnp.linalg.norm(psi)
    return psi * jnp.where(nrm > 1e-16, 1.0 / nrm, 1.0).astype(psi.dtype)


# ---------------------------------------------------------------------------
# rollouts (sector analogues of engine.rollout*)
#
# All chains below use the MERGED-PHASE formulation: the carried state is
# half-phased, h_i = D(u_i) psi_i (forward) / gx_i = D(-u_i) xi_i (backward),
# so each step is ONE GEMM + ONE gathered phase multiply (vs phase-GEMM-phase
# -norm in sector_step). Per-step normalization is dropped — every step is
# unitary, so norms drift only by f32 rounding (~1e-7/step); trajectories are
# renormalized once, vectorized, after the scan. Algebraically identical to
# chaining sector_step (validated in tests/test_sector.py).
# ---------------------------------------------------------------------------

@enforce_matmul_precision
def rollout(st: SectorStepper, psi0, u):
    """psi_t for all N_t times (calcPsi, src/OptimalControl.cpp:375-390)."""
    dtype = psi0.dtype

    def body(h, u_next):
        h = st.WJ_fwd_p @ h
        return h * _phase_p(st, u_next, 2, dtype, True), h

    h0 = _pad(st, psi0) * _phase_p(st, u[0], 1, dtype, True)
    _, traj = jax.lax.scan(body, h0, u[1:])
    # traj[i] = W h_i (pre trailing phase): psi_{i+1} = D(u_{i+1}) traj[i]
    psi = traj[:, :st.ns] * _phase_rows(st, u[1:], 1, dtype)
    nrm = jnp.linalg.norm(psi, axis=1, keepdims=True)
    psi = psi / jnp.where(nrm > 1e-16, nrm, 1.0).astype(dtype)
    return jnp.concatenate([jnp.asarray(psi0)[None], psi], axis=0)


@enforce_matmul_precision
def rollout_final(st: SectorStepper, psi0, u, use_remat=None):
    """psi(T) only. use_remat rematerializes each Trotter step under
    reverse-mode autodiff: residuals drop from O(N_t) states to O(1) —
    the long-horizon HBM policy (T=6/dt=5e-3 -> 1201 steps x batch
    copies of the (ns,) state otherwise live in HBM). None = auto via
    engine.resolve_use_remat (OCMPS_REMAT read at trace time)."""
    use_remat = resolve_use_remat(u, use_remat)
    dtype = psi0.dtype

    def step(h, u_next):
        return (st.WJ_fwd_p @ h) * _phase_p(st, u_next, 2, dtype, True)

    if use_remat:
        step = jax.checkpoint(step)

    def body(h, u_next):
        return step(h, u_next), None

    h0 = _pad(st, psi0) * _phase_p(st, u[0], 1, dtype, True)
    hT, _ = jax.lax.scan(body, h0, u[1:])
    # strip the doubled trailing phase
    psiT = hT[:st.ns] * _phase_p(st, u[-1], -1, dtype)
    nrm = jnp.linalg.norm(psiT)
    return psiT * jnp.where(nrm > 1e-16, 1.0 / nrm, 1.0).astype(dtype)


@enforce_matmul_precision
def costate_rollout(st: SectorStepper, psi_target, u):
    """xi_t backward from the target (calcXi, OptimalControl.cpp:392-407).
    Backward steps negate the controls and use the conjugate J-product
    (src/BH_tDMRG.cpp:117-124): gx_{i-1} = D(-u_{i-1})^2 (conj(WJ) gx_i)."""
    dtype = psi_target.dtype

    def body(gx, u_prev):
        gx = st.WJ_bwd_p @ gx
        return gx * _phase_p(st, u_prev, -2, dtype, True), gx

    gxN = _pad(st, psi_target) * _phase_p(st, u[-1], -1, dtype, True)
    _, traj = jax.lax.scan(body, gxN, u[:-1][::-1])
    # traj[k] = conj(WJ) gx_{i+1} for i = N-2..0: xi_i = D(-u_i) traj[k]
    xi = traj[:, :st.ns] * _phase_rows(st, u[:-1][::-1], -1, dtype)
    nrm = jnp.linalg.norm(xi, axis=1, keepdims=True)
    xi = xi / jnp.where(nrm > 1e-16, nrm, 1.0).astype(dtype)
    return jnp.concatenate([jnp.asarray(psi_target)[None], xi],
                           axis=0)[::-1]


# ---------------------------------------------------------------------------
# cost / gradient / Hessian (formulas of src/OptimalControl.cpp)
# ---------------------------------------------------------------------------

@enforce_matmul_precision
def cost(st: SectorStepper, psi0, psi_target, u, gamma, use_remat=None):
    psiT = rollout_final(st, psi0, u, use_remat=use_remat)
    ov = jnp.vdot(psi_target, psiT)
    fid = (ov * ov.conj()).real
    return 0.5 * (1.0 - fid) + regularization(u, gamma, st.dt)


@enforce_matmul_precision
def fidelities(st: SectorStepper, psi0, psi_target, u):
    psi_t = rollout(st, psi0, u)
    ovs = psi_t @ psi_target.conj()
    return (ovs * ovs.conj()).real


def fidelities_streaming(st: SectorStepper, psi0, psi_target, u):
    """API parity with engine/vidal fidelities_streaming. Sector states
    are (ns,) vectors, so the stacked trajectory is already tiny —
    this is the same computation."""
    return fidelities(st, psi0, psi_target, u)


def _div_t(st: SectorStepper, xi_t, psi_t):
    """divT_i = <xi_i| dH/du |psi_i>; dH/du = 0.5 sum_j n_j(n_j-1) is
    DIAGONAL in the Fock basis (calcDivT, OptimalControl.cpp:409-419)."""
    half = (0.5 * st.nn1)
    return jnp.sum(xi_t.conj() * half[None, :] * psi_t, axis=1)


@enforce_matmul_precision
def gradient(st: SectorStepper, psi0, psi_target, u, gamma):
    """Adjoint gradient (OptimalControl.cpp:204-249). Returns (g, aux)."""
    psi_t = rollout(st, psi0, u)
    xi_t = costate_rollout(st, psi_target, u)
    divT = _div_t(st, xi_t, psi_t)
    ov = jnp.vdot(psi_t[-1], psi_target)  # <psi(T)|psi_target>
    g_fid = st.dt * (divT * ov * 1j).real
    g = g_fid + regularization_grad(u, gamma, st.dt)
    return g, (psi_t, xi_t, divT, ov)


@enforce_matmul_precision
def gradient_lowmem(st: SectorStepper, psi0, psi_target, u, gamma):
    """Memory-light gradient: xi is never stored; divT is computed inline
    during the backward scan (the reference's BFGS mode,
    src/OptimalControl.cpp:216-229). Halves peak HBM for large multistart
    batches.

    Hot-path formulation (the bench.py workload): both sweeps carry
    HALF-PHASED states h_i = D(u_i) psi_i / gx_i = D(-u_i) xi_i, merging
    the adjacent control phases of consecutive steps into one gathered
    multiply per step, with no per-step normalization (unitary steps; f32
    drift ~1e-7/step is inside the f32 noise floor). The divT overlap is
    phase-invariant up to the residual D(-u_i)^2 twist, folded into the
    (fused) reduction:
        divT_i = <xi_i|diag|psi_i> = <gx_i| D(-u_i)^2 (0.5 nn1) |h_i>.
    Aux returns (None, None, divT, ov) — BFGS mode keeps no trajectories.
    """
    dtype = psi0.dtype
    half = 0.5 * st.nn1_p

    def fwd(h, u_next):
        h = (st.WJ_fwd_p @ h) * _phase_p(st, u_next, 2, dtype, True)
        return h, h

    h0 = _pad(st, psi0) * _phase_p(st, u[0], 1, dtype, True)
    hT, h_traj = jax.lax.scan(fwd, h0, u[1:])
    # h_t[i] = D(u_i) psi_i for i = 0..N-1
    h_t = jnp.concatenate([h0[None], h_traj], axis=0)

    def bwd(gx, inp):
        u_i, u_im1, h_im1 = inp
        gx = (st.WJ_bwd_p @ gx) * _phase_p(st, u_im1, -2, dtype, True)
        div = jnp.sum(gx.conj() * (_phase_p(st, u_im1, -2, dtype, True)
                                   * half.astype(dtype)) * h_im1)
        return gx, div

    gxN = _pad(st, psi_target) * _phase_p(st, u[-1], -1, dtype, True)
    divT_last = jnp.sum(gxN.conj() * (_phase_p(st, u[-1], -2, dtype, True)
                                      * half.astype(dtype)) * hT)
    inps = (u[1:][::-1], u[:-1][::-1], h_t[:-1][::-1])
    _, divs = jax.lax.scan(bwd, gxN, inps)
    divT = jnp.concatenate([divs[::-1], divT_last[None]])

    # ov = <psi(T)|psi_target>; psi_T = D(-u_{N-1}) hT, normalized once
    ov = jnp.vdot(hT, _phase_p(st, u[-1], 1, dtype, True)
                  * _pad(st, psi_target))
    ov = ov / jnp.maximum(jnp.linalg.norm(hT), 1e-16).astype(ov.dtype)
    g = st.dt * (divT * ov * 1j).real + regularization_grad(u, gamma, st.dt)
    return g, (None, None, divT, ov)


@enforce_matmul_precision
def cost_and_gradient(st: SectorStepper, psi0, psi_target, u, gamma):
    g, (psi_t, _, _, ov) = gradient(st, psi0, psi_target, u, gamma)
    fid = (ov * ov.conj()).real
    J = 0.5 * (1.0 - fid) + regularization(u, gamma, st.dt)
    return J, g, (psi_t, ov)


def cost_and_gradient_exact(st: SectorStepper, psi0, psi_target, u, gamma):
    """EXACT gradient of the computed cost via reverse-mode autodiff
    through the rollout scan — machine-precision dJ/du, unlike the
    analytic adjoint formula (gradient/gradient_lowmem), which mirrors the
    reference (src/OptimalControl.cpp:204-249) and carries an O(dt^2)
    discretization bias of ~1e-4 relative (the reference's own
    numeric-vs-analytic tests only assert 0.1-0.2%,
    /root/reference/tests/GradientTests.cpp:143). That bias floors
    ||g||_inf near an optimum at ~1e-6 and makes optTol=1e-8 unreachable;
    the final Newton-polish stage therefore uses THIS gradient. The
    reference cannot do this at all (no autodiff through ITensor) —
    a JAX capability, not a port. Unitary GEMM chain: no
    truncation, so backprop is exactly stable."""
    J, g = jax.value_and_grad(
        lambda uu: cost(st, psi0, psi_target, uu, gamma))(u)
    return J, g


@enforce_matmul_precision
def hessian(st: SectorStepper, psi0, psi_target, u, gamma, aux=None):
    """Exact dense Hessian by row propagation (calcHessian_*,
    src/OptimalControl.cpp:251-372), mirroring engine.hessian's batched
    formulation: a scan over time j carries ALL N_t row states (ns-vectors),
    stepping every row each j and freezing rows with i >= j. The batched
    step is one (ns, ns) x (ns, N_t) GEMM — the reference needs a thread
    pool for this (OptimalControl.cpp:305-335)."""
    u = jnp.asarray(u)
    n = u.shape[0]
    dt = st.dt
    half = 0.5 * st.nn1_p  # rows are padded to ns_p (see sector_step)

    if aux is None:
        _, aux = gradient(st, psi0, psi_target, u, gamma)
    psi_t, xi_t, divT, ov = aux
    psi_t = _pad(st, psi_t)
    xi_t = _pad(st, xi_t)

    def _apply_dh(v):
        w = half[None, :] * v
        nrm = jnp.linalg.norm(w, axis=1)
        w = w / jnp.where(nrm > 1e-300, nrm, 1.0)[:, None].astype(w.dtype)
        return w, nrm

    # xiH_j = dH |xi_j>, normalized + norm (OptimalControl.cpp:358-363)
    xiH, xiH_norm = _apply_dh(xi_t)
    # psiH_i(t_i) = dH |psi_i>, normalized (OptimalControl.cpp:256-257)
    rows, row_norm = _apply_dh(psi_t)

    idx = jnp.arange(n)

    def time_step(carry, j):
        states = carry  # (n, ns)
        stepped = jax.vmap(
            lambda r: sector_step(st, r, u[j - 1], u[j], True))(states)
        active = (idx < j)[:, None]
        states = jnp.where(active, stepped, states)
        ovs = states @ xiH[j].conj()  # <xiH_j | psiH_i(t_j)>
        return states, ovs

    # only j <= n-2 contributes (edge rows/cols stay zero,
    # src/OptimalControl.cpp:267,341-369)
    _, ov_mat = jax.lax.scan(time_step, rows, jnp.arange(1, n - 1))
    # ov_mat[j-1, i] = <xiH_j | psiH_i(t_j)>

    # diagonal terms (src/OptimalControl.cpp:259-264)
    diag_ov = jnp.sum(xiH.conj() * rows, axis=1)
    Hd = (ov * diag_ov * xiH_norm * row_norm).real - (divT * divT.conj()).real

    # off-diagonal (src/OptimalControl.cpp:267-278), j > i
    ovm = jnp.zeros((n, n), dtype=ov_mat.dtype)
    ovm = ovm.at[1:n - 1, :].set(ov_mat)  # ovm[j, i]
    val1 = (ov * ovm * xiH_norm[:, None] * row_norm[None, :]).real
    val2 = -(divT[None, :] * divT.conj()[:, None]).real  # [j, i]
    Hoff = val1 + val2

    jj = idx[:, None]
    ii = idx[None, :]
    mask = (ii >= 1) & (jj > ii) & (jj <= n - 2)
    Hoff = jnp.where(mask, Hoff, 0.0)

    H = Hoff + Hoff.T
    interior = (idx >= 1) & (idx <= n - 2)
    H = H + jnp.diag(jnp.where(interior, Hd, 0.0))
    H = H * dt * dt
    return H + regularization_hessian(n, gamma, dt, dtype=H.dtype)
