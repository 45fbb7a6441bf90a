"""Two-site DMRG ground-state search in JAX.

The at-scale rebuild of InitializeState (/root/reference/include/
InitializeState.hpp:69-117, which calls ITensor `dmrg` with sweep schedule
maxm=10,20,50,maxBondDim, cutoff=threshold): for chains too large for the
exact sector diagonalization in groundstate.py (L=20, d=7, chi=200), we run
two-site DMRG on the padded fixed-rank MPS with

  * a bond-dimension-4 MPO of H = -J sum(a adag + adag a)
    + U/2 sum n(n-1)  (InitializeState.hpp:42-50),
  * Lanczos for the local two-site eigenproblem (fixed Krylov depth, all
    matvecs are einsums),
  * SVD truncation back to chi after each bond update.

Everything jits: one full sweep is a fixed chain of L-1 bond updates;
`vmap` can batch DMRG over several (J, U) pairs if boundary states for many
configurations are needed at once.
"""

from __future__ import annotations

from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp

from . import mps as mpslib
from .ops.trunc import split_truncate
from .sites import op

__all__ = ["bh_mpo", "ramp_schedule", "dmrg_ground_state",
           "initialize_state_dmrg"]


def bh_mpo(L: int, d: int, J: float, U: float, dtype=np.complex128,
           npart: int | None = None, number_penalty: float = 0.0):
    """Bose-Hubbard MPO tensors W[wl, wr, p, q], bond dim 5.

    States: 0 = finished, 1 = "a placed", 2 = "adag placed",
    3 = initial, 4 = "n placed" (number-penalty ladder).
    Boundary vectors: vL = e_3, vR = e_0.

    number_penalty lam adds lam * (N_tot - npart)^2. We do not enforce the
    U(1) symmetry by block structure (dense tensors keep shapes
    static); without it, numerical leakage into neighboring particle-number
    sectors can be *amplified* by the eigensolver when those sectors lie
    lower. The penalty term — expanded as on-site
    lam (n^2 - 2 npart n + npart^2/L) plus the pair ladder 2 lam n_i n_j —
    gaps those sectors away, after which the converged state pays zero
    penalty (it has exactly npart particles). This replaces ITensor's IQ
    quantum-number conservation (BH_sites.h:78-88) functionally.
    """
    p = d + 1
    a = op("A", d)
    adag = op("Adag", d)
    nn1 = op("N(N-1)", d)
    nmat = op("N", d)
    eye = np.eye(p)
    W = np.zeros((5, 5, p, p))
    W[0, 0] = eye
    W[3, 3] = eye
    W[3, 1] = a
    W[1, 0] = -J * adag
    W[3, 2] = adag
    W[2, 0] = -J * a
    W[3, 0] = 0.5 * U * nn1
    if number_penalty > 0.0:
        lam = number_penalty
        assert npart is not None
        W[3, 0] += lam * (nmat @ nmat - 2.0 * npart * nmat
                          + (npart ** 2 / L) * eye)
        W[3, 4] = 2.0 * lam * nmat
        W[4, 4] = eye
        W[4, 0] = nmat
    return W.astype(dtype)


def _heff_matvec(Lenv, W, Renv, theta):
    """H_eff @ theta for the two-site problem. Indices:
    Lenv[w, l, l'], W1[w, x, p, p'], W2[x, y, q, q'], Renv[y, r, r'],
    theta[l', p', q', r'] -> out[l, p, q, r]."""
    t = jnp.einsum('wlm,mPQr->wlPQr', Lenv, theta)
    t = jnp.einsum('wxpP,wlPQr->xlpQr', W, t)
    t = jnp.einsum('xyqQ,xlpQr->ylpqr', W, t)
    out = jnp.einsum('yRr,ylpqr->lpqR', Renv, t)
    return out


def _lanczos_ground(matvec, v0, k: int = 25):
    """Ground state of a Hermitian operator via fixed-depth Lanczos with
    full reorthogonalization (small k, so the QR-style cleanup is cheap)."""
    shape = v0.shape
    n = v0.size
    v0 = v0.reshape(-1)
    v0 = v0 / jnp.linalg.norm(v0)

    V = jnp.zeros((k, n), dtype=v0.dtype).at[0].set(v0)
    alpha = jnp.zeros(k, dtype=jnp.float64 if v0.dtype == jnp.complex128
                      else jnp.float32)
    beta = jnp.zeros(k, dtype=alpha.dtype)

    def body(i, carry):
        V, alpha, beta = carry
        v = V[i]
        w = matvec(v.reshape(shape)).reshape(-1)
        a = jnp.real(jnp.vdot(v, w))
        w = w - a * v
        # full reorthogonalization against all previous vectors
        coeffs = jnp.conj(V) @ w          # (k,)
        mask = (jnp.arange(k) <= i).astype(w.dtype)
        w = w - (mask * coeffs) @ V
        b = jnp.linalg.norm(w)
        nxt = jnp.where(b > 1e-12, w / jnp.where(b > 0, b, 1.0), w)
        V = jax.lax.cond(i + 1 < k, lambda V: V.at[i + 1].set(nxt),
                         lambda V: V, V)
        alpha = alpha.at[i].set(a)
        beta = beta.at[i].set(b.astype(beta.dtype))
        return V, alpha, beta

    V, alpha, beta = jax.lax.fori_loop(0, k, body, (V, alpha, beta))

    # tridiagonal eigenproblem
    Tm = jnp.diag(alpha) + jnp.diag(beta[:k - 1], 1) + jnp.diag(beta[:k - 1], -1)
    w, vecs = jnp.linalg.eigh(Tm)
    ground = vecs[:, 0].astype(v0.dtype) @ V
    nrm = jnp.linalg.norm(ground)
    ground = ground / jnp.where(nrm > 1e-12, nrm, 1.0)
    return w[0], ground.reshape(shape)


def ramp_schedule(chi: int, base=(10, 20, 50, 100, 200)):
    """The reference's DMRG bond-dimension ramp maxm = 10,20,50,100,200
    (InitializeState.hpp:53-57) capped at the target chi: every base
    entry strictly below chi, then chi itself."""
    return [m for m in base if m < chi] + [chi]


@lru_cache(maxsize=32)
def _sweep_fn(L: int, d: int, npart: int, J: float, U: float, chi: int,
              krylov: int, dtype, number_penalty: float):
    """One jitted full DMRG sweep (L->R then R->L) at fixed chi.
    Returns a callable A -> (A', energy). Cached so repeated stage runs
    reuse the compiled program."""
    p = d + 1
    np_dtype = np.dtype(dtype)
    W = jnp.asarray(bh_mpo(L, d, J, U, dtype=np_dtype, npart=npart,
                           number_penalty=number_penalty))

    wdim = W.shape[0]
    vL = np.zeros(wdim)
    vL[3] = 1.0
    vR = np.zeros(wdim)
    vR[0] = 1.0

    def left_env_init(chi):
        e = jnp.zeros((wdim, chi, chi), dtype=dtype)
        return e.at[:, 0, 0].set(jnp.asarray(vL.astype(np_dtype)))

    def right_env_init(chi):
        e = jnp.zeros((wdim, chi, chi), dtype=dtype)
        return e.at[:, 0, 0].set(jnp.asarray(vR.astype(np_dtype)))

    def push_left_env(env, A):
        # env'[x, l, l'] = env[w, m, m'] conj(A)[m,p,l] W[w,x,p,p'] A[m',p',l']
        t = jnp.einsum('wmn,nqr->wmqr', env, A)
        t = jnp.einsum('wxpq,wmqr->xmpr', W, t)
        return jnp.einsum('mpl,xmpr->xlr', jnp.conj(A), t)

    def push_right_env(env, A):
        # env'[w, l, l'] = conj(A)[l,p,n] W[w,x,p,p'] A[l',p',n'] env[x,n,n']
        t = jnp.einsum('xnN,rqN->xnrq', env, A)
        t = jnp.einsum('wxpq,xnrq->wnrp', W, t)
        return jnp.einsum('lpn,wnrp->wlr', jnp.conj(A), t)

    def sweep(A, _):
        # build all right envs
        Renvs = [None] * L
        env = right_env_init(chi)
        Renvs[L - 1] = env
        for i in range(L - 1, 0, -1):
            env = push_right_env(env, A[i])
            Renvs[i - 1] = env

        T = [A[i] for i in range(L)]
        # left-to-right sweep
        Lenv = left_env_init(chi)
        Lenvs = [Lenv]
        energy = jnp.zeros((), dtype=jnp.float64
                           if dtype == jnp.complex128 else jnp.float32)
        for b in range(L - 1):
            theta = jnp.einsum('lpm,mqr->lpqr', T[b], T[b + 1])
            mv = partial(_heff_matvec, Lenvs[b], W,
                         Renvs[b + 1] if b + 1 < L else right_env_init(chi))
            e, theta = _lanczos_ground(mv, theta, k=krylov)
            energy = e.astype(energy.dtype)
            lft, rgt = split_truncate(theta.reshape(chi * p, p * chi), chi,
                                      keep_left=True, method="svd")
            T[b] = lft.reshape(chi, p, chi)
            cen = rgt.reshape(chi, p, chi)
            nrm = jnp.linalg.norm(cen)
            T[b + 1] = cen / jnp.where(nrm > 1e-12, nrm, 1.0)
            Lenvs.append(push_left_env(Lenvs[b], T[b]))

        # right-to-left sweep
        Renv = right_env_init(chi)
        for b in range(L - 2, -1, -1):
            theta = jnp.einsum('lpm,mqr->lpqr', T[b], T[b + 1])
            mv = partial(_heff_matvec, Lenvs[b], W, Renv)
            e, theta = _lanczos_ground(mv, theta, k=krylov)
            energy = e.astype(energy.dtype)
            lft, rgt = split_truncate(theta.reshape(chi * p, p * chi), chi,
                                      keep_left=False, method="svd")
            T[b + 1] = rgt.reshape(chi, p, chi)
            cen = lft.reshape(chi, p, chi)
            nrm = jnp.linalg.norm(cen)
            T[b] = cen / jnp.where(nrm > 1e-12, nrm, 1.0)
            Renv = push_right_env(Renv, T[b + 1])

        return jnp.stack(T), energy

    return jax.jit(lambda A: sweep(A, None))


def dmrg_ground_state(L: int, d: int, npart: int, J: float, U: float,
                      chi: int, n_sweeps: int | None = None,
                      krylov: int = 25, dtype=jnp.complex128,
                      number_penalty: float = 2.0, schedule=None,
                      e_tol: float = 1e-9, verbose: bool = False,
                      return_history: bool = False):
    """Ground-state MPS via two-site DMRG. Returns (mps, energy), or
    (mps, energy, history) with return_history — history is the list of
    (chi_stage, sweep_energy) pairs, one per completed sweep.

    Sweep schedule (the reference's InitializeState.hpp:53-57 ramp):
    chi climbs 10 -> 20 -> 50 -> 100 -> 200 -> target with ONE sweep per
    intermediate stage — early sweeps run on tiny tensors, so the ramp
    is nearly free and seeds the large-chi sweeps with a converged
    small-chi state. At the target chi, sweeping continues until the
    variational energy improves by less than e_tol * max(1, |E|) per
    sweep (the convergence criterion the reference delegates to its
    fixed 5-sweep schedule), bounded by n_sweeps (default 12).

    Initial state: unit-filling-style product filled right-to-left
    (InitializeState.hpp:28-38).
    """
    if n_sweeps is None:
        n_sweeps = 12
    if schedule is None:
        schedule = ramp_schedule(chi)
    p = d + 1

    occ = [0] * L
    left = npart
    for i in range(L - 1, -1, -1):
        if left >= 1:
            occ[i] = 1
            left -= 1
    # remaining particles stacked on site 0 (npart > L case)
    occ[0] += left if left > 0 else 0
    A = jnp.asarray(mpslib.product_state(occ, p, schedule[0], dtype=dtype))

    e = None
    history = []
    for stage, chi_s in enumerate(schedule):
        if A.shape[1] < chi_s:
            A = jnp.asarray(mpslib.pad_chi(np.asarray(A), chi_s))
        sweep = _sweep_fn(L, d, npart, J, U, chi_s, krylov, dtype,
                          number_penalty)
        final = stage == len(schedule) - 1
        limit = n_sweeps if final else 1
        # convergence compares sweeps WITHIN this stage only: the energy
        # carried over from a smaller-chi stage would otherwise satisfy
        # e_tol after one sweep before the enlarged bond space is used
        e = None
        for s in range(limit):
            e_prev = e
            A, e = sweep(A)
            e = float(e)
            history.append((chi_s, e))
            if verbose:
                print(f"DMRG chi={chi_s} sweep {s + 1}: E = {e:.12f}",
                      flush=True)
            if (final and e_prev is not None
                    and abs(e_prev - e) < e_tol * max(1.0, abs(e))):
                break
    if return_history:
        return A, jnp.asarray(e), history
    return A, jnp.asarray(e)


def initialize_state_dmrg(L, d, npart, J, U, chi, dtype=None, n_sweeps=8):
    """Drop-in signature parity with groundstate.initialize_state for large
    systems."""
    import jax.numpy as jnp
    if dtype is None:
        dtype = jnp.complex128
    A, _ = dmrg_ground_state(L, d, npart, J, U, chi, n_sweeps=n_sweeps,
                             dtype=dtype)
    return A
