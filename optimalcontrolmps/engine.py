"""Cost / gradient / Hessian engine for MPS optimal control.

Functional JAX rebuild of OptimalControl<BH_tDMRG>
(/root/reference/include/OptimalControl.hpp:17-76,
/root/reference/src/OptimalControl.cpp). The reference is stateful and
memoized (psi_t / xi_t / divT caches keyed on a `new_control` flag); this
engine is *functional*: rollouts are `lax.scan`s returning stacked state
arrays, and callers thread values explicitly. Everything jits, vmaps over a
multistart batch axis, and shards over a device mesh.

Cost (src/OptimalControl.cpp:441-453, 89-99):
    J(u) = 0.5 * (1 - |<psi_target|psi(T)>|^2)
         + gamma/2 * sum_i (u_{i+1} - u_i)^2 / dt

Gradient (adjoint method, src/OptimalControl.cpp:204-249):
    g_i = dt * Re( <xi_i| dH/du |psi_i> * <psi(T)|psi_target> * 1j ) + reg

Hessian (row propagation, src/OptimalControl.cpp:251-372): every row i
propagates dH|psi_i> forward — embarrassingly parallel, computed here as ONE
vmapped batch of co-state rollouts instead of the reference's mutex-guarded
thread pool (src/OptimalControl.cpp:305-335).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import mps as mpslib
from .ops.precision import enforce_matmul_precision
from .tebd import TEBDStepper, tebd_step

__all__ = [
    "rollout", "rollout_final", "costate_rollout", "cost", "fidelities",
    "fidelities_streaming", "gradient", "gradient_segmented",
    "cost_and_gradient", "hessian", "hessian_streaming",
    "regularization",
    "regularization_grad", "regularization_hessian", "resolve_use_remat",
]


# ---------------------------------------------------------------------------
# rollouts
# ---------------------------------------------------------------------------

def resolve_use_remat(u, use_remat=None):
    """Shared long-horizon remat policy for autodiff cost paths (used by
    both engine.cost and sector.rollout_final). None = auto: remat on for
    N_t >= 512, overridable via OCMPS_REMAT=1/0.

    NOTE: the env var is read at TRACE time — it is baked into the jitted
    program at first compilation, so flipping it afterwards has no effect
    on already-compiled functions. Unrecognized values raise.
    """
    if use_remat is not None:
        return use_remat
    import os
    env = os.environ.get("OCMPS_REMAT")
    if env is None:
        return u.shape[0] >= 512
    if env not in ("0", "1"):
        raise ValueError(
            f"OCMPS_REMAT must be '0' or '1', got {env!r}")
    return env == "1"


@enforce_matmul_precision
def rollout(st: TEBDStepper, psi0, u):
    """Forward sweep psi_t for all N_t times (calcPsi,
    src/OptimalControl.cpp:375-390). u: (N_t,). Returns (N_t, L, chi, p, chi).
    """
    def body(psi, uu):
        nxt = tebd_step(st, psi, uu[0], uu[1], forward=True)
        return nxt, nxt

    pairs = jnp.stack([u[:-1], u[1:]], axis=1)
    _, traj = jax.lax.scan(body, psi0, pairs)
    return jnp.concatenate([psi0[None], traj], axis=0)


@enforce_matmul_precision
def rollout_final(st: TEBDStepper, psi0, u, use_remat: bool = False):
    """Forward sweep returning only psi(T) — the memory-light path used when
    intermediate states aren't needed (BFGS mode, OptimalControl.cpp:22-26).
    """
    step = tebd_step
    if use_remat:
        step = jax.checkpoint(partial(tebd_step, st), static_argnums=(3,))

        def body(psi, uu):
            return step(psi, uu[0], uu[1], True), None
    else:
        def body(psi, uu):
            return tebd_step(st, psi, uu[0], uu[1], forward=True), None

    pairs = jnp.stack([u[:-1], u[1:]], axis=1)
    psiT, _ = jax.lax.scan(body, psi0, pairs)
    return psiT


@enforce_matmul_precision
def costate_rollout(st: TEBDStepper, psi_target, u):
    """Backward sweep xi_t from the target (calcXi,
    src/OptimalControl.cpp:392-407): xi_{i-1} = step(xi_i, u_i, u_{i-1}, bwd).
    Returns (N_t, ...) ordered by time (xi_t[N_t-1] = psi_target).
    """
    def body(xi, uu):
        nxt = tebd_step(st, xi, uu[0], uu[1], forward=False)
        return nxt, nxt

    # pairs for i = N-1 .. 1: (u_i, u_{i-1})
    pairs = jnp.stack([u[1:][::-1], u[:-1][::-1]], axis=1)
    _, traj = jax.lax.scan(body, psi_target, pairs)
    return jnp.concatenate([psi_target[None], traj], axis=0)[::-1]


# ---------------------------------------------------------------------------
# regularization (exact stencils of OptimalControl.cpp:89-143)
# ---------------------------------------------------------------------------

def regularization(u, gamma, dt):
    d = jnp.diff(u)
    return 0.5 * gamma * jnp.sum(d * d) / dt


def regularization_grad(u, gamma, dt):
    """One-sided endpoint stencils exactly as OptimalControl.cpp:103-121."""
    interior = -gamma * (u[2:] + u[:-2] - 2.0 * u[1:-1]) / dt
    first = -gamma * (-5.0 * u[1] + 4.0 * u[2] - u[3] + 2.0 * u[0]) / dt
    last = -gamma * (-5.0 * u[-2] + 4.0 * u[-3] - u[-4] + 2.0 * u[-1]) / dt
    return jnp.concatenate([first[None], interior, last[None]])


def regularization_hessian(n, gamma, dt, dtype=jnp.float64):
    """Tridiagonal gamma/dt with zeroed edges (OptimalControl.cpp:125-143)."""
    g = gamma / dt
    main = jnp.zeros(n, dtype).at[1:-1].set(2.0 * g)
    off = jnp.zeros(n - 1, dtype).at[1:-1].set(-g)
    H = jnp.diag(main) + jnp.diag(off, 1) + jnp.diag(off, -1)
    # Hessian[1][0] = Hessian[n-2][n-1] = 0 (fixed endpoints)
    H = H.at[1, 0].set(0.0).at[n - 2, n - 1].set(0.0)
    # keep symmetry with the reference's asymmetric zeroing? The reference
    # zeroes only [1][0] and [N-2][N-1] (OptimalControl.cpp:138-139), leaving
    # [0][1]/[N-1][N-2] never written (zero by construction) — so the result
    # is symmetric with all four edge couplings zero. Mirror that:
    H = H.at[0, 1].set(0.0).at[n - 1, n - 2].set(0.0)
    return H


# ---------------------------------------------------------------------------
# cost / fidelity
# ---------------------------------------------------------------------------

@enforce_matmul_precision
def cost(st: TEBDStepper, psi0, psi_target, u, gamma, use_remat=None):
    """J(u) (calcCost, src/OptimalControl.cpp:441-453).

    use_remat: rematerialize each TEBD step under reverse-mode autodiff so
    the saved-residual footprint is O(1) states instead of O(N_t) — the
    long-horizon policy (T=6, dt=5e-3 -> 1201 steps at chi=200 would
    otherwise hold ~1201 copies of the MPS in HBM). None = auto via
    `resolve_use_remat` (OCMPS_REMAT read at trace time — see its
    docstring). The analytic adjoint paths (gradient/gradient_lowmem)
    never need this — they recompute by construction — so only
    autodiff-through-cost consumers pay it. NOTE: reverse-mode autodiff
    through THIS truncating MPS rollout is NaN with or without remat
    (degenerate padded-eigh JVPs); use the analytic adjoint here, and
    autodiff/remat on the sector engine.
    """
    use_remat = resolve_use_remat(u, use_remat)
    psiT = rollout_final(st, psi0, u, use_remat=use_remat)
    ov = mpslib.overlap(psi_target, psiT)
    fid = (ov * ov.conj()).real
    return 0.5 * (1.0 - fid) + regularization(u, gamma, st.dt)


@enforce_matmul_precision
def fidelities(st: TEBDStepper, psi0, psi_target, u):
    """|<psi_target|psi(t_i)>|^2 for every i (calcFidelityForAllT,
    src/OptimalControl.cpp:471-493)."""
    psi_t = rollout(st, psi0, u)
    ovs = jax.vmap(lambda p: mpslib.overlap(psi_target, p))(psi_t)
    return (ovs * ovs.conj()).real


@enforce_matmul_precision
def fidelities_streaming(st: TEBDStepper, psi0, psi_target, u):
    """fidelities() with ONE state in flight instead of the (N_t, ...)
    trajectory stack — the reference-scale HBM policy (streaming.py).
    Identical values; use for long chains / long horizons."""
    from .streaming import rollout_measure

    def measure(p):
        ov = mpslib.overlap(psi_target, p)
        return (ov * ov.conj()).real

    return rollout_measure(
        lambda p, ua, ub: tebd_step(st, p, ua, ub, forward=True),
        psi0, u, measure)


@enforce_matmul_precision
def gradient_segmented(st: TEBDStepper, psi0, psi_target, u, gamma,
                       seg=None):
    """Adjoint gradient with O(sqrt(N_t)) state memory via two-level
    checkpointing (streaming.segmented_adjoint_gradient): the forward
    pass keeps only segment-start checkpoints; the backward co-state
    sweep re-propagates one segment at a time. Same formula/values as
    gradient(); one extra forward rollout of cost.
    Returns (g, (psiT, divT, ov))."""
    from .streaming import segmented_adjoint_gradient
    half_nn1 = 0.5 * st.nn1
    return segmented_adjoint_gradient(
        lambda p, ua, ub: tebd_step(st, p, ua, ub, forward=True),
        lambda x, ui, uim1: tebd_step(st, x, ui, uim1, forward=False),
        lambda x, p: mpslib.sandwich_site_sum(x, p, half_nn1),
        lambda pT, tgt: mpslib.overlap(pT, tgt),
        lambda uu: regularization_grad(uu, gamma, st.dt),
        psi0, psi_target, u, st.dt, seg=seg)


# ---------------------------------------------------------------------------
# gradient
# ---------------------------------------------------------------------------

def _div_t(st: TEBDStepper, xi_t, psi_t):
    """divT_i = <xi_i| dH/du |psi_i>, dH/du = sum_j 0.5 n_j(n_j-1)
    (calcDivT, src/OptimalControl.cpp:409-419)."""
    half_nn1 = 0.5 * st.nn1
    return jax.vmap(lambda x, p: mpslib.sandwich_site_sum(x, p, half_nn1))(
        xi_t, psi_t)


@enforce_matmul_precision
def gradient(st: TEBDStepper, psi0, psi_target, u, gamma):
    """Analytic gradient dJ/du (calcAnalyticGradient + calcFidelityGrad,
    src/OptimalControl.cpp:204-249, 456-467).
    Returns (grad, aux) with aux = (psi_t, xi_t, divT, overlapFactor) so the
    Hessian can reuse the sweeps (the reference's memoization, made explicit).
    """
    psi_t = rollout(st, psi0, u)
    xi_t = costate_rollout(st, psi_target, u)
    divT = _div_t(st, xi_t, psi_t)
    ov = mpslib.overlap(psi_t[-1], psi_target)  # <psi(T)|psi_target>
    g_fid = st.dt * (divT * ov * 1j).real
    g = g_fid + regularization_grad(u, gamma, st.dt)
    return g, (psi_t, xi_t, divT, ov)


@enforce_matmul_precision
def gradient_lowmem(st: TEBDStepper, psi0, psi_target, u, gamma):
    """Memory-light gradient: xi is never stored; divT is computed inline
    during a single backward scan — the reference's BFGS mode
    (src/OptimalControl.cpp:216-229). Stores only psi_t (as the reference
    does); use this for long horizons where stacking xi_t hurts HBM.
    """
    half_nn1 = 0.5 * st.nn1
    psi_t = rollout(st, psi0, u)
    n = u.shape[0]

    def body(xi, inp):
        u_i, u_im1, psi_im1 = inp
        xi_next = tebd_step(st, xi, u_i, u_im1, forward=False)
        div = mpslib.sandwich_site_sum(xi_next, psi_im1, half_nn1)
        return xi_next, div

    divT_last = mpslib.sandwich_site_sum(psi_target, psi_t[-1], half_nn1)
    inps = (u[1:][::-1], u[:-1][::-1], psi_t[:-1][::-1])
    _, divs = jax.lax.scan(body, psi_target, inps)
    divT = jnp.concatenate([divs[::-1], divT_last[None]])

    ov = mpslib.overlap(psi_t[-1], psi_target)
    g = st.dt * (divT * ov * 1j).real + regularization_grad(u, gamma, st.dt)
    return g, (psi_t, None, divT, ov)


@enforce_matmul_precision
def cost_and_gradient(st: TEBDStepper, psi0, psi_target, u, gamma):
    """Fused cost+gradient sharing one forward sweep (the production path —
    reference computes these separately through its cache)."""
    g, (psi_t, _, _, ov) = gradient(st, psi0, psi_target, u, gamma)
    fid = (ov * ov.conj()).real
    J = 0.5 * (1.0 - fid) + regularization(u, gamma, st.dt)
    return J, g


# ---------------------------------------------------------------------------
# Hessian — vmapped row propagation
# ---------------------------------------------------------------------------

@enforce_matmul_precision
def hessian(st: TEBDStepper, psi0, psi_target, u, gamma, aux=None,
            row_sharding=None):
    """Exact dense Hessian of J (calcHessian_*, src/OptimalControl.cpp:
    251-372), rows batched with vmap instead of threads.

    Row i of the fidelity Hessian needs psiH_i(t_j) = U(t_j <- t_i) dH psi_i
    for all j > i. We propagate ALL rows simultaneously: a scan over time j
    carrying the (N_t, ...) batch of row states, stepping every row each j
    and freezing rows with i >= j via lax.select. That is N_t^2 total steps
    (vs N_t^2/2 sequential in the reference) but fully batched GEMMs.

    `row_sharding`: optional NamedSharding for the (N_t, L, chi, p, chi) row
    batch — shards the time axis across a mesh axis (sequence-parallel
    analogue; the reference's mutex-guarded thread pool,
    src/OptimalControl.cpp:305-335, becomes XLA-inserted collectives).
    """
    u = jnp.asarray(u)  # allow numpy controls from eager callers: the
    # scan body indexes u with traced j
    n = u.shape[0]
    dt = st.dt
    half_nn1 = 0.5 * st.nn1

    if aux is None:
        psi_t = rollout(st, psi0, u)
        xi_t = costate_rollout(st, psi_target, u)
        divT = _div_t(st, xi_t, psi_t)
        ov = mpslib.overlap(psi_t[-1], psi_target)
    else:
        psi_t, xi_t, divT, ov = aux

    # xiH_j = dH |xi_j>, normalized + norm (exactApplyMPO at
    # src/OptimalControl.cpp:358-363)
    xiH, xiH_norm = jax.vmap(
        lambda x: mpslib.apply_site_sum_diag(x, half_nn1,
                                             method=st.trunc_method))(xi_t)

    # psiH_i(0) = dH |psi_i>, normalized + norm (src/OptimalControl.cpp:256)
    rows, row_norm = jax.vmap(
        lambda p: mpslib.apply_site_sum_diag(p, half_nn1,
                                             method=st.trunc_method))(psi_t)
    if row_sharding is not None:
        rows = jax.lax.with_sharding_constraint(rows, row_sharding)

    step_batch = jax.vmap(lambda A, a, b: tebd_step(st, A, a, b, True),
                          in_axes=(0, None, None))
    idx = jnp.arange(n)

    def time_step(carry, j):
        states = carry
        stepped = step_batch(states, u[j - 1], u[j])
        active = (idx < j)[:, None, None, None, None]
        states = jnp.where(active, stepped, states)
        # overlap of every row state with xiH_j
        ovs = jax.vmap(lambda s: mpslib.overlap(xiH[j], s))(states)
        return states, ovs

    # only j <= n-2 contributes (edge rows/cols stay zero,
    # src/OptimalControl.cpp:267,341-369)
    _, ov_mat = jax.lax.scan(time_step, rows, jnp.arange(1, n - 1))
    # ov_mat[j-1, i] = <xiH_j | psiH_i(t_j)> (normalized states)

    # diagonal terms (src/OptimalControl.cpp:259-264):
    diag_ov = jax.vmap(lambda x, r: mpslib.overlap(x, r))(xiH, rows)
    Hd = (ov * diag_ov * xiH_norm * row_norm).real - (divT * divT.conj()).real

    # off-diagonal (src/OptimalControl.cpp:267-278): for j > i
    # val1 = Re(ov * <xiH_j|psiH_i(t_j)> * xiH_norm_j * row_norm_i)
    # val2 = -Re(divT_i * conj(divT_j))
    ovm = jnp.zeros((n, n), dtype=ov_mat.dtype)
    ovm = ovm.at[1:n - 1, :].set(ov_mat)  # ovm[j, i]
    val1 = (ov * ovm * xiH_norm[:, None] * row_norm[None, :]).real
    val2 = -(divT[None, :] * divT.conj()[:, None]).real  # [j, i]
    Hoff = val1 + val2

    jj = idx[:, None]
    ii = idx[None, :]
    # interior rows/cols only: 1 <= i < j <= n-2
    mask = (ii >= 1) & (jj > ii) & (jj <= n - 2)
    Hoff = jnp.where(mask, Hoff, 0.0)

    H = Hoff + Hoff.T
    interior = (idx >= 1) & (idx <= n - 2)
    H = H + jnp.diag(jnp.where(interior, Hd, 0.0))
    H = H * dt * dt
    H = H + regularization_hessian(n, gamma, dt, dtype=H.dtype)
    return H


# ---------------------------------------------------------------------------
# streaming exact Hessian (block-resident rows; see streaming.BlockHessian)
# ---------------------------------------------------------------------------

_BLOCK_HESS_CACHE: dict = {}


def _block_hessian_for(st: TEBDStepper, n: int, R: int):
    """One compiled BlockHessian program set per (stepper, N_t, R) —
    cached so every optimizer iteration reuses the same four XLA
    programs (the cache entry keeps a strong ref to st so id() is
    stable)."""
    key = (id(st), n, R)
    hit = _BLOCK_HESS_CACHE.get(key)
    if hit is not None:
        return hit[0]
    from .streaming import BlockHessian
    half_nn1 = 0.5 * st.nn1
    bh = BlockHessian(
        n, R,
        fwd=lambda s, a, b: tebd_step(st, s, a, b, forward=True),
        bwd=lambda s, a, b: tebd_step(st, s, a, b, forward=False),
        get_b=lambda s: s,
        apply_dh=lambda B: mpslib.apply_site_sum_diag(
            B, half_nn1, method=st.trunc_method),
        row_step=jax.vmap(lambda A, a, b: tebd_step(st, A, a, b, True),
                          in_axes=(0, None, None)))
    _BLOCK_HESS_CACHE[key] = (bh, st)
    return bh


@enforce_matmul_precision
def hessian_streaming(st: TEBDStepper, psi0, psi_target, u, gamma,
                      aux=None, row_block: int = 64, progress=None):
    """engine.hessian with O(row_block) live states instead of O(N_t) —
    the only exact-Hessian path that fits reference scale (N=20,
    chi>=128, N_t=601) in HBM. Host-driven: S(S+1)/2 fixed-shape block
    dispatches assemble the (N_t, N_t) GRAPE Hessian on the host (NOT
    jittable as a whole — pair it with the host-mode interior point,
    optimize.minimize_interior_point_host).

    aux: (psiT, divT, ov) from gradient_segmented (reused when the
    caller just evaluated the gradient); recomputed when None.
    Returns a host numpy (N_t, N_t) array in u's real dtype.
    """
    import numpy as np
    from .streaming import assemble_hessian, pick_row_block
    u = jnp.asarray(u)
    n = u.shape[0]
    R = pick_row_block(n - 1, row_block)
    from .ops import complex_io as cio
    if aux is None:
        # jit the recompute with the states as ARGUMENTS: un-traced lax
        # tails would execute op-by-op, and device-array closures would
        # be embedded as program constants
        _, aux = jax.jit(lambda p0, pt, uu: gradient_segmented(
            st, p0, pt, uu, gamma))(psi0, psi_target, u)
    _, divT, ov = aux
    bh = _block_hessian_for(st, n, R)
    ovm, row_n, xih_n, diag_ov = bh.ov_data(psi0, psi_target, u,
                                            progress=progress)
    real = np.float64 if u.dtype == jnp.float64 else np.float32
    reg = np.asarray(regularization_hessian(n, gamma, st.dt,
                                            dtype=jnp.float64))
    return assemble_hessian(ovm, row_n, xih_n, diag_ov,
                            cio.get(divT), complex(cio.get(ov)), st.dt,
                            reg_hess=reg).astype(real)
