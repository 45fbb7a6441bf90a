"""Sharded multistart optimization — the rebuild's scale-out layer.

The reference optimizes ONE ramp per process (main/OptimizeRamp.cpp); random
restarts are launched as separate jobs with different seeds
(srand(123456789*seed), OptimizeRamp.cpp:60). Here the whole multistart
fleet is a single jitted program: a (B, M) batch of GROUP coefficient
vectors, sharded over the device mesh, optimized in lockstep with vmapped
L-BFGS; best-of-batch selection is an argmin that XLA lowers to
cross-device collectives.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import engine
from ..backends import engine_for
from ..optimize.lbfgs import minimize_lbfgs
from .mesh import batch_sharding, make_mesh

__all__ = ["MultistartResult", "multistart_lbfgs", "make_train_step"]


class MultistartResult(NamedTuple):
    best_c: jnp.ndarray
    best_cost: jnp.ndarray
    all_costs: jnp.ndarray
    converged: jnp.ndarray


def _group_cost_and_grad(st, psi_i, psi_f, basis, gamma, c,
                         exact: bool = False):
    eng = engine_for(st)
    u = basis.convert_control(c)
    if exact and hasattr(eng, "cost_and_gradient_exact"):
        # machine-precision dJ/dc via autodiff through the rollout — the
        # gradient that lets L-BFGS certify convergence at tight tol
        # (see BENCH_NOTES round 3)
        J, g_u = eng.cost_and_gradient_exact(st, psi_i, psi_f, u, gamma)
        return J, basis.convert_gradient(g_u)
    g_u, (_, _, _, ov) = eng.gradient(st, psi_i, psi_f, u, gamma)
    fid = (ov * ov.conj()).real
    J = 0.5 * (1.0 - fid) + engine.regularization(u, gamma, st.dt)
    return J, basis.convert_gradient(g_u)


def multistart_lbfgs(st, psi_i, psi_f, basis, c0_batch, gamma=0.0,
                     max_iter=100, tol=1e-7, mesh=None, exact=False):
    """Optimize a batch of seeds in lockstep; returns best-of-batch.

    c0_batch: (B, M). If `mesh` is given the batch axis is sharded over the
    whole mesh (DP); on one device it's a plain vmap. Works with any
    stepper (MPS snake/vidal or fixed-N sector — engines dispatched via
    backends.engine_for); `exact=True` uses the engine's autodiff gradient
    when it has one (sector)."""
    fg = partial(_group_cost_and_grad, st, psi_i, psi_f, basis, gamma,
                 exact=exact)

    def solve_all(cs):
        res = jax.vmap(lambda c: minimize_lbfgs(fg, c, max_iter=max_iter,
                                                tol=tol))(cs)
        k = jnp.argmin(res.f)
        return MultistartResult(best_c=res.x[k], best_cost=res.f[k],
                                all_costs=res.f, converged=res.converged)

    if mesh is not None:
        sh = batch_sharding(mesh)
        c0_batch = jax.device_put(c0_batch, sh)
        return jax.jit(solve_all, in_shardings=sh)(c0_batch)
    return jax.jit(solve_all)(c0_batch)


def make_train_step(st, psi_i, psi_f, basis, gamma=1e-6, lr=50.0, mesh=None,
                    with_hessian=False):
    """One multistart optimization step as a single jitted program:

      1. batched cost+gradient, batch sharded over the full mesh (DP);
      2. gradient update of every ramp;
      3. best-of-batch cost via cross-device argmin (psum/all-gather
         inserted by XLA);
      4. optionally one exact Hessian of the current best ramp with the
         time-row batch sharded over the "rows" mesh axis (SP analogue).

    Returns step(cs) -> (cs_next, costs, best_cost[, hess_diag]).
    Used by the multi-chip dry run and as the inner loop of custom
    training-style optimizers.
    """
    fg = partial(_group_cost_and_grad, st, psi_i, psi_f, basis, gamma)
    rs = None
    if mesh is not None and with_hessian:
        from jax.sharding import NamedSharding, PartitionSpec as P
        rs = NamedSharding(mesh, P("rows"))

    def step(cs):
        J, g = jax.vmap(fg)(cs)
        cs_next = cs - lr * g
        best = jnp.argmin(J)
        best_cost = J[best]
        out = (cs_next, J, best_cost)
        if with_hessian:
            u_best = basis.convert_control(cs[best])
            H = engine.hessian(st, psi_i, psi_f, u_best, gamma,
                               row_sharding=rs)
            out = out + (jnp.diagonal(H),)
        return out

    if mesh is not None:
        sh = batch_sharding(mesh)
        return jax.jit(step, in_shardings=(sh,)), sh
    return jax.jit(step), None
