"""Batched L-BFGS with strong-Wolfe line search, in pure JAX.

The gradient-path optimizer of the rebuild (the reference delegates this to
IPOPT's limited-memory mode, main/OptimizeRamp.cpp:110-112). Written as a
single `lax.while_loop` so the whole optimization — rollouts included —
compiles to one XLA program, and `vmap(minimize)` runs thousands of
multistart problems in lockstep.

History is kept in fixed (m, n) arrays with a rolling index (static shapes).
The line search is a bracketing + zoom strong-Wolfe search (c1=1e-4,
c2=0.9) with bounded iterations.

Stall recovery (round-3 fix, VERDICT.md Weak #2): a failed Wolfe search no
longer kills the solve. The search tracks the best merely-improving point it
evaluated; on Wolfe failure the optimizer accepts that point (when it
improves), drops the curvature history (forcing a steepest-descent restart
with a conservative initial step), and only terminates after `max_fails`
consecutive searches produce no improvement at all — which near the f32
noise floor is the honest "cannot make progress" criterion, and in f64
effectively never triggers before ||g||_inf < tol.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["LBFGSResult", "minimize_lbfgs", "minimize_lbfgs_batch"]


class LBFGSResult(NamedTuple):
    x: jnp.ndarray
    f: jnp.ndarray
    grad_norm: jnp.ndarray
    iterations: jnp.ndarray
    converged: jnp.ndarray
    n_evals: jnp.ndarray


def _two_loop(g, S, Y, rho, head, count, m):
    """Two-loop recursion; S/Y: (m, n), rolling buffer."""
    q = g
    alphas = jnp.zeros(m, dtype=g.dtype)

    def bwd(i, carry):
        q, alphas = carry
        # iterate newest -> oldest
        idx = (head - 1 - i) % m
        valid = i < count
        a = rho[idx] * jnp.dot(S[idx], q)
        a = jnp.where(valid, a, 0.0)
        q = q - a * Y[idx]
        alphas = alphas.at[idx].set(a)
        return q, alphas

    q, alphas = jax.lax.fori_loop(0, m, bwd, (q, alphas))

    # initial Hessian scaling gamma = s.y / y.y of newest pair
    newest = (head - 1) % m
    sy = jnp.dot(S[newest], Y[newest])
    yy = jnp.dot(Y[newest], Y[newest])
    gamma = jnp.where((count > 0) & (yy > 1e-30), sy / yy, 1.0)
    r = gamma * q

    def fwd(i, r):
        # iterate oldest -> newest
        idx = (head - count + i) % m
        valid = i < count
        b = rho[idx] * jnp.dot(Y[idx], r)
        b = jnp.where(valid, b, 0.0)
        return r + (alphas[idx] - b) * S[idx]

    r = jax.lax.fori_loop(0, m, fwd, r)
    return r


def _wolfe_search(fg, x, f0, g0, p, max_ls: int, c1=1e-4, c2=0.9, a0=None):
    """Strong-Wolfe bracketing+zoom line search. fg(x) -> (f, g).

    Returns (alpha, f_new, g_new, n_evals, ok, best_a, best_f, best_g):
    `ok` means the strong-Wolfe conditions hold at `alpha`; the `best_*`
    triple is the lowest-f point evaluated during the search regardless
    (salvage for stall recovery — initialized at (0, f0, g0))."""
    d0 = jnp.dot(g0, p)

    def eval_at(a):
        f, g = fg(x + a * p)
        return f, g, jnp.dot(g, p)

    # State: (phase, a_lo, f_lo, d_lo, a_hi, f_hi, a, f, g, d, k, done, ok)
    # phase 0 = bracketing, 1 = zoom
    def cond(s):
        return (~s["done"]) & (s["k"] < max_ls)

    def body(s):
        a = s["a"]
        f, g, d = eval_at(a)
        s = {**s, "k": s["k"] + 1}

        # salvage tracking: best strictly-improving point seen so far
        better = f < s["bf"]
        s = {**s,
             "bf": jnp.where(better, f, s["bf"]),
             "bg": jnp.where(better, g, s["bg"]),
             "ba": jnp.where(better, a, s["ba"])}

        curv_ok = jnp.abs(d) <= -c2 * d0

        def bracket_update(s):
            # bracketing phase
            fail = (f > f0 + c1 * a * d0) | ((f >= s["f_lo"]) & (s["k"] > 1))
            # if fail: zoom between (a_prev, a)
            s1 = {**s, "phase": 1, "a_hi": a, "f_hi": f, "bracketed": True}
            # if curvature satisfied: done
            s2 = {**s, "done": True, "ok": True, "xf": f, "xg": g, "alpha": a}
            # if derivative positive: zoom between (a, a_prev)
            s3 = {**s, "phase": 1, "a_hi": s["a_lo"], "f_hi": s["f_lo"],
                  "a_lo": a, "f_lo": f, "d_lo": d, "bracketed": True}
            # else: expand
            s4 = {**s, "a_lo": a, "f_lo": f, "d_lo": d, "a": 2.0 * a}
            out = jax.tree_util.tree_map(
                lambda b1, b2, b3, b4: jnp.where(fail, b1,
                                jnp.where(curv_ok, b2,
                                jnp.where(d >= 0, b3, b4))),
                s1, s2, s3, s4)
            return out

        def zoom_update(s):
            fail = (f > f0 + c1 * a * d0) | (f >= s["f_lo"])
            s1 = {**s, "a_hi": a, "f_hi": f}
            s2 = {**s, "done": True, "ok": True, "xf": f, "xg": g, "alpha": a}
            flip = d * (s["a_hi"] - s["a_lo"]) >= 0
            s3a = {**s, "a_hi": s["a_lo"], "f_hi": s["f_lo"],
                   "a_lo": a, "f_lo": f, "d_lo": d}
            s3b = {**s, "a_lo": a, "f_lo": f, "d_lo": d}
            out = jax.tree_util.tree_map(
                lambda b1, b2, b3a, b3b: jnp.where(fail, b1,
                                   jnp.where(curv_ok, b2,
                                   jnp.where(flip, b3a, b3b))),
                s1, s2, s3a, s3b)
            return out

        s = jax.tree_util.tree_map(
            lambda bz, bb: jnp.where(s["phase"] == 1, bz, bb),
            zoom_update(s), bracket_update(s))
        # next trial point in zoom = bisection
        a_next = jnp.where(s["phase"] == 1, 0.5 * (s["a_lo"] + s["a_hi"]),
                           s["a"])
        s = {**s, "a": jnp.where(s["done"], s["a"], a_next)}
        return s

    zero = jnp.zeros((), dtype=f0.dtype)
    one = jnp.ones((), dtype=f0.dtype)
    state = {
        "phase": jnp.zeros((), jnp.int32), "a_lo": zero, "f_lo": f0,
        "d_lo": d0, "a_hi": zero + 1e10, "f_hi": f0 + 1e10,
        "a": one if a0 is None else jnp.asarray(a0, f0.dtype),
        "k": jnp.zeros((), jnp.int32),
        "done": jnp.zeros((), jnp.bool_), "ok": jnp.zeros((), jnp.bool_),
        "xf": f0, "xg": g0, "alpha": zero,
        "bf": f0, "bg": g0, "ba": zero,
        "bracketed": jnp.zeros((), jnp.bool_),
    }
    state = jax.lax.while_loop(cond, body, state)
    return (state["alpha"], state["xf"], state["xg"], state["k"],
            state["ok"], state["ba"], state["bf"], state["bg"])


def minimize_lbfgs(fun_and_grad: Callable, x0, max_iter: int = 100,
                   tol: float = 1e-8, history: int = 10, max_ls: int = 20,
                   max_fails: int = 3, callback: Callable = None):
    """Minimize f via L-BFGS. fun_and_grad(x) -> (f, g). Fully jittable and
    vmappable (vmap over x0 for multistart batches).

    Convergence: ||g||_inf < tol (matching IPOPT's dual-infeasibility-style
    test at optTol, main/OptimizeRamp.cpp:105). A Wolfe-search failure
    triggers a steepest-descent restart (history dropped, conservative
    step) instead of termination; the solve only stops early after
    `max_fails` consecutive searches with no improving point.

    `callback(it, f, gnorm, ls_evals)`: optional per-iteration host
    callback (ordered io_callback — progress-cache parity with the
    reference's intermediate_callback, src/BH_nlp.cpp:291-326). Not
    supported under vmap; leave None for multistart batches.
    """
    n = x0.shape[0]
    m = history
    dtype = x0.dtype

    f0, g0 = fun_and_grad(x0)

    state = {
        "x": x0, "f": f0, "g": g0,
        "S": jnp.zeros((m, n), dtype), "Y": jnp.zeros((m, n), dtype),
        "rho": jnp.zeros(m, dtype),
        "head": jnp.zeros((), jnp.int32), "count": jnp.zeros((), jnp.int32),
        "it": jnp.zeros((), jnp.int32), "evals": jnp.ones((), jnp.int32),
        "fails": jnp.zeros((), jnp.int32),
        "done": jnp.zeros((), jnp.bool_),
        "converged": jnp.zeros((), jnp.bool_),
    }

    def cond(s):
        return (~s["done"]) & (s["it"] < max_iter)

    def body(s):
        p = -_two_loop(s["g"], s["S"], s["Y"], s["rho"], s["head"],
                       s["count"], m)
        # safeguard: descent direction
        descent = jnp.dot(p, s["g"]) < 0
        p = jnp.where(descent, p, -s["g"])

        # initial trial step: 1 with curvature history (standard L-BFGS),
        # min(1, 1/||g||_inf) on fresh/restarted iterations so raw
        # steepest descent doesn't overshoot
        gnorm0 = jnp.max(jnp.abs(s["g"]))
        a0 = jnp.where(s["count"] > 0,
                       jnp.ones((), dtype),
                       jnp.minimum(1.0, 1.0 / jnp.maximum(gnorm0, 1e-12))
                       ).astype(dtype)

        alpha, f_w, g_w, k, ok, ba, bf, bg = _wolfe_search(
            fun_and_grad, s["x"], s["f"], s["g"], p, max_ls, a0=a0)

        # salvage: when Wolfe failed but some trial improved f, take it
        improved = bf < s["f"]
        accept = ok | improved
        a_use = jnp.where(ok, alpha, ba)
        f_new = jnp.where(ok, f_w, bf)
        g_new = jnp.where(ok, g_w, bg)
        x_new = s["x"] + a_use * p

        sk = x_new - s["x"]
        yk = g_new - s["g"]
        sy = jnp.dot(sk, yk)
        # only Wolfe-certified pairs enter the history (curvature condition
        # guarantees sy > 0 up to roundoff; salvage steps don't qualify)
        good_pair = ok & (sy > 1e-12 * jnp.linalg.norm(sk)
                          * jnp.linalg.norm(yk))

        head = s["head"]
        S = jnp.where(good_pair, s["S"].at[head].set(sk), s["S"])
        Y = jnp.where(good_pair, s["Y"].at[head].set(yk), s["Y"])
        rho = jnp.where(good_pair,
                        s["rho"].at[head].set(1.0 / jnp.where(sy != 0, sy, 1.0)),
                        s["rho"])
        head = jnp.where(good_pair, (head + 1) % m, head)
        count = jnp.where(good_pair, jnp.minimum(s["count"] + 1, m),
                          s["count"])
        # Wolfe failure -> drop history, forcing steepest descent next iter
        count = jnp.where(ok, count, 0)

        fails = jnp.where(accept, 0, s["fails"] + 1)

        gnorm = jnp.max(jnp.abs(jnp.where(accept, g_new, s["g"])))
        converged = gnorm < tol
        stalled = fails >= max_fails

        it_next = s["it"] + 1
        if callback is not None:
            from jax.experimental import io_callback
            io_callback(callback, None, it_next,
                        jnp.where(accept, f_new, s["f"]), gnorm, k,
                        ordered=True)

        return {
            "x": jnp.where(accept, x_new, s["x"]),
            "f": jnp.where(accept, f_new, s["f"]),
            "g": jnp.where(accept, g_new, s["g"]),
            "S": S, "Y": Y, "rho": rho, "head": head, "count": count,
            "it": it_next, "evals": s["evals"] + k,
            "fails": fails,
            "done": converged | stalled,
            "converged": converged,
        }

    s = jax.lax.while_loop(cond, body, state)
    return LBFGSResult(x=s["x"], f=s["f"],
                       grad_norm=jnp.max(jnp.abs(s["g"])),
                       iterations=s["it"], converged=s["converged"],
                       n_evals=s["evals"])


# ---------------------------------------------------------------------------
# explicit-batch variant
# ---------------------------------------------------------------------------
#
# vmap(minimize_lbfgs) batches every per-lane op automatically — but some
# objective evaluations are written against the FULL (B, ...) batch: the
# sector chain (ops/sector_chain.py) is one custom-vjp scan of
# (B, 128) x (128, 128) GEMMs over the whole multistart batch. This variant is the same algorithm with an explicit leading
# batch axis: `fun_and_grad(X) -> (f (B,), G (B, n))` is called ONCE per
# line-search trial for the whole batch, finished lanes frozen by masks —
# exactly the lockstep semantics vmap gives, realized by hand.


def _bdot(a, b):
    return jnp.sum(a * b, axis=-1)


def _btake(A, idx):
    """A: (B, m, ...), idx: (B,) -> (B, ...) per-lane gather along axis 1."""
    idxe = idx.reshape(-1, *([1] * (A.ndim - 1)))
    return jnp.take_along_axis(A, idxe, axis=1).squeeze(1)


def _two_loop_batch(g, S, Y, rho, head, count, m):
    """Batched two-loop recursion; S/Y: (B, m, n), head/count: (B,)."""
    B = g.shape[0]
    q = g
    alphas = jnp.zeros((B, m), dtype=g.dtype)

    def bwd(i, carry):
        q, alphas = carry
        idx = (head - 1 - i) % m
        valid = (i < count)
        Si = _btake(S, idx)
        Yi = _btake(Y, idx)
        a = _btake(rho[..., None], idx)[:, 0] * _bdot(Si, q)
        a = jnp.where(valid, a, 0.0)
        q = q - a[:, None] * Yi
        alphas = jnp.where(
            (jax.lax.broadcasted_iota(jnp.int32, (B, m), 1)
             == idx[:, None]) & valid[:, None],
            a[:, None], alphas)
        return q, alphas

    q, alphas = jax.lax.fori_loop(0, m, bwd, (q, alphas))

    newest = (head - 1) % m
    Sn = _btake(S, newest)
    Yn = _btake(Y, newest)
    sy = _bdot(Sn, Yn)
    yy = _bdot(Yn, Yn)
    gamma = jnp.where((count > 0) & (yy > 1e-30), sy / yy, 1.0)
    r = gamma[:, None] * q

    def fwd(i, r):
        idx = (head - count + i) % m
        valid = (i < count)
        Si = _btake(S, idx)
        Yi = _btake(Y, idx)
        al = _btake(alphas[..., None], idx)[:, 0]
        b = _btake(rho[..., None], idx)[:, 0] * _bdot(Yi, r)
        b = jnp.where(valid, b, 0.0)
        return r + jnp.where(valid, al - b, 0.0)[:, None] * Si

    return jax.lax.fori_loop(0, m, fwd, r)


def _wolfe_search_batch(fg, x, f0, g0, p, max_ls: int, c1=1e-4, c2=0.9,
                        a0=None, active0=None):
    """Batched strong-Wolfe search. x/p: (B, n); f0: (B,). Lanes in
    `active0=False` are frozen (their fg output is ignored). Same state
    machine as _wolfe_search with per-lane phase/bracket flags."""
    B = x.shape[0]
    d0 = _bdot(g0, p)

    def cond(s):
        return jnp.any((~s["done"]) & (s["k"] < max_ls) & s["act"])

    def body(s):
        a = s["a"]
        f, g = fg(x + a[:, None] * p)
        d = _bdot(g, p)
        live = (~s["done"]) & s["act"]
        s = {**s, "k": jnp.where(live, s["k"] + 1, s["k"])}

        better = live & (f < s["bf"])
        s = {**s,
             "bf": jnp.where(better, f, s["bf"]),
             "bg": jnp.where(better[:, None], g, s["bg"]),
             "ba": jnp.where(better, a, s["ba"])}

        curv_ok = jnp.abs(d) <= -c2 * d0

        def merge(cond_vec, s_true, s_false):
            return jax.tree_util.tree_map(
                lambda t, fl: jnp.where(
                    cond_vec.reshape((B,) + (1,) * (t.ndim - 1)), t, fl),
                s_true, s_false)

        # bracketing phase
        failb = (f > f0 + c1 * a * d0) | ((f >= s["f_lo"]) & (s["k"] > 1))
        b1 = {**s, "phase": jnp.ones(B, jnp.int32), "a_hi": a, "f_hi": f}
        b2 = {**s, "done": jnp.ones(B, jnp.bool_), "ok": jnp.ones(B, jnp.bool_),
              "xf": f, "xg": g, "alpha": a}
        b3 = {**s, "phase": jnp.ones(B, jnp.int32), "a_hi": s["a_lo"],
              "f_hi": s["f_lo"], "a_lo": a, "f_lo": f, "d_lo": d}
        b4 = {**s, "a_lo": a, "f_lo": f, "d_lo": d, "a": 2.0 * a}
        sb = merge(failb, b1, merge(curv_ok, b2, merge(d >= 0, b3, b4)))

        # zoom phase
        failz = (f > f0 + c1 * a * d0) | (f >= s["f_lo"])
        z1 = {**s, "a_hi": a, "f_hi": f}
        z2 = {**s, "done": jnp.ones(B, jnp.bool_), "ok": jnp.ones(B, jnp.bool_),
              "xf": f, "xg": g, "alpha": a}
        flip = d * (s["a_hi"] - s["a_lo"]) >= 0
        z3a = {**s, "a_hi": s["a_lo"], "f_hi": s["f_lo"],
               "a_lo": a, "f_lo": f, "d_lo": d}
        z3b = {**s, "a_lo": a, "f_lo": f, "d_lo": d}
        sz = merge(failz, z1, merge(curv_ok, z2, merge(flip, z3a, z3b)))

        s_new = merge(s["phase"] == 1, sz, sb)
        a_next = jnp.where(s_new["phase"] == 1,
                           0.5 * (s_new["a_lo"] + s_new["a_hi"]), s_new["a"])
        s_new = {**s_new, "a": jnp.where(s_new["done"], s_new["a"], a_next)}
        # frozen lanes keep their old state entirely
        return merge(live, s_new, s)

    zero = jnp.zeros(B, f0.dtype)
    one = jnp.ones(B, f0.dtype)
    act = jnp.ones(B, jnp.bool_) if active0 is None else active0
    state = {
        "phase": jnp.zeros(B, jnp.int32), "a_lo": zero, "f_lo": f0,
        "d_lo": d0, "a_hi": zero + 1e10, "f_hi": f0 + 1e10,
        "a": one if a0 is None else jnp.asarray(a0, f0.dtype),
        "k": jnp.zeros(B, jnp.int32),
        "done": jnp.zeros(B, jnp.bool_), "ok": jnp.zeros(B, jnp.bool_),
        "xf": f0, "xg": g0, "alpha": zero,
        "bf": f0, "bg": g0, "ba": zero,
        "act": act,
    }
    state = jax.lax.while_loop(cond, body, state)
    return (state["alpha"], state["xf"], state["xg"], state["k"],
            state["ok"], state["ba"], state["bf"], state["bg"])


def minimize_lbfgs_batch(fun_and_grad: Callable, X0, max_iter: int = 100,
                         tol: float = 1e-8, history: int = 10,
                         max_ls: int = 20, max_fails: int = 3):
    """Batched L-BFGS: fun_and_grad(X (B, n)) -> (f (B,), G (B, n)).

    Lockstep over the batch (identical semantics to
    vmap(minimize_lbfgs)), but the objective sees the WHOLE batch per
    call — required for batch-level kernels like the fused Pallas sector
    chain. Returns LBFGSResult with leading batch axes."""
    B, n = X0.shape
    m = history
    dtype = X0.dtype

    f0, g0 = fun_and_grad(X0)

    state = {
        "x": X0, "f": f0, "g": g0,
        "S": jnp.zeros((B, m, n), dtype), "Y": jnp.zeros((B, m, n), dtype),
        "rho": jnp.zeros((B, m), dtype),
        "head": jnp.zeros(B, jnp.int32), "count": jnp.zeros(B, jnp.int32),
        "it": jnp.zeros(B, jnp.int32), "evals": jnp.ones(B, jnp.int32),
        "fails": jnp.zeros(B, jnp.int32),
        "done": jnp.zeros(B, jnp.bool_),
        "converged": jnp.zeros(B, jnp.bool_),
    }

    def cond(s):
        return jnp.any((~s["done"]) & (s["it"] < max_iter))

    def body(s):
        live = (~s["done"]) & (s["it"] < max_iter)
        p = -_two_loop_batch(s["g"], s["S"], s["Y"], s["rho"], s["head"],
                             s["count"], m)
        descent = _bdot(p, s["g"]) < 0
        p = jnp.where(descent[:, None], p, -s["g"])

        gnorm0 = jnp.max(jnp.abs(s["g"]), axis=-1)
        a0 = jnp.where(s["count"] > 0,
                       jnp.ones(B, dtype),
                       jnp.minimum(1.0, 1.0 / jnp.maximum(gnorm0, 1e-12))
                       ).astype(dtype)

        alpha, f_w, g_w, k, ok, ba, bf, bg = _wolfe_search_batch(
            fun_and_grad, s["x"], s["f"], s["g"], p, max_ls, a0=a0,
            active0=live)

        improved = bf < s["f"]
        accept = live & (ok | improved)
        a_use = jnp.where(ok, alpha, ba)
        f_new = jnp.where(ok, f_w, bf)
        g_new = jnp.where(ok[:, None], g_w, bg)
        x_new = s["x"] + a_use[:, None] * p

        sk = x_new - s["x"]
        yk = g_new - s["g"]
        sy = _bdot(sk, yk)
        good_pair = live & ok & (sy > 1e-12 * jnp.linalg.norm(sk, axis=-1)
                                 * jnp.linalg.norm(yk, axis=-1))

        head = s["head"]
        slot = (jax.lax.broadcasted_iota(jnp.int32, (B, m), 1)
                == head[:, None]) & good_pair[:, None]
        S = jnp.where(slot[..., None], sk[:, None, :], s["S"])
        Y = jnp.where(slot[..., None], yk[:, None, :], s["Y"])
        rho = jnp.where(slot, (1.0 / jnp.where(sy != 0, sy, 1.0))[:, None],
                        s["rho"])
        head = jnp.where(good_pair, (head + 1) % m, head)
        count = jnp.where(good_pair, jnp.minimum(s["count"] + 1, m),
                          s["count"])
        count = jnp.where(live & ~ok, 0, count)

        fails = jnp.where(accept, 0,
                          jnp.where(live, s["fails"] + 1, s["fails"]))

        g_eff = jnp.where(accept[:, None], g_new, s["g"])
        gnorm = jnp.max(jnp.abs(g_eff), axis=-1)
        converged = live & (gnorm < tol)
        stalled = live & (fails >= max_fails)

        return {
            "x": jnp.where(accept[:, None], x_new, s["x"]),
            "f": jnp.where(accept, f_new, s["f"]),
            "g": g_eff,
            "S": S, "Y": Y, "rho": rho, "head": head, "count": count,
            "it": jnp.where(live, s["it"] + 1, s["it"]),
            "evals": jnp.where(live, s["evals"] + k, s["evals"]),
            "fails": fails,
            "done": s["done"] | converged | stalled,
            "converged": s["converged"] | converged,
        }

    s = jax.lax.while_loop(cond, body, state)
    return LBFGSResult(x=s["x"], f=s["f"],
                       grad_norm=jnp.max(jnp.abs(s["g"]), axis=-1),
                       iterations=s["it"], converged=s["converged"],
                       n_evals=s["evals"])
