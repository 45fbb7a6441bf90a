"""Primal-dual interior-point solver for the control NLP.

Rebuild of the reference's IPOPT pathway (include/BH_nlp.hpp,
src/BH_nlp.cpp, main/OptimizeRamp.cpp:100-126): minimize J(x) subject to

    box bounds      x in [x_lb, x_ub]^M          (BH_nlp.cpp:47-52, +-20)
    path constraint u(x) = u0 + B x in [g_lb, g_ub]^N  (BH_nlp.cpp:54-60,
                    Umin=2, Umax=100; B = control Jacobian, constant —
                    the reference sets jac_d_constant=yes,
                    main/OptimizeRamp.cpp:107)

Like IPOPT this is *primal-dual*: bound multipliers (z, w) are independent
variables, so dual feasibility is not limited by the mu/s cancellation that
kills pure primal barrier methods at active bounds. Newton steps solve the
reduced KKT system

    [H + Z_lo/S_lo + Z_hi/S_hi + B^T (W_lo/T_lo + W_hi/T_hi) B] dx = rhs

with the engine's exact Hessian H (Levenberg-regularized to PD), a
fraction-to-boundary rule on primal slacks and duals, Armijo backtracking on
the barrier merit, and a monotone Fiacco-McCormick mu schedule with
superlinear decrease (IPOPT's "monotone" mode; the reference selects
"adaptive", which only changes the schedule, not the fixed points).

Two drivers over the SAME iteration math (shared `_IPCore` closures):

* `minimize_interior_point` — one `lax.while_loop` of dense (M x M)
  solves: jit-compiles whole, and `vmap` runs thousands of multistart
  NLPs in lockstep — the replacement for one IPOPT process per ramp.
* `minimize_interior_point_host` — a host Python loop for problems whose
  f/g/H evaluation is itself a host-driven composite (the streaming
  exact Hessian at reference scale takes minutes-to-hours per call and
  cannot live inside a traced while_loop); the line search early-exits
  on the first Armijo success instead of running all 20 masked trials
  (each trial is a full rollout at that scale).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["IPResult", "minimize_interior_point",
           "minimize_interior_point_host", "cold_duals"]


def cold_duals(x0, mu0=0.1, x_lb=-20.0, x_ub=20.0, B=None, u0=None,
               g_lb=2.0, g_ub=100.0):
    """The solver's cold-start multipliers (z, w) = mu/s for x0, as a
    (z_lo, z_hi, w_lo, w_hi) tuple suitable for `duals0=`. Lets chunked
    outer loops jit ONE solver signature (always passing a dual tuple)
    instead of recompiling when the warm-start kicks in after chunk 1."""
    x0 = jnp.asarray(x0)
    margin = 1e-2 * (x_ub - x_lb)
    x = jnp.clip(x0, x_lb + margin, x_ub - margin)
    if B is None:
        u = jnp.full((1,), 0.5 * (g_lb + g_ub), x0.dtype)
    else:
        u = jnp.asarray(u0, x0.dtype) + jnp.asarray(B, x0.dtype) @ x
    return (mu0 / (x - x_lb), mu0 / (x_ub - x),
            mu0 / (u - g_lb), mu0 / (g_ub - u))


class IPResult(NamedTuple):
    x: jnp.ndarray
    f: jnp.ndarray
    kkt_error: jnp.ndarray
    iterations: jnp.ndarray
    converged: jnp.ndarray
    mu: jnp.ndarray = jnp.nan   # final barrier parameter (warm restarts)
    # final bound/path multipliers — pass back via duals0= so a chunked
    # or checkpoint-resumed solve keeps the full primal-dual state
    # (re-initializing them to mu/s every chunk discards centering
    # progress and inflates iteration counts)
    z_lo: jnp.ndarray = jnp.nan
    z_hi: jnp.ndarray = jnp.nan
    w_lo: jnp.ndarray = jnp.nan
    w_hi: jnp.ndarray = jnp.nan


class _IPCore:
    """The iteration math shared by both drivers: slacks/KKT residuals,
    the prep half (barrier update, reduced-KKT solve, trust region,
    step-size rules, merit data) and the apply half (step + kappa-sigma
    safeguard + radius policy). All methods are pure jax functions of
    their inputs — jit-traceable inline (while_loop driver) or wrapped
    in jax.jit individually (host driver)."""

    def __init__(self, fun, n, dtype, B, u0, have_path, npath,
                 x_lb, x_ub, g_lb, g_ub, mu0, tol, frac_to_boundary,
                 kappa_mu, theta_mu, mu_strategy, trust_min, trust_max):
        self.fun = fun
        self.n, self.dtype = n, dtype
        self.B, self.u0 = B, u0
        self.have_path, self.npath = have_path, npath
        self.x_lb, self.x_ub = x_lb, x_ub
        self.g_lb, self.g_ub = g_lb, g_ub
        self.mu0, self.tol = mu0, tol
        self.ftb = frac_to_boundary
        self.kappa_mu, self.theta_mu = kappa_mu, theta_mu
        self.mu_strategy = mu_strategy
        self.trust_min, self.trust_max = trust_min, trust_max
        self.eye = jnp.eye(n, dtype=dtype)

    def slacks(self, x):
        # floor at the dtype's rounding scale: in f32 a fraction-to-
        # boundary step can land within rounding of a bound, making the
        # slack EXACTLY zero — mu/s and w/s then go inf, a_p collapses
        # to 0 and the dual update poisons itself with inf*0 NaNs
        # (observed on the chi=128 scaled solve, iteration 5). The floor
        # is far below optTol-relevant scales and inactive in f64.
        eps = 1e-7 if self.dtype == jnp.float32 else 1e-14
        u = self.u0 + self.B @ x
        return (jnp.maximum(x - self.x_lb, eps),
                jnp.maximum(self.x_ub - x, eps),
                jnp.maximum(u - self.g_lb, eps),
                jnp.maximum(self.g_ub - u, eps))

    def kkt_error(self, x, z_lo, z_hi, w_lo, w_hi, g, mu):
        B = self.B
        s_lo, s_hi, t_lo, t_hi = self.slacks(x)
        r_d = g - z_lo + z_hi - B.T @ w_lo + B.T @ w_hi
        # IPOPT-style scaling keeps the test meaningful when duals are
        # large
        zsum = (jnp.sum(jnp.abs(z_lo)) + jnp.sum(jnp.abs(z_hi))
                + jnp.sum(jnp.abs(w_lo)) + jnp.sum(jnp.abs(w_hi)))
        nd = 2 * self.n + 2 * self.npath
        sd = jnp.maximum(100.0, zsum / nd) / 100.0
        e_d = jnp.max(jnp.abs(r_d)) / sd
        e_c = jnp.maximum(jnp.max(jnp.abs(s_lo * z_lo - mu)),
                          jnp.max(jnp.abs(s_hi * z_hi - mu)))
        e_c = jnp.maximum(e_c, jnp.max(jnp.abs(t_lo * w_lo - mu)))
        e_c = jnp.maximum(e_c, jnp.max(jnp.abs(t_hi * w_hi - mu)))
        return jnp.maximum(e_d, e_c / sd)

    def init_state(self, x0, duals0, trust_radius):
        dtype = self.dtype
        margin = 1e-2 * (self.x_ub - self.x_lb)
        x_init = jnp.clip(x0, self.x_lb + margin, self.x_ub - margin)
        s0 = self.slacks(x_init)
        mu_init = jnp.asarray(self.mu0, dtype)
        if duals0 is not None:
            # warm restart: resume the full primal-dual state (chunked
            # outer loops / checkpoint resume); clip strictly positive
            z_lo0, z_hi0, w_lo0, w_hi0 = (
                jnp.maximum(jnp.asarray(v, dtype), 1e-12) for v in duals0)
        else:
            z_lo0, z_hi0 = mu_init / s0[0], mu_init / s0[1]
            w_lo0, w_hi0 = mu_init / s0[2], mu_init / s0[3]
        return {
            "x": x_init,
            "z_lo": z_lo0, "z_hi": z_hi0,
            "w_lo": w_lo0, "w_hi": w_hi0,
            "mu": mu_init,
            "f": jnp.zeros((), dtype),
            "it": jnp.zeros((), jnp.int32),
            "err0": jnp.asarray(jnp.inf, dtype),
            "done": jnp.zeros((), jnp.bool_),
            "tr": jnp.asarray(trust_radius, dtype),
        }

    def iter_prep(self, s, f, g, H):
        """Everything up to (but excluding) the line search: barrier
        update, reduced KKT solve with Levenberg trust region, dual
        steps, fraction-to-boundary step limits, merit line data."""
        B = self.B
        x, mu = s["x"], s["mu"]
        z_lo, z_hi, w_lo, w_hi = s["z_lo"], s["z_hi"], s["w_lo"], s["w_hi"]
        s_lo, s_hi, t_lo, t_hi = self.slacks(x)

        # global convergence test at mu = 0 (IPOPT E_0 <= tol)
        err0 = self.kkt_error(x, z_lo, z_hi, w_lo, w_hi, g, 0.0)
        converged = err0 <= self.tol

        # barrier update
        if self.mu_strategy == "adaptive":
            # centering from the current complementarity distribution;
            # when B is None (GRAPE box-only) the dummy path row would
            # bias c_avg/c_min — exclude it
            parts = [s_lo * z_lo, s_hi * z_hi]
            if self.have_path:
                parts += [t_lo * w_lo, t_hi * w_hi]
            compl = jnp.concatenate(parts)
            c_avg = jnp.mean(compl)
            c_min = jnp.min(compl)
            sigma = jnp.clip((c_min / jnp.maximum(c_avg, 1e-30)) ** 3,
                             1e-3, 0.8)
            mu_next = jnp.clip(sigma * c_avg, self.tol / 11.0, self.mu0)
        else:
            # monotone Fiacco-McCormick: tighten mu once the barrier
            # subproblem is solved to ~10*mu
            err_mu = self.kkt_error(x, z_lo, z_hi, w_lo, w_hi, g, mu)
            mu_next = jnp.where(
                err_mu <= 10.0 * mu,
                jnp.maximum(self.tol / 11.0,
                            jnp.minimum(self.kappa_mu * mu,
                                        mu ** self.theta_mu)),
                mu)

        # reduced KKT system
        r_d = g - z_lo + z_hi - B.T @ w_lo + B.T @ w_hi
        Sigma_x = z_lo / s_lo + z_hi / s_hi
        Sigma_u = w_lo / t_lo + w_hi / t_hi
        M = H + jnp.diag(Sigma_x) + (B.T * Sigma_u[None, :]) @ B
        # Levenberg regularization to PD (inertia correction); min_eig
        # and solve_spd route through LAPACK/cuSOLVER, or the matmul-only
        # kernels under OCMPS_LINALG=matfree (ops/matfree.py)
        from ..ops.matfree import min_eig, solve_spd
        wmin = min_eig(M)
        lam = jnp.maximum(0.0, 1e-10 - wmin) + 1e-12
        rhs = (-r_d + (mu_next / s_lo - z_lo) - (mu_next / s_hi - z_hi)
               + B.T @ (mu_next / t_lo - w_lo)
               - B.T @ (mu_next / t_hi - w_hi))
        dx = solve_spd(M + lam * self.eye, rhs)

        # Levenberg TRUST REGION: nearly singular Hessians (the 201-dim
        # GRAPE NLP: H has a large near-null space) otherwise produce
        # ~1e4-long Newton steps whose merit search collapses to
        # 1e-3 * a_p — stiff-direction progress then crawls with the
        # flat directions (measured: GRAPE T=0.5 stalls at kkt 1e-3
        # without this, converges to 1e-8 in ~200 its with it). Three
        # damping levels: the (inertia-corrected) Newton step; the
        # guaranteed-in-radius lam3 = ||rhs||/tr (since ||dx(lam)|| <=
        # ||rhs||/lam); and their geometric mean. Pick the least-damped
        # step inside the radius — at most 2 extra SPD solves.
        tr = s["tr"]
        ndx1 = jnp.linalg.norm(dx)
        lam3 = jnp.maximum(lam, jnp.linalg.norm(rhs) / tr)
        lam2 = jnp.sqrt(jnp.maximum(lam, 1e-12) * lam3)
        dx2 = solve_spd(M + lam2 * self.eye, rhs)
        dx3 = solve_spd(M + lam3 * self.eye, rhs)
        use2 = jnp.linalg.norm(dx2) <= tr
        dx = jnp.where(ndx1 <= tr, dx,
                       jnp.where(use2, dx2, dx3))
        ndx = jnp.linalg.norm(dx)

        dz_lo = mu_next / s_lo - z_lo - (z_lo / s_lo) * dx
        dz_hi = mu_next / s_hi - z_hi + (z_hi / s_hi) * dx
        Bdx = B @ dx
        dw_lo = mu_next / t_lo - w_lo - (w_lo / t_lo) * Bdx
        dw_hi = mu_next / t_hi - w_hi + (w_hi / t_hi) * Bdx

        # fraction-to-boundary: primal on slacks, dual on multipliers
        tau = jnp.maximum(self.ftb, 1.0 - mu_next)

        def max_step(v, dv):
            r = jnp.where(dv < 0, -tau * v / dv, jnp.inf)
            return jnp.minimum(1.0, jnp.min(r))

        a_p = jnp.minimum(jnp.minimum(max_step(s_lo, dx),
                                      max_step(s_hi, -dx)),
                          jnp.minimum(max_step(t_lo, Bdx),
                                      max_step(t_hi, -Bdx)))
        a_d = jnp.minimum(jnp.minimum(max_step(z_lo, dz_lo),
                                      max_step(z_hi, dz_hi)),
                          jnp.minimum(max_step(w_lo, dw_lo),
                                      max_step(w_hi, dw_hi)))

        dphi = (g - mu_next / s_lo + mu_next / s_hi
                - B.T @ (mu_next / t_lo)
                + B.T @ (mu_next / t_hi)) @ dx

        return {"f": f, "err0": err0, "converged": converged,
                "mu_next": mu_next, "dx": dx, "ndx": ndx,
                "dz_lo": dz_lo, "dz_hi": dz_hi,
                "dw_lo": dw_lo, "dw_hi": dw_hi,
                "a_p": a_p, "a_d": a_d, "dphi": dphi}

    def phi_at(self, x, dx, a, mu_next):
        """Barrier merit along the step: phi(x + a*dx)."""
        xx = x + a * dx
        ff = self.fun(xx)
        sl, sh, tl, th = self.slacks(xx)
        bar = (jnp.sum(jnp.log(sl)) + jnp.sum(jnp.log(sh))
               + jnp.sum(jnp.log(tl)) + jnp.sum(jnp.log(th)))
        return ff - mu_next * bar

    def iter_apply(self, s, P, a_use, trials_unused=None):
        """Apply the accepted primal/dual step + kappa-sigma safeguard +
        the boundary-aware trust-radius policy; freeze on convergence."""
        x, tr = s["x"], s["tr"]
        converged = P["converged"]
        mu_next, a_d = P["mu_next"], P["a_d"]
        x_n = x + a_use * P["dx"]
        z_lo_n = s["z_lo"] + a_d * P["dz_lo"]
        z_hi_n = s["z_hi"] + a_d * P["dz_hi"]
        w_lo_n = s["w_lo"] + a_d * P["dw_lo"]
        w_hi_n = s["w_hi"] + a_d * P["dw_hi"]

        # IPOPT's kappa-sigma safeguard: keep duals within a factor of
        # mu/s
        sl, sh, tl, th = self.slacks(x_n)
        ks = 1e10
        z_lo_n = jnp.clip(z_lo_n, mu_next / (ks * sl),
                          ks * mu_next / sl)
        z_hi_n = jnp.clip(z_hi_n, mu_next / (ks * sh),
                          ks * mu_next / sh)
        w_lo_n = jnp.clip(w_lo_n, mu_next / (ks * tl),
                          ks * mu_next / tl)
        w_hi_n = jnp.clip(w_hi_n, mu_next / (ks * th),
                          ks * mu_next / th)

        # boundary-aware radius policy: grow only when a (near-)full
        # step ran against the radius; shrink toward what the line
        # search actually accepted; collapse hard on failure
        found, ndx = P["found"], P["ndx"]
        tr_next = jnp.where(
            ~found, jnp.maximum(0.25 * tr, self.trust_min),
            jnp.where((a_use >= 0.5) & (ndx >= 0.9 * tr),
                      jnp.minimum(2.0 * tr, self.trust_max),
                      jnp.where(a_use < 0.5,
                                jnp.clip(jnp.maximum(2.0 * a_use * ndx,
                                                     0.25 * tr),
                                         self.trust_min, self.trust_max),
                                tr)))

        return {
            "x": jnp.where(converged, x, x_n),
            "z_lo": jnp.where(converged, s["z_lo"], z_lo_n),
            "z_hi": jnp.where(converged, s["z_hi"], z_hi_n),
            "w_lo": jnp.where(converged, s["w_lo"], w_lo_n),
            "w_hi": jnp.where(converged, s["w_hi"], w_hi_n),
            "mu": mu_next,
            "f": P["f"],
            "it": s["it"] + 1,
            "err0": P["err0"],
            "done": converged,
            "tr": jnp.where(converged, tr, tr_next),
        }


def _make_core(fun_grad_hess, x0, x_lb, x_ub, B, u0, g_lb, g_ub, mu0,
               tol, frac_to_boundary, kappa_mu, theta_mu, fun,
               trust_min, trust_max, mu_strategy):
    if fun is None:
        fun = lambda xx: fun_grad_hess(xx)[0]
    n = x0.shape[0]
    dtype = x0.dtype
    have_path = B is not None
    if have_path:
        B = jnp.asarray(B, dtype)
        u0 = jnp.asarray(u0, dtype)
        npath = B.shape[0]
    else:
        B = jnp.zeros((1, n), dtype)
        u0 = jnp.full((1,), 0.5 * (g_lb + g_ub), dtype)
        npath = 1
    return _IPCore(fun, n, dtype, B, u0, have_path, npath, x_lb, x_ub,
                   g_lb, g_ub, mu0, tol, frac_to_boundary, kappa_mu,
                   theta_mu, mu_strategy, trust_min, trust_max)


def minimize_interior_point(
        fun_grad_hess: Callable, x0,
        x_lb: float = -20.0, x_ub: float = 20.0,
        B=None, u0=None, g_lb: float = 2.0, g_ub: float = 100.0,
        mu0: float = 0.1, tol: float = 1e-8,
        max_iter: int = 300, frac_to_boundary: float = 0.995,
        kappa_mu: float = 0.2, theta_mu: float = 1.5, fun: Callable = None,
        callback: Callable = None, trust_radius: float = 5.0,
        trust_min: float = 1e-3, trust_max: float = 100.0,
        mu_strategy: str = "monotone", duals0=None):
    """Minimize f(x) with box + linear path constraints.

    fun_grad_hess(x) -> (f, g, H). B (N, M), u0 (N,): path u = u0 + B x
    (None disables). `fun(x) -> f` is an optional cheap objective used only
    by the merit line search (pass it when the Hessian is expensive — for
    the control problem one Hessian is O(N_t^2) propagations while the cost
    is two rollouts). Jittable; vmap over x0 for batched multistart.

    `callback(it, f, kkt_err0, ls_trials)`: optional per-iteration host
    callback (ordered io_callback), the analogue of IPOPT's
    intermediate_callback that the reference uses to append ProgressCache
    lines every iteration (src/BH_nlp.cpp:291-326). Not supported under
    vmap; leave None for multistart batches.

    mu_strategy: "monotone" (Fiacco-McCormick schedule, the default) or
    "adaptive" — the reference selects IPOPT's `mu_strategy adaptive`
    (main/OptimizeRamp.cpp:106). The adaptive mode sets the barrier from
    the CURRENT average complementarity with a Mehrotra-style centering
    exponent, mu = sigma * compl_avg with sigma = (compl_min /
    compl_avg)^3 clipped to [1e-3, 0.8] — far-from-centered iterates keep
    a large barrier, well-centered ones drop it aggressively —
    safeguarded below by the monotone schedule's floor (tol/11). Both
    modes share the same KKT fixed points; only the path differs.

    duals0: optional (z_lo, z_hi, w_lo, w_hi) warm-start multipliers
    (see IPResult / cold_duals) for chunked or resumed solves.
    """
    core = _make_core(fun_grad_hess, x0, x_lb, x_ub, B, u0, g_lb, g_ub,
                      mu0, tol, frac_to_boundary, kappa_mu, theta_mu,
                      fun, trust_min, trust_max, mu_strategy)
    dtype = core.dtype
    state = core.init_state(x0, duals0, trust_radius)
    f0, g0, _ = fun_grad_hess(state["x"])
    state["f"] = f0

    def cond(s):
        return (~s["done"]) & (s["it"] < max_iter)

    def body(s):
        f, g, H = fun_grad_hess(s["x"])
        P = core.iter_prep(s, f, g, H)
        x, dx = s["x"], P["dx"]
        dphi, mu_next = P["dphi"], P["mu_next"]
        phi0 = core.phi_at(x, dx, jnp.zeros((), dtype), mu_next)

        # Armijo backtracking on the barrier merit along dx
        def ls_body(j, carry):
            a, best, found, trials = carry
            ok = core.phi_at(x, dx, a, mu_next) <= phi0 + 1e-4 * a * dphi
            best = jnp.where(ok & (~found), a, best)
            trials = trials + jnp.where(found, 0, 1)
            return a * 0.5, best, found | ok, trials

        # 20 halvings reach a ~ 1e-6 * a_p: long damped directions far
        # from the quadratic region still find an acceptable step
        _, a_good, found, ls_trials = jax.lax.fori_loop(
            0, 20, ls_body,
            (P["a_p"], jnp.zeros((), dtype), jnp.zeros((), jnp.bool_),
             jnp.zeros((), jnp.int32)))
        # if the line search fails (merit non-descent due to dual-driven
        # rhs), fall back to a small safeguarded step
        a_use = jnp.where(found, a_good, 1e-3 * P["a_p"])

        if callback is not None:
            from jax.experimental import io_callback
            io_callback(callback, None, s["it"] + 1, f, P["err0"],
                        ls_trials, ordered=True)

        P = {**P, "found": found}
        return core.iter_apply(s, P, a_use)

    s = jax.lax.while_loop(cond, body, state)
    f_fin, g_fin, _ = fun_grad_hess(s["x"])
    err_fin = core.kkt_error(s["x"], s["z_lo"], s["z_hi"], s["w_lo"],
                             s["w_hi"], g_fin, 0.0)
    return IPResult(x=s["x"], f=f_fin, kkt_error=err_fin,
                    iterations=s["it"], converged=err_fin <= tol,
                    mu=s["mu"], z_lo=s["z_lo"], z_hi=s["z_hi"],
                    w_lo=s["w_lo"], w_hi=s["w_hi"])


def minimize_interior_point_host(
        fun_grad_hess: Callable, x0,
        x_lb: float = -20.0, x_ub: float = 20.0,
        B=None, u0=None, g_lb: float = 2.0, g_ub: float = 100.0,
        mu0: float = 0.1, tol: float = 1e-8,
        max_iter: int = 300, frac_to_boundary: float = 0.995,
        kappa_mu: float = 0.2, theta_mu: float = 1.5, fun: Callable = None,
        fun_grad: Callable = None,
        callback: Callable = None, checkpoint_cb: Callable = None,
        trust_radius: float = 5.0,
        trust_min: float = 1e-3, trust_max: float = 100.0,
        mu_strategy: str = "monotone", duals0=None, max_ls: int = 20,
        max_seconds: float = None):
    """Host-driven twin of minimize_interior_point (same _IPCore math).

    For reference-scale problems: `fun_grad_hess` may be an arbitrary
    host function (e.g. streaming exact Hessian — minutes per call), the
    line search EARLY-EXITS on the first Armijo success (each merit trial
    is a full rollout at scale; the traced fori always runs 20), and
    `checkpoint_cb(it, state_dict, f, kkt)` fires after every iteration
    for durable checkpoints (IPOPT max_cpu_time-grade recoverability at
    1-iteration granularity).

    fun_grad: optional cheap (f, g) handle used for the FINAL kkt check
    (avoids one full Hessian at the last iterate). callback matches the
    jit driver's (it, f, kkt_err0, ls_trials).
    """
    import time as _time

    import numpy as np

    t_start = _time.time()
    x0 = jnp.asarray(x0)
    core = _make_core(fun_grad_hess, x0, x_lb, x_ub, B, u0, g_lb, g_ub,
                      mu0, tol, frac_to_boundary, kappa_mu, theta_mu,
                      fun, trust_min, trust_max, mu_strategy)
    prep_j = jax.jit(core.iter_prep)
    apply_j = jax.jit(core.iter_apply)
    kkt_j = jax.jit(core.kkt_error)

    # the merit barrier runs in HOST numpy (x is a small (M,) vector):
    # the user `fun` may be a jitted device program whose state operands
    # are jit ARGUMENTS — tracing it again inside a phi jit would embed
    # device arrays as lowering constants
    B_h = np.asarray(core.B, np.float64)
    u0_h = np.asarray(core.u0, np.float64)

    eps_sl = 1e-7 if core.dtype == jnp.float32 else 1e-14

    def barrier_h(x_np):
        u = u0_h + B_h @ x_np
        sl = np.concatenate([x_np - x_lb, x_ub - x_np,
                             u - g_lb, g_ub - u])
        if np.any(sl <= -eps_sl):
            return -np.inf   # genuinely infeasible trial: phi = +inf
        # rounding-level bound contact is floored, matching core.slacks
        return float(np.sum(np.log(np.maximum(sl, eps_sl))))

    merit_fun = core.fun

    def phi_h(x_np, mu):
        bar = barrier_h(x_np)
        if bar == -np.inf:
            return np.inf
        return float(merit_fun(jnp.asarray(x_np, dtype))) - mu * bar

    s = core.init_state(x0, duals0, trust_radius)
    dtype = core.dtype
    it = 0
    converged = False
    f = g = None
    while it < max_iter:
        f, g, H = fun_grad_hess(np.asarray(s["x"]))
        f = jnp.asarray(f, dtype)
        g = jnp.asarray(g, dtype)
        H = jnp.asarray(H, dtype)
        P = prep_j(s, f, g, H)
        err0 = float(P["err0"])
        if err0 <= tol:
            converged = True
            s["err0"] = P["err0"]
            s["f"] = f
            break
        a_p = float(P["a_p"])
        mu_next = float(P["mu_next"])
        x_np = np.asarray(s["x"], np.float64)
        dx_np = np.asarray(P["dx"], np.float64)
        phi0 = float(f) - mu_next * barrier_h(x_np)
        dphi = float(P["dphi"])
        a = a_p
        found = False
        trials = 0
        for _ in range(max_ls):
            trials += 1
            if phi_h(x_np + a * dx_np, mu_next) <= phi0 + 1e-4 * a * dphi:
                found = True
                break
            a *= 0.5
        a_use = a if found else 1e-3 * a_p
        if callback is not None:
            callback(it + 1, float(f), err0, trials)
        P = {**P, "found": jnp.asarray(found)}
        s = apply_j(s, P, jnp.asarray(a_use, dtype))
        it += 1
        if checkpoint_cb is not None:
            checkpoint_cb(it, {k: np.asarray(v) for k, v in s.items()},
                          float(f), err0)
        if max_seconds is not None and _time.time() - t_start > max_seconds:
            print("minimize_interior_point_host: max_seconds reached; "
                  "stopping", flush=True)
            break

    if converged:
        f_fin, g_fin = f, g
    elif fun_grad is not None:
        f_fin, g_fin = fun_grad(np.asarray(s["x"]))
    else:
        f_fin, g_fin, _ = fun_grad_hess(np.asarray(s["x"]))
    err_fin = kkt_j(s["x"], s["z_lo"], s["z_hi"], s["w_lo"], s["w_hi"],
                    jnp.asarray(g_fin, dtype), 0.0)
    return IPResult(x=s["x"], f=jnp.asarray(f_fin, dtype),
                    kkt_error=err_fin,
                    iterations=jnp.asarray(it, jnp.int32),
                    converged=err_fin <= tol,
                    mu=s["mu"], z_lo=s["z_lo"], z_hi=s["z_hi"],
                    w_lo=s["w_lo"], w_hi=s["w_hi"])
