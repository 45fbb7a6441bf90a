"""Flagship T=2.0 convergence probe (VERDICT r2 item 1).

Runs the full flagship optimization (sector engine, GROUP M=10, gamma=1e-6,
T=2.0, dt=0.01 — reference README.md:30-45 config) in f64 on CPU through
both optimizer paths and reports convergence quality + wall-clock:

  1. L-BFGS (bound-penalized, IPOPT limited-memory analogue)
  2. exact-Hessian primal-dual interior point at optTol=1e-8
     (main/OptimizeRamp.cpp:100-126 analogue)

Usage: JAX_PLATFORMS=cpu python tools/probe_flagship_converge.py [n_seeds]
"""

import os
import sys
import time

import numpy as np
import jax

# the f64 convergence reference runs on the CPU backend
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from optimalcontrolmps import control, engine, sector, seeds
from optimalcontrolmps.optimize import (minimize_interior_point,
                                        minimize_lbfgs)
from optimalcontrolmps.optimize.penalty import bound_penalty

T, dt, M, L, d, npart, gamma = 2.0, 0.01, 10, 5, 4, 5, 1e-6
N = int(round(T / dt)) + 1

st = sector.make_sector_stepper(L, d, npart, 1.0, dt, dtype=jnp.complex128)
psi_i = sector.sector_ground_state(L, d, npart, 1.0, 2.5, dtype=np.complex128)
psi_f = sector.sector_ground_state(L, d, npart, 1.0, 50.0,
                                   dtype=np.complex128)
rng = np.random.default_rng(123456789)
u0 = seeds.linsigmoid_seed(2.5, 50.0, N, rng=rng)
basis = control.chopped_sine_basis(u0, dt, T, M, dtype=np.float64)


def fg(c):
    u = basis.convert_control(c)
    g_u, (_, _, _, ov) = sector.gradient_lowmem(st, psi_i, psi_f, u, gamma)
    fid = (ov * ov.conj()).real
    J = 0.5 * (1.0 - fid) + engine.regularization(u, gamma, st.dt)
    return J, basis.convert_gradient(g_u)


def fg_pen(c):
    J, g = fg(c)
    J2, gp = jax.value_and_grad(
        lambda cc: bound_penalty(basis.convert_control(cc)))(c)
    return J + J2, g + gp


def Jpen(c):
    u = basis.convert_control(c)
    return (sector.cost(st, psi_i, psi_f, u, gamma) + bound_penalty(u))


fg_exact = jax.value_and_grad(Jpen)


def fgh(c):
    u = basis.convert_control(c)
    g_u, aux = sector.gradient(st, psi_i, psi_f, u, gamma)
    ov = aux[3]
    fid = (ov * ov.conj()).real
    J = 0.5 * (1.0 - fid) + engine.regularization(u, gamma, st.dt)
    H = basis.convert_hessian(sector.hessian(st, psi_i, psi_f, u, gamma,
                                             aux=aux))
    return J, basis.convert_gradient(g_u), H


cheap = lambda c: sector.cost(st, psi_i, psi_f, basis.convert_control(c),
                              gamma)

n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 8
rng2 = np.random.default_rng(7)
cs = np.zeros((n_seeds, M))
cs[1:] = rng2.normal(0.0, 0.5, (n_seeds - 1, M))

# --- path 1: multistart L-BFGS (exact autodiff gradient) -----------------
solve = jax.jit(jax.vmap(lambda c: minimize_lbfgs(fg_exact, c, max_iter=500,
                                                  tol=1e-8)))
t0 = time.time()
res = solve(jnp.asarray(cs))
fs = np.asarray(res.f)
compile_and_run = time.time() - t0
t0 = time.time()
res = solve(jnp.asarray(cs) + 1e-12)
fs = np.asarray(res.f)
steady = time.time() - t0
k = int(np.argmin(fs))
print(f"[lbfgs x{n_seeds}] best f = {fs[k]:.6e}  "
      f"gnorm = {float(np.asarray(res.grad_norm)[k]):.3e}  "
      f"iters = {np.asarray(res.iterations)[k]}  "
      f"converged = {bool(np.asarray(res.converged)[k])}  "
      f"evals = {np.asarray(res.n_evals)[k]}")
print(f"  all f: {np.sort(fs)}")
print(f"  wall first = {compile_and_run:.1f}s, steady = {steady:.1f}s "
      f"({n_seeds / steady:.3f} solves/s)")

# --- path 2: Newton polish with the exact Hessian at optTol=1e-8 --------
from optimalcontrolmps.optimize import minimize_newton

best_c = jnp.asarray(np.asarray(res.x)[k])


def fgh_exact(c):
    # exact autodiff gradient (adjoint formula has an O(dt^2) bias that
    # floors gnorm ~1e-6) + analytic row-propagation Hessian
    J, g = jax.value_and_grad(cheap)(c)
    H = basis.convert_hessian(sector.hessian(st, psi_i, psi_f,
                                             basis.convert_control(c), gamma))
    return J, g, H


newton = jax.jit(lambda c: minimize_newton(fgh_exact, c, tol=1e-8,
                                           max_iter=30, fun=cheap))
t0 = time.time()
nres = newton(best_c)
print(f"[newton polish] f = {float(nres.f):.9e}  gnorm = "
      f"{float(nres.grad_norm):.3e}  iters = {int(nres.iterations)}  "
      f"converged = {bool(nres.converged)}  wall = {time.time()-t0:.1f}s")

# --- path 3: exact-Hessian interior point at optTol=1e-8 ----------------
# (exact gradient + analytic Hessian, like the driver's exactGradient mode)
def fgh_ip(c):
    J, g = jax.value_and_grad(cheap)(c)
    H = basis.convert_hessian(sector.hessian(st, psi_i, psi_f,
                                             basis.convert_control(c), gamma))
    return J, g, H


ip = jax.jit(lambda c, mu0: minimize_interior_point(
    fgh_ip, c, B=basis.jacobian(), u0=basis.u0, tol=1e-8, max_iter=200,
    fun=cheap, mu0=mu0), static_argnums=1)
t0 = time.time()
ipres = ip(jnp.zeros(M), 0.1)
print(f"[ip from 0]    f = {float(ipres.f):.6e}  kkt = "
      f"{float(ipres.kkt_error):.3e}  iters = {int(ipres.iterations)}  "
      f"converged = {bool(ipres.converged)}  wall = {time.time()-t0:.1f}s")
t0 = time.time()
ipres2 = ip(best_c, 1e-6)
print(f"[ip mu0=1e-6]  f = {float(ipres2.f):.6e}  kkt = "
      f"{float(ipres2.kkt_error):.3e}  iters = {int(ipres2.iterations)}  "
      f"converged = {bool(ipres2.converged)}  wall = {time.time()-t0:.1f}s")

# final infidelity at the best point found
cands = [(float(nres.f), nres.x), (float(ipres2.f), ipres2.x),
         (float(fs[k]), best_c)]
cands.sort(key=lambda t: t[0])
c_star = cands[0][1]
u_star = basis.convert_control(c_star)
fid = float(np.asarray(sector.fidelities(st, psi_i, psi_f, u_star))[-1])
umin = float(np.min(np.asarray(u_star)))
umax = float(np.max(np.asarray(u_star)))
print(f"[final] infidelity 1-F(T) = {1.0 - fid:.6e}  (J* = {cands[0][0]:.9e}"
      f", u range [{umin:.2f}, {umax:.2f}] vs bounds [2, 100])")
