"""Multistart SOLVE throughput on the default backend (the BASELINE metric).

One solve = a full flagship L-BFGS optimization (T=2.0, GROUP M=10,
sector engine, exact autodiff gradient, bound-penalized — the production
multistart unit). Times a vmapped batch of B solves end-to-end and prints
solves/s plus per-batch iteration stats; this is the workload bench.py's
headline metric wraps.

Usage: python tools/probe_solve_speed.py [B] [max_iter] [tol]
Env: OCMPS_CPU=1 to force the CPU backend (f64).
"""

import os
import sys
import time

import numpy as np
import jax

if os.environ.get("OCMPS_CPU"):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from optimalcontrolmps.profiling import enable_compile_cache

enable_compile_cache()

from optimalcontrolmps import control, sector, seeds
from optimalcontrolmps.optimize import minimize_lbfgs
from optimalcontrolmps.optimize.penalty import bound_penalty

B = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
max_iter = int(sys.argv[2]) if len(sys.argv) > 2 else 150
tol = float(sys.argv[3]) if len(sys.argv) > 3 else 1e-5

T, dt, M, L, d, npart, gamma = 2.0, 0.01, 10, 5, 4, 5, 1e-6
N = int(round(T / dt)) + 1
f64 = bool(os.environ.get("OCMPS_CPU"))
cdtype = jnp.complex128 if f64 else jnp.complex64
rdtype = np.float64 if f64 else np.float32

st = sector.make_sector_stepper(L, d, npart, 1.0, dt, dtype=cdtype)
psi_i = sector.sector_ground_state(L, d, npart, 1.0, 2.5,
                                   dtype=np.dtype(cdtype))
psi_f = sector.sector_ground_state(L, d, npart, 1.0, 50.0,
                                   dtype=np.dtype(cdtype))
rng = np.random.default_rng(123456789)
u0 = seeds.linsigmoid_seed(2.5, 50.0, N, rng=rng)
basis = control.chopped_sine_basis(u0, dt, T, M, dtype=rdtype)


def Jpen(c):
    u = basis.convert_control(c)
    return sector.cost(st, psi_i, psi_f, u, gamma) + bound_penalty(u)


fg = jax.value_and_grad(Jpen)
solve = jax.jit(jax.vmap(lambda c: minimize_lbfgs(fg, c, max_iter=max_iter,
                                                  tol=tol)))

rng2 = np.random.default_rng(7)
cs = np.zeros((B, M), dtype=rdtype)
cs[1:] = rng2.normal(0.0, 0.5, (B - 1, M)).astype(rdtype)

t0 = time.time()
res = solve(jnp.asarray(cs))
fs = np.asarray(res.f)  # download = sync
t_first = time.time() - t0

t0 = time.time()
res = solve(jnp.asarray(cs + rdtype(1e-6)))
fs = np.asarray(res.f)
t_steady = time.time() - t0

its = np.asarray(res.iterations)
k = int(np.argmin(fs))
print(f"backend={jax.devices()[0].platform} B={B} dtype={np.dtype(cdtype)}")
print(f"first(batch incl compile) = {t_first:.1f}s   "
      f"steady = {t_steady:.2f}s  ->  {B / t_steady:.1f} solves/s")
print(f"best f = {fs[k]:.6e}  median f = {np.median(fs):.6e}  "
      f"worst f = {np.max(fs):.6e}")
print(f"iters: min/med/max = {its.min()}/{int(np.median(its))}/{its.max()}"
      f"  converged: {int(np.asarray(res.converged).sum())}/{B}")
print(f"gnorm best = {float(np.asarray(res.grad_norm)[k]):.3e}")
