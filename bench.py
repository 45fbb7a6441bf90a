"""Benchmark: flagship multistart SOLVE throughput + converged quality.

One solve = a full flagship optimization (reference README config: N=5
sites, Npart=5, d=4, T=2.0, dt=0.01 -> 201 steps, GROUP M=10,
gamma=1e-6) by L-BFGS with the exact autodiff gradient and bound
penalty — the production multistart unit.

Two phases:
  1. device phase (complex64, f32 "highest" matmuls): B seeds solved in
     lockstep by the batch L-BFGS (optimize/lbfgs.minimize_lbfgs_batch)
     over the batched sector chain (ops/sector_chain.chain_final), in ONE
     jitted program; solves/s = B / steady wall.
  2. polish phase (CPU child process, complex128): the best-of-batch
     candidate is polished by f64 L-BFGS + exact-Hessian Newton to
     optTol=1e-8, reporting the converged objective and infidelity.

The device phase solves to tol=1e-5 (the single-precision gradient
noise floor; stall recovery in optimize/lbfgs.py terminates each seed
honestly). Convergence at the reference's optTol=1e-8 is the polish
phase's job and is what `converged` in the output refers to.

`chip_smoke.py` runs the same solve and polish (`run_solve`,
`run_polish`). Prints ONE JSON line. Env: BENCH_BATCH (default 4096),
BENCH_MODE=grad for the batched gradient-evals metric.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

T, DT, M, L, D, NPART, GAMMA = 2.0, 0.01, 10, 5, 4, 5, 1e-6
MAX_ITER, TOL = 150, 1e-5
OPT_TOL = 1e-8


def flagship_problem(f64=False):
    """(st, psi_i, psi_f, basis, rdtype) of the flagship config."""
    import jax.numpy as jnp
    from optimalcontrolmps import control, sector, seeds
    N = int(round(T / DT)) + 1
    cdtype = jnp.complex128 if f64 else jnp.complex64
    rdtype = np.float64 if f64 else np.float32
    st = sector.make_sector_stepper(L, D, NPART, 1.0, DT, dtype=cdtype)
    psi_i = sector.sector_ground_state(L, D, NPART, 1.0, 2.5,
                                       dtype=np.dtype(cdtype))
    psi_f = sector.sector_ground_state(L, D, NPART, 1.0, 50.0,
                                       dtype=np.dtype(cdtype))
    rng = np.random.default_rng(123456789)
    u0 = seeds.linsigmoid_seed(2.5, 50.0, N, rng=rng)
    basis = control.chopped_sine_basis(u0, DT, T, M, dtype=rdtype)
    return st, psi_i, psi_f, basis, rdtype


def _penalized(st, psi_i, psi_f, basis):
    from optimalcontrolmps import sector
    from optimalcontrolmps.optimize.penalty import bound_penalty

    def Jpen(c):
        u = basis.convert_control(c)
        return (sector.cost(st, psi_i, psi_f, u, GAMMA)
                + bound_penalty(u))

    return Jpen


def seed_batch(B):
    """(B, M) f32 starting GROUP coefficients: lane 0 is the reference's
    zero start, the rest are N(0, 0.5) draws from a fixed seed."""
    rng = np.random.default_rng(7)
    cs = np.zeros((B, M), dtype=np.float32)
    cs[1:] = rng.normal(0.0, 0.5, (B - 1, M)).astype(np.float32)
    return cs


def batch_objective(st, psi_i, psi_f, basis):
    """fg(C) -> (J (B,), G (B, M)) over the batched chain for a whole
    batch. Sharded inputs partition it by the batch axis."""
    import jax
    import jax.numpy as jnp
    from optimalcontrolmps.engine import regularization
    from optimalcontrolmps.ops.precision import enforce_matmul_precision
    from optimalcontrolmps.ops.sector_chain import chain_final
    from optimalcontrolmps.optimize.penalty import bound_penalty

    psi_f_conj = np.conj(np.asarray(psi_f)).astype(np.complex64)

    @enforce_matmul_precision
    def tot(C):
        U = jax.vmap(basis.convert_control)(C)
        ov = chain_final(st, U, psi_i) @ psi_f_conj
        fid = (ov * ov.conj()).real
        extra = jax.vmap(
            lambda u: regularization(u, GAMMA, st.dt) + bound_penalty(u))(U)
        J = 0.5 * (1.0 - fid) + extra
        return jnp.sum(J), J

    def batch_fg(C):
        (_, J), G = jax.value_and_grad(tot, has_aux=True)(C)
        return J, G

    return batch_fg


def build_solve(mesh=None):
    """Jitted solve(cs) -> (LBFGSResult, best lane) of the flagship; with
    a mesh, the seeds are sharded over all of its devices."""
    import jax
    import jax.numpy as jnp
    from optimalcontrolmps.optimize.lbfgs import minimize_lbfgs_batch

    st, psi_i, psi_f, basis, _ = flagship_problem()
    fg = batch_objective(st, psi_i, psi_f, basis)

    def solve(cs):
        res = minimize_lbfgs_batch(fg, cs, max_iter=MAX_ITER, tol=TOL)
        return res, jnp.argmin(res.f)

    if mesh is None:
        return jax.jit(solve)
    from optimalcontrolmps.parallel.mesh import batch_sharding
    return jax.jit(solve, in_shardings=batch_sharding(mesh))


def run_solve(B, mesh=None):
    """Compile + first solve, then one timed steady solve of B seeds.

    Raises if any cost is non-finite."""
    import jax

    solve = build_solve(mesh=mesh)
    cs = seed_batch(B)
    if mesh is not None:
        from optimalcontrolmps.parallel.mesh import batch_sharding
        put = lambda a: jax.device_put(a, batch_sharding(mesh))
    else:
        put = jax.device_put

    t0 = time.perf_counter()
    res, k = jax.block_until_ready(solve(put(cs)))
    compile_s = time.perf_counter() - t0
    # the steady run uses fresh inputs of the same shape: no recompile
    t0 = time.perf_counter()
    res, k = jax.block_until_ready(solve(put(cs + np.float32(1e-6))))
    steady_s = time.perf_counter() - t0

    fs = np.asarray(res.f)
    if not np.isfinite(fs).all():
        bad = np.flatnonzero(~np.isfinite(fs))
        raise FloatingPointError(
            f"{bad.size} of {B} flagship costs are not finite "
            f"(lanes {bad[:8].tolist()})")
    its = np.asarray(res.iterations)
    k = int(k)
    return {"res": res, "best": k, "costs": fs, "iterations": its,
            "compile_s": compile_s, "steady_s": steady_s,
            "solves_per_s": B / steady_s,
            "c_best": np.asarray(res.x)[k]}


def run_polish(c0, timeout=900):
    """f64 polish of c0 in a CPU-only child process; returns its JSON dict.

    The child never opens the accelerator (it selects the CPU platform
    before JAX starts). Raises if the child fails."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "c0.npz")
        np.savez(path, c0=np.asarray(c0, np.float64))
        here = os.path.dirname(os.path.abspath(__file__))
        out = subprocess.run(
            [sys.executable, os.path.join(here, "bench.py"), "polish", path],
            capture_output=True, text=True, timeout=timeout, cwd=here,
            env={**os.environ, "JAX_PLATFORMS": "cpu"})
    if out.returncode != 0:
        raise RuntimeError(f"polish child failed (rc {out.returncode}):\n"
                           f"{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def polish_main():
    """CPU f64 polish worker: argv[2]=npz with c0; prints one JSON line."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from optimalcontrolmps import sector
    from optimalcontrolmps.optimize import (minimize_lbfgs,
                                            minimize_newton)

    c0 = np.load(sys.argv[2])["c0"].astype(np.float64)
    st, psi_i, psi_f, basis, _ = flagship_problem(f64=True)
    Jpen = _penalized(st, psi_i, psi_f, basis)
    fg = jax.value_and_grad(Jpen)
    res = jax.jit(lambda c: minimize_lbfgs(fg, c, max_iter=200,
                                           tol=OPT_TOL))(jnp.asarray(c0))

    def fgh(c):
        Jv, g = jax.value_and_grad(Jpen)(c)
        H = basis.convert_hessian(sector.hessian(
            st, psi_i, psi_f, basis.convert_control(c), GAMMA))
        return Jv, g, H

    nres = jax.jit(lambda c: minimize_newton(fgh, c, tol=OPT_TOL,
                                             max_iter=20, fun=Jpen))(res.x)
    best = nres if float(nres.f) <= float(res.f) else res
    u_star = basis.convert_control(best.x)
    fid = float(np.asarray(sector.fidelities(st, psi_i, psi_f, u_star))[-1])
    print(json.dumps({
        "f": float(best.f), "grad_norm": float(best.grad_norm),
        "converged": bool(best.converged), "infidelity": 1.0 - fid,
        "lbfgs_iters": int(res.iterations),
        "newton_iters": int(nres.iterations)}))


def grad_mode():
    """Batched cost+gradient evals/s of the graft entry point."""
    import jax
    import __graft_entry__ as ge

    eng = os.environ.get("OCMPS_ENGINE", "sector")
    B = int(os.environ.get("BENCH_BATCH", "16384" if eng == "sector"
                           else "32"))
    fn, _ = ge.entry()
    batched = jax.jit(jax.vmap(fn))
    rng = np.random.default_rng(0)
    cs = rng.uniform(-0.05, 0.05, size=(B, M)).astype(np.float32)
    t0 = time.perf_counter()
    jax.block_until_ready(batched(cs))
    compile_s = time.perf_counter() - t0
    reps = 3
    t0 = time.perf_counter()
    for k in range(reps):
        jax.block_until_ready(batched(cs + np.float32(0.001 * (k + 1))))
    dt = (time.perf_counter() - t0) / reps
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "flagship_grad_evals_per_s",
        "value": B / dt, "unit": "evals/s",
        "meta": {"engine": eng, "batch": B, "platform": dev.platform,
                 "device_kind": dev.device_kind,
                 "compile_s": compile_s}}))


def main():
    import jax
    from optimalcontrolmps.profiling import enable_compile_cache

    enable_compile_cache()
    if jax.devices()[0].platform != "gpu":
        sys.exit("bench.py measures the GPU; JAX found none")
    if os.environ.get("BENCH_MODE") == "grad":
        return grad_mode()

    B = int(os.environ.get("BENCH_BATCH", "4096"))
    out = run_solve(B)
    polish = run_polish(out["c_best"])
    its = out["iterations"]
    dev = jax.devices()[0]
    meta = {
        "batch": B, "platform": dev.platform, "device_kind": dev.device_kind,
        "engine": "sector", "tol_device": TOL,
        "compile_s": out["compile_s"], "steady_s": out["steady_s"],
        "best_cost_c64": float(out["costs"][out["best"]]),
        "median_cost_c64": float(np.median(out["costs"])),
        "iters_min_med_max": [int(its.min()), int(np.median(its)),
                              int(its.max())],
        "best_infidelity": polish["infidelity"],
        "best_cost_f64": polish["f"],
        "converged": polish["converged"],
        "grad_norm_f64": polish["grad_norm"],
        "optTol": OPT_TOL,
    }
    print(json.dumps({"metric": "flagship_solves_per_s",
                      "value": out["solves_per_s"], "unit": "solves/s",
                      "meta": meta}))
    if not polish["converged"]:
        sys.exit("polish did not converge at optTol")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "polish":
        polish_main()
    else:
        main()
