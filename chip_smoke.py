"""Smoke run of the system's main paths on one NVIDIA GPU.

    python chip_smoke.py           # phases 1-4 on the first GPU
    python chip_smoke.py --four    # phase 5 only, on four GPUs

Run from the root of a checkout. Every phase goes through the entry points
a user calls, at the flagship's full size:

1. flagship multistart solve: bench.run_solve (B=4096 seeds, batch
   L-BFGS over the batched sector chain, complex64 / f32 "highest"), then
   the f64 polish of the best-of-batch candidate (bench.run_polish, a
   CPU-only child process) to optTol=1e-8;
2. sector-chain check: chain_final's forward and reversible custom-VJP
   gradient at B=4096, N_t=201 against autodiff through the plain scan on
   the card and against CPU complex128 sector.rollout_final /
   jax.grad(sector.cost);
3. drivers.optimize_ramp.run on examples/InputFile_BHcontrolT2.0
   (precision = double: complex128 on the GPU) with a small maxIter;
4. long-chain vidal TEBD through drivers.analyze_bond_dim.run: N=20, d=7,
   Npart=20, chi=64, truncMethod eigh, 40 steps of dt=5e-3 on the exp
   ramp, against the same steps in complex128 on the CPU;
5. (--four) the phase-1 solve with the batch sharded over a four-GPU
   ("batch", "rows") mesh, against the one-GPU solve of the same seeds.

Phase 3 runs last: precision = double turns on x64 for the rest of the
process. CPU references run in child processes that select the CPU
platform before JAX starts, so only this process uses the card. Each
phase prints its time and result; the last line is one JSON object,
printed only when every phase passed. Without a GPU the script exits
non-zero before any phase. Outputs go to chiprun_out/chip_smoke/.
"""

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "chiprun_out", "chip_smoke")
B = 4096

# phase 1: bound on the f64 polish optimum (the known optimum of the
# flagship is J* = 4.942845820e-3, infidelity 4.1185e-3)
BEST_COST_F64 = 4.9429e-3

# phase 2 tolerances at f32 "highest" (IEEE FP32) after 200 chain steps.
# (The CPU comparison bounds the forward; on the card, forward and plain
# autodiff run the same scan, so only the gradients differ there.)
# The 51-step CPU tests hold 2e-5 / 3e-5*max|g|; rounding in the unitary
# chain grows with the number of steps (about linearly for the state,
# and the reversible backward adds the forward's error to the cotangent's
# own), so 4x the steps take 5x the state bound and 10x the gradient's.
# An error near 1e-3 would mean TF32 reached a product.
TOL_PSI = 1e-4
TOL_GRAD_REL = 3e-4
N_REF_LANES = 8

# phase 4: the repo's own f32-vs-f64 TEBD bound (tests/test_vidal.py)
TOL_INFIDELITY = 1e-4
VIDAL_CFG = dict(N=20, Npart=20, d=7, tstep=5e-3, T=0.2, chi=64,
                 chi_prep=16)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def cpu_child(job, payload):
    """Run `job` of this script in a CPU-only child; returns its npz."""
    os.makedirs(OUT, exist_ok=True)
    inp = os.path.join(OUT, f"{job}_in.npz")
    out = os.path.join(OUT, f"{job}_out.npz")
    np.savez(inp, **payload)
    r = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--cpu-child", job,
         inp, out], capture_output=True, text=True, timeout=900, cwd=HERE,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    if r.returncode != 0:
        raise RuntimeError(f"CPU child '{job}' failed:\n{r.stderr[-4000:]}")
    return dict(np.load(out))


def check(ok, what):
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_flagship():
    import bench
    r = bench.run_solve(B)
    its = r["iterations"]
    print(f"  solve: compile {r['compile_s']:.2f}s, steady "
          f"{r['steady_s']:.4f}s, {r['solves_per_s']:.1f} solves/s; "
          f"iterations min/median/max {its.min()}/{int(np.median(its))}/"
          f"{its.max()}; best c64 cost {r['costs'][r['best']]:.9e}")
    t0 = time.perf_counter()
    pol = bench.run_polish(r["c_best"])
    print(f"  polish (CPU f64 child, {time.perf_counter() - t0:.1f}s): "
          f"{pol}")
    check(pol["converged"], "polish did not converge at optTol 1e-8")
    check(pol["f"] <= BEST_COST_F64,
          f"best_cost_f64 {pol['f']:.9e} > {BEST_COST_F64}")


def phase_chain():
    import jax
    import jax.numpy as jnp
    import bench
    from optimalcontrolmps.ops import sector_chain as sc
    from optimalcontrolmps.ops.precision import enforce_matmul_precision

    st, psi_i, psi_f, basis, _ = bench.flagship_problem()
    psi_f_conj = np.conj(np.asarray(psi_f)).astype(np.complex64)
    U = jax.jit(enforce_matmul_precision(jax.vmap(basis.convert_control)))(
        bench.seed_batch(B))

    def fwd_grad(chain):
        def loss(U):
            psiT = chain(st, U, psi_i)
            ov = psiT @ psi_f_conj
            return jnp.sum(0.5 * (1.0 - (ov * ov.conj()).real)), psiT
        f = jax.jit(enforce_matmul_precision(
            jax.value_and_grad(loss, has_aux=True)))
        (_, psiT), g = jax.block_until_ready(f(U))
        return np.asarray(psiT), np.asarray(g)

    psi_k, g_k = fwd_grad(sc.chain_final)
    psi_s, g_s = fwd_grad(sc.chain_final_autodiff)
    dpsi = np.abs(psi_k - psi_s).max()
    dg = np.abs(g_k - g_s).max() / np.abs(g_s).max()
    print(f"  reversible vs autodiff through the scan, on the card: "
          f"max|dpsi_T| {dpsi:.3e}, max|dg|/max|g| {dg:.3e}")
    ref = cpu_child("chain", {"u": np.asarray(U[:N_REF_LANES])})
    dpsi_c = np.abs(psi_k[:N_REF_LANES] - ref["psiT"]).max()
    dg_c = (np.abs(g_k[:N_REF_LANES] - ref["grad"]).max()
            / np.abs(ref["grad"]).max())
    print(f"  card vs CPU complex128 ({N_REF_LANES} lanes): "
          f"max|dpsi_T| {dpsi_c:.3e}, max|dg|/max|g| {dg_c:.3e}")
    check(max(dpsi, dpsi_c) <= TOL_PSI, f"|dpsi_T| above {TOL_PSI}")
    check(max(dg, dg_c) <= TOL_GRAD_REL, f"gradient above {TOL_GRAD_REL}")


def _bond_dim_config(path):
    from optimalcontrolmps.config import write_input_file
    c = VIDAL_CFG
    write_input_file(path, {"N": c["N"], "Npart": c["Npart"], "d": c["d"],
                            "tstep": c["tstep"], "T": c["T"],
                            "precision": "single"})


def _bond_dim_run(dtype, prefix):
    from optimalcontrolmps.drivers import analyze_bond_dim
    cfg = os.path.join(OUT, "InputFile_bonddim")
    _bond_dim_config(cfg)
    res = analyze_bond_dim.run(
        cfg, bond_dims=(VIDAL_CFG["chi"],), dtype=dtype, chunk=20,
        chi_prep=VIDAL_CFG["chi_prep"], want_gradient=False,
        out_prefix=os.path.join(OUT, prefix))
    return res[VIDAL_CFG["chi"]]


def _mps_fidelity(A, B):
    """|<A|B>|^2 / (<A|A><B|B>) of two (L, chi, p, chi) MPS, on the host."""
    def ov(X, Y):
        env = np.einsum("apb,apc->bc", X[0].conj(), Y[0])
        for i in range(1, X.shape[0]):
            env = np.einsum("ac,apb,cpd->bd", env, X[i].conj(), Y[i])
        return np.trace(env)
    A = A.astype(np.complex128)
    B = B.astype(np.complex128)
    return abs(ov(A, B)) ** 2 / (ov(A, A).real * ov(B, B).real)


def phase_vidal():
    import jax.numpy as jnp
    os.makedirs(OUT, exist_ok=True)
    t0 = time.perf_counter()
    r = _bond_dim_run(jnp.complex64, "gpu_")
    print(f"  GPU complex64 (prep included, {time.perf_counter() - t0:.1f}"
          f"s): propagation {r['t_fidelity']:.2f}s (compile "
          f"{r['compile_s']:.2f}s); F(T) {r['fids'][-1]:.8f}")
    ref = cpu_child("vidal", {})
    one_minus_f = 1.0 - _mps_fidelity(r["final_B"], ref["B"])
    dlam = np.abs(r["final_lam"] - ref["lam"]).max()
    print(f"  vs CPU complex128: 1-|<psi_gpu|psi_cpu>|^2 {one_minus_f:.3e},"
          f" max|d Schmidt value| {dlam:.3e}")
    check(one_minus_f <= TOL_INFIDELITY,
          f"1-F {one_minus_f:.3e} > {TOL_INFIDELITY}")


def phase_optimize_ramp():
    import jax
    from optimalcontrolmps.config import parse_input_file, \
        write_input_file
    from optimalcontrolmps.drivers import optimize_ramp

    os.makedirs(OUT, exist_ok=True)
    cfg = parse_input_file(os.path.join(HERE, "examples",
                                        "InputFile_BHcontrolT2.0"))
    cfg_path = os.path.join(OUT, "InputFile_BHcontrolT2.0")
    write_input_file(cfg_path, {**cfg.values, "maxIter": 20})
    prefix = os.path.join(OUT, "optimize_ramp_")
    res = optimize_ramp.run(cfg_path, seed=1, out_prefix=prefix)
    ramp = np.loadtxt(prefix + "BHrampInitialFinal.txt")
    f_init, f_final = ramp[-1, 2], ramp[-1, 4]
    print(f"  device {res['device']}, x64 {jax.config.jax_enable_x64}; "
          f"F(T) {f_init:.6f} -> {f_final:.6f}; status {res['status']}")
    check(res["device"] == "gpu", "optimize_ramp did not run on the GPU")
    check(f_final > f_init, "the cost did not decrease")
    for name in ("BHrampInitialFinal.txt", "GROUPHessian.txt",
                 "GRAPEHessian.txt", "ExpectationN.txt",
                 "ProgressCache.txt"):
        check(os.path.getsize(prefix + name) > 0, f"{name} not written")


def _eval_ms(fg, cs, reps=5):
    """Median ms of one batch objective evaluation (cost + gradient)."""
    import jax
    fg = jax.jit(fg)
    jax.block_until_ready(fg(cs))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fg(cs))
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


def phase_four():
    import jax
    import bench
    from optimalcontrolmps.parallel.mesh import batch_sharding, make_mesh

    devices = jax.devices()
    check(len(devices) == 4, f"--four needs 4 GPUs, found {len(devices)}")
    mesh = make_mesh(4)
    four = bench.run_solve(B, mesh=mesh)
    shards = four["res"].x.addressable_shards
    rows = sorted((s.device.id, s.data.shape[0]) for s in shards)
    # nothing of size may live on one device alone: every live array of
    # 1 MiB or more must be spread over all four
    single = [a.shape for a in jax.live_arrays()
              if a.nbytes >= 2 ** 20 and len(a.sharding.device_set) < 4]
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in devices]
    print(f"  4 GPUs: compile {four['compile_s']:.2f}s, steady "
          f"{four['steady_s']:.4f}s, {four['solves_per_s']:.1f} solves/s; "
          f"rows per device {rows}; peak bytes per device {peaks} "
          f"(device 0 also ran the compiler's autotuning)")
    check(len(shards) == 4 and all(n == B // 4 for _, n in rows),
          "the batch is not split evenly over the four GPUs")
    check(not single, f"arrays on fewer than four GPUs: {single}")
    st, psi_i, psi_f, basis, _ = bench.flagship_problem()
    fg = bench.batch_objective(st, psi_i, psi_f, basis)
    cs = bench.seed_batch(B)
    print(f"  one evaluation: 4 GPUs "
          f"{_eval_ms(fg, jax.device_put(cs, batch_sharding(mesh))):.2f} "
          f"ms, 1 GPU {_eval_ms(fg, jax.device_put(cs)):.2f} ms")
    one = bench.run_solve(B)
    print(f"  1 GPU: steady {one['steady_s']:.4f}s, "
          f"{one['solves_per_s']:.1f} solves/s")
    best4, best1 = four["costs"][four["best"]], one["costs"][one["best"]]
    differ = int(np.sum(four["iterations"] != one["iterations"]))
    print(f"  best cost 4 GPUs {best4:.9e} vs 1 GPU {best1:.9e} "
          f"(|d| {abs(best4 - best1):.2e}); lanes whose iteration count "
          f"differs: {differ} of {B}")
    check(abs(best4 - best1) <= 1e-6, "best cost differs by more than 1e-6")


# ---------------------------------------------------------------------------
# CPU reference children
# ---------------------------------------------------------------------------

def cpu_child_main(job, inp, out):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    if job == "chain":
        import bench
        from optimalcontrolmps import sector
        st, psi_i, psi_f, _, _ = bench.flagship_problem(f64=True)
        u = np.load(inp)["u"].astype(np.float64)
        psiT = np.stack([np.asarray(sector.rollout_final(st, psi_i, x))
                         for x in u])
        grad = jax.jit(jax.vmap(jax.grad(
            lambda x: sector.cost(st, psi_i, psi_f, x, 0.0))))(u)
        np.savez(out, psiT=psiT, grad=np.asarray(grad))
    elif job == "vidal":
        r = _bond_dim_run(jnp.complex128, "cpu_")
        np.savez(out, B=r["final_B"], lam=r["final_lam"])
    else:
        raise ValueError(job)


def main():
    if sys.argv[1:2] == ["--cpu-child"]:
        return cpu_child_main(*sys.argv[2:5])
    four = "--four" in sys.argv[1:]

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke.py needs a GPU; JAX found '{dev.platform}'")
    from optimalcontrolmps.profiling import enable_compile_cache
    enable_compile_cache()
    print(card_line(), flush=True)
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}",
          flush=True)

    phases = ([("four-GPU multistart", phase_four)] if four else [
        ("flagship multistart solve", phase_flagship),
        ("sector-chain check", phase_chain),
        ("vidal TEBD chi=64", phase_vidal),
        ("optimize_ramp (precision double)", phase_optimize_ramp)])
    failed = []
    for name, fn in phases:
        print(f"[{name}]", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
            status = "PASS"
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            status = "FAIL"
            failed.append(name)
        print(f"  {status} in {time.perf_counter() - t0:.1f}s", flush=True)
    if failed:
        sys.exit(f"failed phases: {failed}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
