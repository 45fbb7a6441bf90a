"""True multi-process jax.distributed exercise (round-4 VERDICT #9).

Launches N worker processes (CPU backend, 2 virtual devices each), each
calling parallel.mesh.init_distributed against a shared coordinator,
builds the global ("batch",) mesh over all processes' devices, and runs
the sharded multistart L-BFGS step with a cross-PROCESS argmin
collective — the one distributed code path a single-process dryrun
cannot execute. Rank 0 writes artifacts/distributed_2proc.json.

Usage: python tools/probe_distributed.py [nprocs]    (parent)
       python tools/probe_distributed.py WORKER <rank> <nprocs> <port>
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def worker(rank: int, nprocs: int, port: int):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from optimalcontrolmps.parallel.mesh import init_distributed

    nproc, pid = init_distributed(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nprocs, process_id=rank)
    assert nproc == nprocs and pid == rank, (nproc, pid)
    ndev = len(jax.devices())           # global device count
    nloc = len(jax.local_devices())

    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    mesh = Mesh(np.asarray(jax.devices()).reshape(ndev), ("batch",))

    # sharded multistart: each process owns its local shard of the seed
    # batch; the argmin reduction crosses the process boundary
    from optimalcontrolmps import control, sector, seeds
    from optimalcontrolmps.optimize import minimize_lbfgs
    from optimalcontrolmps.optimize.penalty import bound_penalty

    T, dt, M, L, d, npart, gamma = 0.5, 0.01, 8, 4, 3, 4, 1e-6
    N = int(round(T / dt)) + 1
    st = sector.make_sector_stepper(L, d, npart, 1.0, dt)
    psi_i = sector.sector_ground_state(L, d, npart, 1.0, 2.5)
    psi_f = sector.sector_ground_state(L, d, npart, 1.0, 50.0)
    rng = np.random.default_rng(123456789)
    basis = control.chopped_sine_basis(
        seeds.linsigmoid_seed(2.5, 50.0, N, rng=rng), dt, T, M)

    def Jpen(c):
        u = basis.convert_control(c)
        return sector.cost(st, psi_i, psi_f, u, gamma) + bound_penalty(u)

    fg = jax.value_and_grad(Jpen)
    B = 4 * ndev
    # identical global batch on every process (counter-based seeds);
    # make_array_from_callback hands each process its local rows
    rngb = np.random.default_rng(7)
    cs_global = rngb.normal(0.0, 0.5, (B, M)).astype(np.float64)
    sharding = NamedSharding(mesh, P("batch"))
    cs = jax.make_array_from_callback(
        (B, M), sharding, lambda idx: cs_global[idx])

    @jax.jit
    def solve_best(cs):
        res = jax.vmap(lambda c: minimize_lbfgs(fg, c, max_iter=60,
                                                tol=1e-6))(cs)
        k = jnp.argmin(res.f)           # global argmin -> collective
        return res.f[k], res.x[k], jnp.sum(res.iterations)

    t0 = time.time()
    f_best, c_best, iters = solve_best(cs)
    wall = time.time() - t0
    out = {"processes": nproc, "rank": pid, "global_devices": ndev,
           "local_devices": nloc, "batch": B,
           "best_cost": float(f_best), "total_iters": int(iters),
           "wall_s": round(wall, 2)}
    print(json.dumps(out), flush=True)
    if pid == 0:
        # single-process reference value for the cross-check
        res_ref = jax.jit(jax.vmap(
            lambda c: minimize_lbfgs(fg, c, max_iter=60, tol=1e-6)))(
                jnp.asarray(cs_global))
        out["best_cost_singleproc"] = float(jnp.min(res_ref.f))
        out["match"] = abs(out["best_cost"]
                           - out["best_cost_singleproc"]) < 1e-12
        with open(os.path.join(REPO, "artifacts",
                               "distributed_2proc.json"), "w") as fh:
            json.dump(out, fh, indent=1)
        print("rank0 match:", out["match"], flush=True)
    jax.distributed.shutdown()


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "WORKER":
        return worker(int(sys.argv[2]), int(sys.argv[3]),
                      int(sys.argv[4]))
    nprocs = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    port = 12355
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "WORKER", str(r),
         str(nprocs), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(nprocs)]
    rc = 0
    for r, p in enumerate(procs):
        out, _ = p.communicate(timeout=1200)
        print(f"--- rank {r} (rc={p.returncode}) ---\n{out}")
        rc |= p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
