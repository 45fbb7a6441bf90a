"""Launch the BASELINE configs[3]-class solve on the chip.

N=20, d=7, Npart=20, T=6.0, GROUP M=30, exact-Hessian interior point
(streaming block Hessian + host-mode IP), boundary states from the
ramped chi=200 DMRG (artifacts/baseline3/states.npz). The per-iteration
wall is Hessian-dominated (N_t^2/2 row steps per Hessian).

Usage: python tools/run_baseline3.py [InputFile] [out_prefix]
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

os.environ.setdefault("OCMPS_TRUNC_ORTH", "gram")


def main():
    cfg = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        REPO, "artifacts", "baseline3", "InputFile_BHcontrolT6.0")
    prefix = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
        REPO, "artifacts", "baseline3") + os.sep

    from optimalcontrolmps.drivers import optimize_ramp
    from optimalcontrolmps.profiling import enable_compile_cache
    enable_compile_cache()

    t0 = time.time()
    out = optimize_ramp.run(cfg, seed=1, out_prefix=prefix)
    wall = time.time() - t0
    rec = {"status": out["status"], "infidelity": out["infidelity"],
           "wall_s": round(wall, 1)}
    with open(prefix + "run_summary.json", "w") as fh:
        json.dump(rec, fh, indent=1, default=str)
    print(json.dumps(rec, default=str), flush=True)


if __name__ == "__main__":
    main()
