"""Finalize-from-checkpoint for the BASELINE configs[3] run.

Failure-recovery tooling: if the optimizing process is interrupted
(wall-clock bound, worker crash) after k iterations, this script loads
the durable checkpoint (primal iterate + multipliers) and produces the
same finalize artifacts the driver would have written — streaming
fidelity ramp file + ExpectationN — without re-entering the optimizer.
Mirrors drivers/optimize_ramp.py's finalize block (src/BH_nlp.cpp:
207-289 analogue).

Usage: python tools/finalize_baseline3.py [outdir]
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("OCMPS_TRUNC_ORTH", "gram")

import numpy as np


def main():
    outdir = (sys.argv[1] if len(sys.argv) > 1
              else os.path.join(REPO, "artifacts", "baseline3"))
    prefix = outdir + os.sep

    import jax
    import jax.numpy as jnp

    from optimalcontrolmps import io as iolib
    from optimalcontrolmps import vidal
    from optimalcontrolmps.backends import engine_for
    from optimalcontrolmps.config import parse_input_file
    from optimalcontrolmps.drivers.common import build_problem, time_axis
    from optimalcontrolmps.ops import complex_io as cio
    from optimalcontrolmps.profiling import enable_compile_cache

    enable_compile_cache()
    cfg = parse_input_file(os.path.join(outdir, "InputFile_BHcontrolT6.0"))
    p = build_problem(cfg, seed=1, engine=cfg.get_string("engine", "auto"),
                      state_cache=prefix + "states.npz")
    c_opt, extra = iolib.load_checkpoint(prefix + "checkpoint.json")
    c_opt = np.asarray(c_opt, np.float32)
    print(f"checkpoint: iters={extra.get('iters')} cost={extra.get('cost')}"
          f" kkt={extra.get('kkt')}", flush=True)

    st, basis, eng = p.stepper, p.basis, engine_for(p.stepper)
    _put = lambda a: cio.put(a) if isinstance(a, np.ndarray) else a
    psi_i = jax.tree_util.tree_map(_put, p.psi_i)
    psi_f = jax.tree_util.tree_map(_put, p.psi_f)
    fids_j = jax.jit(lambda p0, pt, c: eng.fidelities_streaming(
        st, p0, pt, basis.convert_control(c)))
    times = time_axis(p)
    u_init = np.asarray(basis.convert_control(jnp.zeros(p.M)))
    u_final = np.asarray(basis.convert_control(jnp.asarray(c_opt)))
    fid_init = np.asarray(fids_j(psi_i, psi_f, jnp.zeros(p.M)))
    fid_final = np.asarray(fids_j(psi_i, psi_f, jnp.asarray(c_opt)))
    iolib.write_ramp_file(prefix + "BHrampInitialFinal.txt", times,
                          u_init, fid_init, u_final, fid_final)
    print(f"F(T): initial {fid_init[-1]:.6f} -> final {fid_final[-1]:.6f}",
          flush=True)

    from optimalcontrolmps.mps import expectation_values
    from optimalcontrolmps.sites import op
    from optimalcontrolmps.streaming import rollout_measure
    n_op = op("N", p.d)
    expn = jax.jit(lambda p0, uu: rollout_measure(
        lambda s, ua, ub: vidal.vidal_step(st, s, ua, ub, True), p0, uu,
        lambda s: expectation_values(s.B, n_op).real))(
            psi_i, jnp.asarray(u_final, jnp.float32))
    iolib.write_expectation_file(prefix + "ExpectationN.txt", times,
                                 np.asarray(expn))
    summary = {"iterations": extra.get("iters"), "cost": extra.get("cost"),
               "kkt": extra.get("kkt"),
               "fidelity_T_initial": float(fid_init[-1]),
               "fidelity_T_final": float(fid_final[-1])}
    with open(prefix + "finalize_summary.json", "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
