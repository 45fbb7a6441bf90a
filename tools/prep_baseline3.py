"""Assemble the BASELINE configs[3] boundary-state cache + InputFile.

Takes the ramped-DMRG A-tensor caches (.state_cache/L20d7chi200_U2.5.npz
at full chi=200 — 96 CPU-min prep, artifacts/dmrg_chi200.log — and
L20d7chi200_U50.0.npz at chi_prep=100 zero-pad-embedded, deep-Mott state),
converts them to canonical-form VidalStates with matrix carriers (the
matmul-only representation of truncMethod nssub), casts to
the run dtype, and writes the io.save_states npz with the EXACT problem
fingerprint drivers/common.build_problem computes for the run config —
so `optimize_ramp` skips state prep entirely and goes straight to the
interior point.

Usage: python tools/prep_baseline3.py <outdir> [chi] [tstep] [M]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np

from optimalcontrolmps import io as iolib
from optimalcontrolmps import seeds, vidal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

L, d, npart, J = 20, 7, 20, 1.0
U_I, U_F = 2.5, 50.0
T = 6.0


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        REPO, "artifacts", "baseline3")
    chi = int(sys.argv[2]) if len(sys.argv) > 2 else 200
    tstep = float(sys.argv[3]) if len(sys.argv) > 3 else 0.02
    M = int(sys.argv[4]) if len(sys.argv) > 4 else 30
    os.makedirs(outdir, exist_ok=True)

    n_steps = int(T / tstep + 1)
    # the exact u0 the driver will generate (seed=1, OptimizeRamp.cpp:60,83)
    rng = np.random.default_rng(123456789 * 1)
    u0 = seeds.linsigmoid_seed(U_I, U_F, n_steps, rng=rng)

    def load_vidal(path, chi):
        z = np.load(path)
        A = np.asarray(z["A"])
        if A.shape[1] < chi:
            from optimalcontrolmps import mps
            A = mps.pad_chi(A, chi)
        v = vidal.from_mps(A)
        if v.B.shape[1] > chi:
            # canonical truncation: from_mps orders each bond's Schmidt
            # values descending, so keeping the leading chi directions
            # IS the optimal-weight truncation; renormalize the kept
            # spectra (the U=2.5 chi=200 superfluid state carries
            # ~<1e-7 weight beyond chi=128)
            B = np.asarray(v.B)[:, :chi, :, :chi]
            lam = np.asarray(v.lam)[:, :chi]
            lam = lam / np.linalg.norm(lam, axis=1, keepdims=True)
            v = vidal.VidalState(B=B, lam=lam)
        v = vidal.to_matrix_carriers(v)
        return vidal.VidalState(
            B=np.asarray(v.B, dtype=np.complex64),
            lam=np.asarray(v.lam, dtype=np.complex64))

    for c in sorted({chi, 128, 200}):
        psi_i = load_vidal(os.path.join(REPO, ".state_cache",
                                        "L20d7chi200_U2.5.npz"), c)
        psi_f = load_vidal(os.path.join(REPO, ".state_cache",
                                        "L20d7chi200_U50.0.npz"), c)
        meta = {"L": L, "d": d, "npart": npart, "chi": c,
                "engine": "vidal", "trunc": "nssub",
                "u_ends": [float(u0[0]), float(u0[-1])],
                "dtype": "complex64"}
        name = ("states.npz" if c == chi else f"states_chi{c}.npz")
        iolib.save_states(os.path.join(outdir, name), psi_i, psi_f, meta)
        print(f"{name} written:", json.dumps(meta), flush=True)

    cfgpath = os.path.join(outdir, "InputFile_BHcontrolT6.0")
    open(cfgpath, "w").write(f"""input
{{
N = {L}
Npart = {npart}
d = {d}
T = {T}
tstep = {tstep}
M = {M}
gamma = 1e-6
maxBondDim = {chi}
threshold = 1e-8
optTol = 1e-8
useBFGS = no
maxIter = 10
cacheProgress = yes
engine = vidal
truncMethod = nssub
precision = single
muStrategy = adaptive
ipMode = host
hessianRowBlock = 60
stateCache = yes
maxCPUHours = 6
writeHessians = no
resume = no
}}
""")
    print("config written:", cfgpath)


if __name__ == "__main__":
    main()
