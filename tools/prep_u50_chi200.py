"""One-off CPU prep: U=50 (deep Mott) boundary state for BASELINE
configs[3] (L=20, d=7, Npart=20, chi=200).

The Mott ground state's Schmidt rank is tiny (the U=2.5 superfluid state
needed the full chi=200 ramp, artifacts/dmrg_chi200.log: 96 CPU-min),
so prep runs the ramped DMRG only to chi=100 and zero-pad-embeds to 200
— the same chi_prep policy as drivers/prep_states.py. Writes A/E npz
next to the existing L20d7chi200_U2.5.npz.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np

from optimalcontrolmps import dmrg, mps

L, d, npart, J, U = 20, 7, 20, 1.0, 50.0
chi_prep, chi = 100, 200
out = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   ".state_cache", f"L{L}d{d}chi{chi}_U{U}.npz")

t0 = time.time()
A, E = dmrg.dmrg_ground_state(L, d, npart, J, U, chi_prep, n_sweeps=8,
                              verbose=True)
A = mps.pad_chi(np.asarray(A), chi)
np.savez(out, A=A, E=np.asarray(E))
print(f"U={U} done E= {float(E)} wall {time.time()-t0:.1f}s -> {out}",
      flush=True)
