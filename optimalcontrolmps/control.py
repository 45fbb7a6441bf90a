"""GROUP control parameterization: reduced-basis controls.

Rebuild of ControlBasis (/root/reference/include/ControlBasis.hpp:14-41,
/root/reference/src/ControlBasis.cpp) and ControlBasisFactory
(/root/reference/include/ControlBasisFactory.hpp:15-53). The reference's
nested std::vector loops become three einsums — plain GEMMs,
batchable over thousands of coefficient vectors.

    u(t_i) = u0_i + S_i * sum_n c_n f_{i,n}          (convertControl)
    (dJ/dc)_n = sum_i S_i f_{i,n} (dJ/du)_i          (convertGradient)
    H_c = B^T H_u B,  B_{i,n} = S_i f_{i,n}          (convertHessian)

The `new_control`/ucurrent caching of the reference (ControlBasis.cpp:53-66)
is dropped: functional callers just reuse values.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from . import seeds

# The reference defines PI = 3.14159265 (truncated!) in
# ControlBasisFactory.hpp:9 and builds the sine basis with it. We use the
# same constant so golden basis/cost vectors match to 5e-6.
REFERENCE_PI = 3.14159265

__all__ = ["ControlBasis", "chopped_sine_basis", "REFERENCE_PI"]


@partial(jax.tree_util.register_dataclass,
         data_fields=["u0", "S", "f"],
         meta_fields=[])
@dataclasses.dataclass(frozen=True)
class ControlBasis:
    """u(t) = u0 + S * (f @ c). Shapes: u0, S: (N,); f: (N, M)."""
    u0: jnp.ndarray
    S: jnp.ndarray
    f: jnp.ndarray

    @property
    def N(self) -> int:
        return self.u0.shape[0]

    @property
    def M(self) -> int:
        return self.f.shape[1]

    def jacobian(self) -> jnp.ndarray:
        """du_i/dc_n = S_i f_{i,n} (ControlBasis.cpp:8-24)."""
        return self.S[:, None] * self.f

    def convert_control(self, c: jnp.ndarray) -> jnp.ndarray:
        """(ControlBasis.cpp:49-67)"""
        return self.u0 + self.S * (self.f @ c)

    def convert_gradient(self, grad_u: jnp.ndarray) -> jnp.ndarray:
        """(ControlBasis.cpp:70-89)"""
        return self.jacobian().T @ grad_u

    def convert_hessian(self, hess_u: jnp.ndarray) -> jnp.ndarray:
        """(ControlBasis.cpp:92-119)"""
        B = self.jacobian()
        return B.T @ hess_u @ B


def chopped_sine_basis(u0, tstep: float, T: float, M: int,
                       dtype=jnp.float64) -> ControlBasis:
    """Chopped sine basis with stitched-sigmoid shape function
    (ControlBasisFactory.hpp:25-53):

      f_{i,n} = sin((n+1) * PI * tstep * i / T)
      S = sigmoid(x; k=8, off=1.1) stitched at N/2 with
          sigmoid(x; k=-8, off=98.9) on x = linspace(0, 100, N),
          endpoints forced to 0 (pins u(0), u(T)).
    """
    u0 = np.asarray(u0, dtype=np.float64)
    N = u0.shape[0]
    assert abs(N - (1 + T / tstep)) < 1e-5, (N, T, tstep)

    x = seeds.linspace(0.0, 100.0, N)
    S = seeds.sigmoid(x, 8.0, 1.1)
    S2 = seeds.sigmoid(x, -8.0, 100.0 - 1.1)
    S[N // 2:] = S2[N // 2:]
    S[0] = 0.0
    S[N - 1] = 0.0

    i = np.arange(N, dtype=np.float64)[:, None]
    n = np.arange(M, dtype=np.float64)[None, :]
    f = np.sin((n + 1.0) * REFERENCE_PI * tstep * i / T)

    np_dtype = np.dtype(dtype)
    return ControlBasis(u0=u0.astype(np_dtype), S=S.astype(np_dtype),
                        f=f.astype(np_dtype))  # host numpy leaves
