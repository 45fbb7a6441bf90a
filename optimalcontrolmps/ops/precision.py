"""Matmul-precision policy for the hot contraction paths.

An accelerator may run a float32 matmul at reduced input precision unless
asked not to: on an NVIDIA GPU, XLA's default precision lets cuBLAS use
TF32 (10-bit mantissa). For this physics that is not a speed/accuracy
knob — it is wrong: the flagship cost evaluates ~1600 chained bond
contractions + truncations per rollout, and reduced-precision products
accumulate to ~1e-2 relative error in the cost (an earlier bf16-pass
measurement; the CholeskyQR gauge's Gram matrix even goes indefinite and
yields NaN). With "highest" (IEEE FP32 products on a GPU) every
production variant lands within 6e-6 of the complex128 golden. The
reference runs f64 LAPACK throughout (ITensor denmatDecomp), so
f32-highest is the minimum honest precision for parity. Whether TF32 or
3xTF32 holds the golden tolerances anywhere is an open item in
ROADMAP.md. A Pallas kernel would not see this setting: its dots must
name their precision themselves.

Every public propagator/derivative entry point is wrapped with
`enforce_matmul_precision` so correctness never depends on a global flag
the caller forgot to set. The policy is resolved PER CALL: either the last
`set_policy(...)` value, or (if unset) the current OCMPS_MATMUL_PRECISION
environment variable — so tests/notebooks/A-B harnesses can change it
after import. Opt out (for A/B experiments only) with
OCMPS_MATMUL_PRECISION=default or set_policy("default").
"""

from __future__ import annotations

import functools
import os

import jax

__all__ = ["enforce_matmul_precision", "set_policy", "get_policy"]

_POLICY_OVERRIDE: str | None = None


def set_policy(policy: str | None) -> None:
    """Override the matmul-precision policy ("highest", "high", "default",
    or None to fall back to the OCMPS_MATMUL_PRECISION env var). Takes
    effect on the next traced call; already-compiled jit caches keep the
    policy they were traced under."""
    global _POLICY_OVERRIDE
    _POLICY_OVERRIDE = policy


def get_policy() -> str:
    """The policy in effect for the next call."""
    if _POLICY_OVERRIDE is not None:
        return _POLICY_OVERRIDE
    return os.environ.get("OCMPS_MATMUL_PRECISION", "highest")


def enforce_matmul_precision(fn):
    """Trace `fn`'s body under the package matmul-precision policy
    (resolved per call — see set_policy)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        policy = get_policy()
        if policy == "default":
            return fn(*args, **kwargs)
        with jax.default_matmul_precision(policy):
            return fn(*args, **kwargs)

    return wrapped
