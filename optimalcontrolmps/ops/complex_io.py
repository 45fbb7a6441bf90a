"""Complex host<->device boundary as real float planes.

Complex arrays cross the host<->device boundary as two real planes that
are fused (or split) on the device. CPU and GPU backends transfer
complex arrays natively, so nothing here is required on them; the layer
is kept because drivers and streaming code route their transfers through
it (removing it is a design item in ROADMAP.md).

The boundary discipline:

* `put(x)` — move a host complex array onto the device by transferring
  its real/imag float planes and fusing them on-device with
  `lax.complex` (one tiny jitted program per dtype/shape). Real arrays
  pass through to `jax.device_put`.
* `get(x)` — fetch a device complex array by downloading the two float
  planes (device-side `.real`/`.imag` compute) and recombining on host.
* `split(tree)` / `merge(tree)` — pytree-wide versions used by
  `complex_io(fn)`, which wraps a function so every complex leaf crosses
  the jit boundary as a `CSplit(re, im)` pair: split on host (numpy, no
  transfer), merged back to complex INSIDE the traced function, outputs
  split on-device and merged on host. Use this when the inputs live on
  host anyway (probes, drivers); use `put`/`get` when you want resident
  device buffers reused across many calls.

Everything is a no-op performance-wise on CPU/GPU (two float transfers
instead of one complex transfer), so the wrappers are safe to apply
unconditionally.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["CSplit", "split", "merge", "put", "get", "complex_io"]


class CSplit(NamedTuple):
    """A complex array split into its real/imag float planes (a pytree
    node, so it flows through jit/vmap/scan boundaries as two real
    leaves)."""
    re: Any
    im: Any


def _is_complex(x) -> bool:
    dt = getattr(x, "dtype", None)
    return dt is not None and np.issubdtype(dt, np.complexfloating)


def split(tree):
    """Replace every complex leaf with CSplit(re, im). Host-side numpy
    arrays split without touching the device; device arrays split with
    on-device compute (both supported)."""
    def f(x):
        if _is_complex(x):
            if isinstance(x, np.ndarray) or np.isscalar(x):
                x = np.asarray(x)
                return CSplit(np.ascontiguousarray(x.real),
                              np.ascontiguousarray(x.imag))
            return CSplit(x.real, x.imag)
        return x
    return jax.tree_util.tree_map(f, tree)


def merge(tree):
    """Recombine every CSplit(re, im) into a complex array. Inside a
    traced function this is `lax.complex` (pure on-device compute); on
    host it is numpy."""
    def f(x):
        if isinstance(x, CSplit):
            if isinstance(x.re, np.ndarray) or np.isscalar(x.re):
                return np.asarray(x.re) + 1j * np.asarray(x.im)
            return jax.lax.complex(jnp.asarray(x.re), jnp.asarray(x.im))
        return x
    return jax.tree_util.tree_map(
        f, tree, is_leaf=lambda x: isinstance(x, CSplit))


@functools.lru_cache(maxsize=None)
def _fuse_fn():
    return jax.jit(lambda r, i: jax.lax.complex(r, i))


@functools.lru_cache(maxsize=None)
def _plane_fn():
    return jax.jit(lambda z: (z.real, z.imag))


def put(x, device=None):
    """Device-put that never transfers complex bytes: complex arrays go
    up as two float planes and are fused on-device."""
    if _is_complex(x):
        x = np.asarray(x)
        r = jax.device_put(np.ascontiguousarray(x.real), device)
        i = jax.device_put(np.ascontiguousarray(x.imag), device)
        return _fuse_fn()(r, i)
    return jax.device_put(x, device)


def get(x) -> np.ndarray:
    """Fetch to host; complex arrays come down as two float planes."""
    if _is_complex(x) and not isinstance(x, np.ndarray):
        r, i = _plane_fn()(x)
        return np.asarray(r) + 1j * np.asarray(i)
    return np.asarray(x)


def complex_io(fn):
    """Wrap `fn` so complex pytree leaves cross its boundary as real
    pairs. The returned callable accepts/returns complex arrays exactly
    like `fn`; internally it jits a split-boundary twin. Keyword args are
    passed through un-split (use them for static config only)."""
    @functools.wraps(fn)
    def inner(*split_args, **kwargs):
        out = fn(*merge(split_args), **kwargs)
        return split(out)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        return merge(inner(*split(args), **kwargs))

    wrapped.__wrapped_inner__ = inner
    return wrapped
