"""Tests for the complex-safe device boundary (ops/complex_io.py).

Complex arrays cross the host<->device boundary as real float planes.
These tests validate the split/merge discipline on the CPU backend.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from optimalcontrolmps.ops import complex_io as cio


def _z(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


def test_put_get_roundtrip():
    z = _z((5, 7))
    d = cio.put(z)
    assert d.dtype == jnp.complex64
    np.testing.assert_allclose(cio.get(d), z, rtol=1e-6)


def test_put_real_passthrough():
    x = np.arange(6.0, dtype=np.float32)
    d = cio.put(x)
    assert d.dtype == jnp.float32
    np.testing.assert_allclose(cio.get(d), x)


def test_split_merge_pytree():
    tree = {"a": _z((3,)), "b": np.float32(2.0), "c": [_z((2, 2)), 1.5]}
    st = cio.split(tree)
    # complex leaves became CSplit pairs of real arrays
    assert isinstance(st["a"], cio.CSplit)
    assert not np.iscomplexobj(st["a"].re)
    assert not isinstance(st["b"], cio.CSplit)
    back = cio.merge(st)
    np.testing.assert_allclose(back["a"], tree["a"])
    np.testing.assert_allclose(back["c"][0], tree["c"][0])


def test_complex_io_wrapper_matches_direct():
    a, b = _z((4, 4), 1), _z((4, 4), 2)

    def f(a, b):
        return a @ b.conj().T, jnp.abs(a).sum()

    out_d, s_d = f(jnp.asarray(a), jnp.asarray(b))
    g = cio.complex_io(f)
    out_w, s_w = g(a, b)
    np.testing.assert_allclose(np.asarray(out_w), np.asarray(out_d),
                               rtol=1e-6)
    np.testing.assert_allclose(float(s_w), float(s_d), rtol=1e-6)


def test_complex_io_under_jit_has_real_boundary():
    """The wrapped inner function's jit signature must contain no complex
    leaves — the property the wrapper exists to guarantee."""
    def f(z):
        return (z * z).sum()

    g = cio.complex_io(f)
    z = _z((8,))
    split_args = cio.split((z,))
    leaves = jax.tree_util.tree_leaves(split_args)
    assert all(not np.iscomplexobj(l) for l in leaves)
    inner = jax.jit(g.__wrapped_inner__)
    out = cio.merge(inner(*split_args))
    np.testing.assert_allclose(np.asarray(out), (z.astype(np.complex128)**2
                                                 ).sum(), rtol=1e-5)


@pytest.mark.parametrize("orth", ["ns", "ns+mgs"])
def test_subspace_topk_ns_policy(orth):
    """The GEMM-only orthonormalization policy recovers a well-separated
    dominant eigenspace to f32-appropriate accuracy."""
    from optimalcontrolmps.ops.matfree import subspace_topk
    rng = np.random.default_rng(3)
    m, k = 96, 16
    U = np.linalg.qr(rng.standard_normal((m, m))
                     + 1j * rng.standard_normal((m, m)))[0]
    w = np.concatenate([np.linspace(1.0, 0.3, k),
                        np.full(m - k, 1e-3)])
    rho = (U * w) @ U.conj().T
    V = np.asarray(subspace_topk(jnp.asarray(rho), k, iters=4, orth=orth))
    # orthonormal and spans the dominant eigenspace
    np.testing.assert_allclose(V.conj().T @ V, np.eye(k), atol=5e-5)
    P_true = U[:, :k] @ U[:, :k].conj().T
    resid = np.linalg.norm(V - P_true @ V)
    assert resid < 1e-3, resid
