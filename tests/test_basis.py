"""ControlBasis tests ported from the reference's ControlBasisTests
(/root/reference/tests/ControlBasisTests.cpp), including the golden chopped-
sine vectors "calculated using old version of program"."""

import numpy as np
import jax.numpy as jnp

from optimalcontrolmps import control as controllib
from optimalcontrolmps import seeds


def simple_basis():
    """Constant basis with closed-form results
    (ControlBasisTests.cpp:10-32)."""
    N, M = 5, 4
    return controllib.ControlBasis(
        u0=jnp.ones(N), S=jnp.ones(N), f=jnp.full((N, M), 2.0))


def chopped_basis():
    """(ControlBasisTests.cpp:35-56): T=1, dt=0.1, u0 = 1..2, M=5."""
    u0 = np.array([1, 1.1, 1.2, 1.3, 1.4, 1.5, 1.6, 1.7, 1.8, 1.9, 2.0])
    return controllib.chopped_sine_basis(u0, 0.1, 1.0, 5)


def test_simple_convert_control():
    b = simple_basis()
    u1 = b.convert_control(jnp.zeros(4))
    np.testing.assert_allclose(np.asarray(u1), 1.0, atol=1e-8)
    u2 = b.convert_control(jnp.ones(4))
    np.testing.assert_allclose(np.asarray(u2), 1.0 + 2.0 * 4, atol=1e-8)


def test_simple_convert_gradient():
    b = simple_basis()
    g1 = b.convert_gradient(jnp.zeros(5))
    np.testing.assert_allclose(np.asarray(g1), 0.0, atol=1e-8)
    g2 = b.convert_gradient(jnp.ones(5))
    np.testing.assert_allclose(np.asarray(g2), 2.0 * 5, atol=1e-8)


def test_simple_jacobian():
    b = simple_basis()
    jac = np.asarray(b.jacobian())
    assert jac.shape == (5, 4)
    np.testing.assert_allclose(jac, 2.0, atol=1e-8)


def test_chopped_convert_control():
    """Golden values at ControlBasisTests.cpp:195-214."""
    b = chopped_basis()
    u1 = b.convert_control(jnp.zeros(5))
    np.testing.assert_allclose(np.asarray(u1),
                               1.0 + np.arange(11) * 0.1, atol=1e-6)
    u2 = b.convert_control(jnp.ones(5))
    res2 = [1, 4.75688, 4.27768, 1.78131, 1.4, 2.5, 2.32654, 1.45476, 1.8,
            2.47919, 2]
    np.testing.assert_allclose(np.asarray(u2), res2, atol=5e-6)


def test_chopped_convert_gradient():
    """Golden values at ControlBasisTests.cpp:230-240."""
    b = chopped_basis()
    g1 = b.convert_gradient(jnp.zeros(11))
    np.testing.assert_allclose(np.asarray(g1), 0.0, atol=5e-6)
    g2 = b.convert_gradient(jnp.ones(11))
    res2 = [6.31375, 3.58979e-09, 1.96261, 7.17958e-09, 1]
    np.testing.assert_allclose(np.asarray(g2), res2, atol=5e-6)


def test_chopped_jacobian():
    """Golden matrix at ControlBasisTests.cpp:248-262."""
    b = chopped_basis()
    jac = np.asarray(b.jacobian())
    want = np.array([
        [0, 0, 0, 0, 0],
        [0.309017, 0.587785, 0.809017, 0.951057, 1],
        [0.587785, 0.951057, 0.951057, 0.587785, 3.58979e-09],
        [0.809017, 0.951057, 0.309017, -0.587785, -1],
        [0.951057, 0.587785, -0.587785, -0.951057, -7.17959e-09],
        [1, 3.58979e-09, -1, -7.17959e-09, 1],
        [0.951057, -0.587785, -0.587785, 0.951057, 1.07694e-08],
        [0.809017, -0.951057, 0.309017, 0.587785, -1],
        [0.587785, -0.951057, 0.951057, -0.587785, -1.43592e-08],
        [0.309017, -0.587785, 0.809017, -0.951057, 1],
        [0, -0, 0, -0, 0],
    ])
    np.testing.assert_allclose(jac, want, atol=5e-6)


def test_chopped_convert_hessian():
    """Golden matrices at ControlBasisTests.cpp:280-345."""
    b = chopped_basis()
    H0 = b.convert_hessian(jnp.zeros((11, 11)))
    np.testing.assert_allclose(np.asarray(H0), 0.0, atol=1e-10)

    H1 = b.convert_hessian(jnp.ones((11, 11)))
    want1 = np.array([
        [39.8635, 0, 12.3914, 0, 6.3138],
        [0, 0, 0, 0, 0],
        [12.3914, 0, 3.8518, 0, 1.9626],
        [0, 0, 0, 0, 0],
        [6.3138, 0, 1.9626, 0, 1.0000],
    ])
    np.testing.assert_allclose(np.asarray(H1), want1, atol=1e-4)

    Hu = np.ones((11, 11))
    idx = 0.0
    for i in range(11):
        for j in range(i, 11):
            Hu[i, j] = idx
            Hu[j, i] = idx
            idx += 0.01
    H3 = b.convert_hessian(jnp.asarray(Hu))
    want3 = np.array([
        [14.8420, -3.5725, 3.3413, -1.8170, 1.6800],
        [-3.5725, 1.6547, -0.8321, 0.4766, -0.4938],
        [3.3413, -0.8321, 1.1382, -0.3595, 0.4339],
        [-1.8170, 0.4766, -0.3595, 0.3759, -0.1662],
        [1.6800, -0.4938, 0.4339, -0.1662, 0.3300],
    ])
    np.testing.assert_allclose(np.asarray(H3), want3, atol=1e-4)


def test_seed_generators():
    """Behavioral checks of SeedGenerator (SeedGenerator.hpp:66-125)."""
    x = seeds.linspace(0.0, 100.0, 11)
    assert x.shape == (11,)
    np.testing.assert_allclose(x[-1], 100.0, atol=1e-9)

    r = seeds.generate_range(0.0, 0.5, 2.0)
    np.testing.assert_allclose(r, [0, 0.5, 1.0, 1.5, 2.0], atol=1e-9)

    s = seeds.linsigmoid_seed(2.5, 50.0, 201, rng=np.random.default_rng(0))
    assert s.shape == (201,)
    # endpoints: the background sigmoid tails leave ~0.016 offset (the
    # reference behaves identically, SeedGenerator.hpp:88-92)
    assert abs(s[0] - 2.5) < 0.05 and abs(s[-1] - 50.0) < 0.05
    assert s.min() > 0.0 and s.max() < 60.0

    ad = seeds.adiabatic_seed(2.5, 50.0, 201)
    assert abs(ad[0] - 2.5) < 0.1
    assert abs(ad[-1] - 50.0) < 1e-6

    import jax
    batch = seeds.linsigmoid_seed_batch(jax.random.PRNGKey(0), 2.5, 50.0,
                                        201, 16)
    assert batch.shape == (16, 201)
    b = np.asarray(batch)
    np.testing.assert_allclose(b[:, 0], 2.5, atol=0.05)
    np.testing.assert_allclose(b[:, -1], 50.0, atol=0.05)
