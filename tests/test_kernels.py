"""Matern kernel unit tests against the reference's closed forms
(_kernels.pyx:76-93) and scipy-based general form."""

import numpy as np
import pytest
import scipy.special

from gppe_tpu.ops import assembly, kernels


def matern_scipy(x, nu):
    """Reference formula via scipy (same expression as _kernels.pyx:87-88)."""
    x = np.asarray(x, dtype=float)
    z = np.sqrt(2.0 * nu) * x
    with np.errstate(invalid="ignore", over="ignore"):
        k = (2.0 ** (1.0 - nu) / scipy.special.gamma(nu)) * (z ** nu) \
            * scipy.special.kv(nu, z)
    return np.where(x == 0, 1.0, k)


def test_matern_closed_forms():
    x = np.linspace(0.0, 5.0, 101)
    np.testing.assert_allclose(
        np.asarray(kernels.matern(x, 0.5)), np.exp(-x), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(kernels.matern(x, 1.5)),
        (1 + np.sqrt(3) * x) * np.exp(-np.sqrt(3) * x), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(kernels.matern(x, 2.5)),
        (1 + np.sqrt(5) * x + 5 / 3 * x ** 2) * np.exp(-np.sqrt(5) * x),
        rtol=1e-12)


@pytest.mark.parametrize("nu", [0.1, 0.5, 1.0, 3.2, 25.0])
def test_matern_general_vs_scipy(nu):
    x = np.logspace(-4, 1, 100)
    got = np.asarray(kernels.matern(x, float(nu) + 1e-9))  # force general branch
    want = matern_scipy(x, nu)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_matern_closed_forms_consistent_with_general():
    # The closed forms are special cases of the general Bessel branch.
    x = np.linspace(0.01, 3.0, 50)
    for nu in [0.5, 1.5, 2.5]:
        np.testing.assert_allclose(
            np.asarray(kernels.matern(x, nu)), matern_scipy(x, nu), rtol=1e-8)


def test_matern_gaussian_limit():
    # nu >= 100 -> exp(-x^2/2) (reference _kernels.pyx:90-93); also the
    # general branch at nu=99 should already be close.
    x = np.linspace(0.0, 2.0, 20)
    np.testing.assert_allclose(np.asarray(kernels.matern(x, 150.0)),
                               np.exp(-0.5 * x ** 2), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(kernels.matern(x, 99.0)),
                               np.exp(-0.5 * x ** 2), rtol=2e-2)


def test_matern_zero_distance_is_one():
    assert float(kernels.matern(0.0, 0.75)) == 1.0


def test_matern_traced_nu_matches_static():
    x = np.linspace(0.0, 4.0, 37)
    for nu in [0.5, 1.5, 2.5, 4.2, 150.0]:
        got_static = np.asarray(kernels.matern(x, nu))
        got_traced = np.asarray(kernels.matern(x, np.asarray(nu)))
        np.testing.assert_allclose(got_traced, got_static, rtol=1e-10)


def test_pairwise_distance_anisotropic():
    rng = np.random.default_rng(0)
    pts = rng.random((40, 3))
    scale = np.array([0.1, 0.2, 0.4])
    got = np.asarray(kernels.pairwise_scaled_distance(pts, pts, scale))
    diff = (pts[:, None, :] - pts[None, :, :]) / scale
    want = np.sqrt((diff ** 2).sum(-1))
    np.testing.assert_allclose(got, want, atol=1e-10)


def test_dense_correlation_symmetric_unit_diagonal():
    rng = np.random.default_rng(1)
    pts = rng.random((50, 2))
    K = np.asarray(assembly.dense_correlation(pts, 0.1, 0.5))
    np.testing.assert_allclose(K, K.T, atol=1e-12)
    np.testing.assert_allclose(np.diag(K), 1.0, atol=1e-12)
    assert K.min() >= 0.0 and K.max() <= 1.0


def test_dense_correlation_blocked_matches():
    rng = np.random.default_rng(2)
    pts = rng.random((130, 2))
    K1 = np.asarray(assembly.dense_correlation(pts, 0.15, 1.5))
    K2 = np.asarray(assembly.dense_correlation_blocked(pts, 0.15, 1.5,
                                                       block_size=32))
    np.testing.assert_allclose(K1, K2, atol=1e-12)


def test_generate_correlation_facade():
    rng = np.random.default_rng(3)
    pts = rng.random((30, 2))
    K = np.asarray(assembly.generate_correlation(pts, 0.2, nu=2.5))
    assert K.shape == (30, 30)
    np.testing.assert_allclose(np.diag(K), 1.0, atol=1e-12)


def test_multirho_frobenius_output():
    """The multirho kernel's products and the trace(K_b^2) the grid
    engines pair with it (the plain blocked reduction) vs dense numpy."""
    import jax
    import jax.numpy as jnp
    from gppe_tpu.ops import operators, pallas_kernels

    rng = np.random.RandomState(3)
    n = 300
    pts = rng.rand(n, 2)
    rhos = np.asarray([0.07, 0.15])
    V = rng.standard_normal((2, n, 3)).astype(np.float32)
    out = pallas_kernels.matern_matmat_multirho(pts, rhos, V, 0.5,
                                                interpret=True)
    tk2 = jax.lax.map(lambda rho: operators._matern_frobenius2_blocked(
        jnp.asarray(pts), jnp.full((2,), rho), 0.5, 128), jnp.asarray(rhos))
    for b, rho in enumerate(rhos):
        d = np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)) / rho
        K = np.exp(-d)
        np.testing.assert_allclose(float(tk2[b]), np.sum(K * K),
                                   rtol=1e-5)
        np.testing.assert_allclose(np.asarray(out[b]),
                                   K @ V[b].astype(np.float64),
                                   rtol=1e-4, atol=1e-4)
