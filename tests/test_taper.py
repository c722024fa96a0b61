"""Tapered-sparse path: threshold math, CSR parity, block-sparse operator
vs explicitly tapered dense truth."""

import numpy as np
import pytest

from gppe_tpu.ops import assembly, kernels, taper
from gppe_tpu.utils import data as data_utils


def test_gamma_function_matches_scipy():
    import scipy.special
    for d in range(1, 8):
        np.testing.assert_allclose(taper.gamma_function(d),
                                   scipy.special.gamma(d / 2 + 1),
                                   rtol=1e-12)


def test_ball_radius_volume_roundtrip():
    for d in [1, 2, 3]:
        r = taper.ball_radius(taper.ball_volume(0.7, d), d)
        np.testing.assert_allclose(r, 0.7, rtol=1e-12)


def test_adjacency_guard():
    with pytest.raises(ValueError):
        taper.estimate_kernel_threshold(100, 2, 1e-6, np.array([0.1, 0.1]),
                                        0.5)


def dense_tapered(pts, scale, nu, density):
    n, d = pts.shape
    scale_arr = np.repeat(np.atleast_1d(scale), d) if np.isscalar(scale) \
        else np.asarray(scale)
    tau = taper.estimate_kernel_threshold(n, d, density, scale_arr, nu)
    K = np.asarray(assembly.dense_correlation(pts, scale, nu))
    return np.where(K >= tau, K, 0.0), tau


def test_csr_matches_dense_taper():
    pts = data_utils.generate_points(20, dimension=2)  # n=400
    Kd, tau = dense_tapered(pts, 0.05, 0.5, 0.02)
    csr = taper.generate_tapered_correlation(pts, 0.05, 0.5, 0.02)
    np.testing.assert_allclose(csr.toarray(), Kd, atol=1e-12)
    # density is approximately the request (within geometry slack)
    got_density = csr.nnz / 400 ** 2
    assert 0.1 * 0.02 < got_density < 10 * 0.02


@pytest.mark.parametrize("nu,grid", [(0.5, True), (1.5, False),
                                     (0.77, False)])
def test_csr_fallback_matches_dense_taper(monkeypatch, nu, grid):
    """The KD-tree builder (no native library) keeps exactly k >= tau,
    including the many equal distances of a grid."""
    from gppe_tpu import native

    monkeypatch.setattr(native, "taper_csr", lambda *a, **k: None)
    pts = (data_utils.generate_points(20, dimension=2) if grid
           else np.random.default_rng(3).random((300, 2)))
    Kd, _ = dense_tapered(pts, 0.05, nu, 0.02)
    csr = taper.generate_tapered_correlation(pts, 0.05, nu, 0.02)
    np.testing.assert_allclose(csr.toarray(), Kd, atol=1e-12)


def test_block_sparse_operator_matches_tapered_dense():
    rng = np.random.default_rng(0)
    pts = rng.random((500, 2))
    density = 0.05
    Kd, tau = dense_tapered(pts, 0.05, 0.5, density)
    op = taper.TaperedMaternOperator(pts, 0.05, nu=0.5, density=density,
                                     tile=64, use_pallas=False)
    V = rng.standard_normal((500, 3))
    got = np.asarray(op.matmat(V))
    want = Kd @ V
    np.testing.assert_allclose(got, want, atol=1e-8)
    v = rng.standard_normal(500)
    np.testing.assert_allclose(np.asarray(op.matvec(v)), Kd @ v, atol=1e-8)


def test_block_sparse_skips_tiles():
    rng = np.random.default_rng(1)
    pts = rng.random((2000, 2))
    op = taper.TaperedMaternOperator(pts, 0.02, nu=0.5, density=0.01,
                                     tile=128, use_pallas=False)
    assert op.tile_density < 0.7  # pruning actually happens


def test_block_sparse_trace_pow(problem=None):
    rng = np.random.default_rng(2)
    pts = rng.random((400, 2))
    density = 0.05
    Kd, tau = dense_tapered(pts, 0.05, 0.5, density)
    op = taper.TaperedMaternOperator(pts, 0.05, nu=0.5, density=density,
                                     tile=64, use_pallas=False)
    np.testing.assert_allclose(float(op.trace_pow(2)), np.sum(Kd * Kd),
                               rtol=1e-8)


def test_generate_correlation_sparse_facade():
    pts = data_utils.generate_points(15, dimension=2)
    M = assembly.generate_correlation(pts, 0.1, nu=0.5, sparse=True,
                                      density=0.05)
    import scipy.sparse
    assert scipy.sparse.issparse(M)
    assert M.shape == (225, 225)


def test_blocksparse_pallas_interpret_matches():
    """Pallas blocksparse kernel (interpret mode, CSR row pointers) vs
    the plain XLA taper matvec: the kernel itself must execute, not just
    the use_pallas=False path."""
    import jax.numpy as jnp
    from gppe_tpu.ops import pallas_kernels, taper

    rng = np.random.RandomState(11)
    pts = rng.rand(600, 2)
    op = taper.TaperedMaternOperator(pts, 0.05, nu=0.5, density=0.02,
                                     tile=128, use_pallas=False)
    V = np.asarray(rng.standard_normal((600, 3)), np.float32)
    want = np.asarray(op.matmat(jnp.asarray(V)))

    Vs = V[op.perm]
    if op.n_pad > 600:
        Vs = np.concatenate(
            [Vs, np.zeros((op.n_pad - 600, 3), np.float32)], axis=0)
    out_sorted = np.asarray(pallas_kernels.matern_matmat_blocksparse(
        op.points_sorted, Vs, op.nu, op.threshold,
        op.rowptr, op.pair_j, op.tile, interpret=True))
    got = out_sorted[:600][op.inv_perm]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
