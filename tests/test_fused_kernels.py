"""The fused GPU kernels (Pallas, Triton route) in interpret mode against
plain f64 references, the kernel-choice rule, and the dtype and
compile-cache policies that decide how the GPU path runs."""

import numpy as np
import pytest

from gppe_tpu.ops import assembly, kernels, pallas_kernels, taper

NUS = [0.5, 1.5, 2.5, np.inf]


def _matern_f64(rows, cols, scale, nu):
    d = np.sqrt((((rows[:, None, :] - cols[None, :, :]) / scale) ** 2)
                .sum(-1))
    return np.asarray(kernels.matern(d, 150.0 if np.isinf(nu) else nu))


def _nu(nu):
    return 1e9 if np.isinf(nu) else nu


@pytest.mark.parametrize("nu", NUS)
def test_matern_matmat_interpret(nu):
    """Square K @ V, n = 200 (not a multiple of the 64-point tile)."""
    rng = np.random.RandomState(0)
    pts = rng.rand(200, 2)
    V = rng.standard_normal((200, 5))
    got = np.asarray(pallas_kernels.matern_matmat(pts, 0.1, V, _nu(nu),
                                                  interpret=True))
    want = _matern_f64(pts, pts, 0.1, nu) @ V
    assert got.shape == (200, 5)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-6


@pytest.mark.parametrize("nu", NUS)
def test_matern_matmat_rectangular_interpret(nu):
    """The points_cols form (the sharded local matvec) with an
    anisotropic scale and row/column counts that differ."""
    rng = np.random.RandomState(1)
    rows = rng.rand(150, 2)
    cols = rng.rand(90, 2)
    scale = np.array([0.1, 0.2])
    V = rng.standard_normal((90, 3))
    got = np.asarray(pallas_kernels.matern_matmat(
        rows, scale, V, _nu(nu), points_cols=cols, interpret=True))
    want = _matern_f64(rows, cols, scale, nu) @ V
    assert got.shape == (150, 3)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-6


@pytest.mark.parametrize("nu", NUS)
def test_multirho_interpret(nu):
    """Batched scales, n = 130 (not a multiple of the tile)."""
    rng = np.random.RandomState(2)
    pts = rng.rand(130, 2)
    rhos = np.array([0.06, 0.2])
    V = rng.standard_normal((2, 130, 9))
    out = pallas_kernels.matern_matmat_multirho(pts, rhos, V, _nu(nu),
                                                interpret=True)
    assert out.shape == (2, 130, 9)
    for b, rho in enumerate(rhos):
        want = _matern_f64(pts, pts, rho, nu) @ V[b]
        got = np.asarray(out[b])
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-6


@pytest.mark.parametrize("nu", NUS)
def test_blocksparse_interpret(nu):
    """Tapered block-sparse kernel vs the explicitly tapered f64 dense
    product, n = 300 (padded to the 128-point tile)."""
    rng = np.random.RandomState(3)
    pts = rng.random((300, 2))
    op = taper.TaperedMaternOperator(pts, 0.05, nu=_nu(nu), density=0.05,
                                     tile=128, use_pallas=True)
    V = rng.standard_normal((300, 4))
    K = np.asarray(assembly.dense_correlation(pts, 0.05, _nu(nu)))
    want = np.where(K >= op.threshold, K, 0.0) @ V
    Vs = np.zeros((op.n_pad, 4))
    Vs[:300] = V[op.perm]
    got = np.asarray(pallas_kernels.matern_matmat_blocksparse(
        op.points_sorted, Vs, op.nu, op.threshold, op.rowptr, op.pair_j,
        op.tile, interpret=True))[:300][op.inv_perm]
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-6


def test_taper_plain_path_chunks_match():
    """The plain batched taper path gives the same product for any
    pair-chunk size (padding pairs carry zero weight)."""
    import jax.numpy as jnp

    rng = np.random.RandomState(4)
    op = taper.TaperedMaternOperator(rng.random((400, 2)), 0.05, nu=0.5,
                                     density=0.05, tile=64, use_pallas=False)
    Vs = jnp.asarray(rng.standard_normal((op.n_pad, 2)))
    outs = [np.asarray(taper._blocksparse_matmat_xla(
        op.points_sorted, Vs, jnp.asarray(op.pair_i), jnp.asarray(op.pair_j),
        op.nu, op.threshold, op.tile, c)) for c in (1, 7, 64)]
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-12)
    np.testing.assert_allclose(outs[0], outs[2], atol=1e-12)


def test_taper_rowptr_is_csr_of_pairs():
    rng = np.random.RandomState(5)
    op = taper.TaperedMaternOperator(rng.random((700, 2)), 0.05, nu=0.5,
                                     density=0.02, tile=64, use_pallas=False)
    assert op.rowptr[0] == 0 and op.rowptr[-1] == len(op.pair_j)
    for i in range(op.num_tiles):
        seg = op.pair_i[op.rowptr[i]:op.rowptr[i + 1]]
        assert np.all(seg == i)


@pytest.mark.parametrize("r,want", [(1, 16), (9, 16), (16, 16), (23, 32),
                                    (33, 64)])
def test_pad_width(r, want):
    """r pads to a power of two >= 16 (the tile product's minimum)."""
    assert pallas_kernels._pad_width(r) == want


@pytest.mark.parametrize("platform,nu,want", [
    ("gpu", 0.5, True), ("gpu", 1.5, True), ("gpu", 2.5, True),
    ("gpu", 150.0, True), ("gpu", 2.2, False), ("cpu", 0.5, False),
    ("cpu", 2.2, False), ("gpu", None, False)])
def test_use_fused_kernel(platform, nu, want):
    assert pallas_kernels.use_fused_kernel(nu, platform) is want


def test_use_fused_kernel_default_backend_is_cpu_here():
    """Without a GPU the plain XLA path is taken by default."""
    from gppe_tpu.ops import operators
    assert not pallas_kernels.use_fused_kernel(0.5)
    assert not operators.MaternOperator(np.zeros((4, 2)), 0.1).use_pallas


def test_unsupported_nu_raises():
    with pytest.raises(ValueError, match="general nu"):
        pallas_kernels.matern_matmat(np.zeros((4, 2)), 0.1, np.ones((4, 1)),
                                     2.2, interpret=True)


@pytest.mark.parametrize("platform,want", [("gpu", "float32"),
                                           ("cpu", "float64")])
def test_compute_dtype_per_platform(monkeypatch, platform, want):
    """f32 device math on the GPU; the x64 policy (f64 here) on the CPU."""
    import jax
    import jax.numpy as jnp
    from gppe_tpu.utils.config import compute_dtype
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert jnp.dtype(compute_dtype()) == jnp.dtype(want)


def test_compile_cache_dir_from_env(monkeypatch, tmp_path):
    from gppe_tpu.utils import config
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_default_in_checkout(monkeypatch):
    import os

    from gppe_tpu.utils import config
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert config.compile_cache_dir() == os.path.join(root, ".jax_cache")


def test_setup_uses_env_cache_dir(monkeypatch, tmp_path):
    """setup() points JAX at $JAX_COMPILATION_CACHE_DIR and pins f32
    products to full precision; the test restores the session config."""
    import jax

    from gppe_tpu.utils import config
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_default_matmul_precision)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        config.setup()
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        assert jax.config.jax_default_matmul_precision == "highest"
    finally:
        jax.config.update("jax_compilation_cache_dir", saved[0])
        jax.config.update("jax_default_matmul_precision", saved[1])
