"""Production-path checks on one GPU: compiled Pallas (Triton) kernels,
f32 device math, f64 inference scalars. Small n throughout — the cost
here is compile time, not compute; shapes are shared where possible."""

import numpy as np
import pytest


@pytest.fixture(scope="module")
def problem_1k():
    from gppe_tpu.utils import data as data_utils
    rng = np.random.RandomState(0)
    pts = rng.rand(1024, 2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    return pts, z, X


def test_pallas_matvec_matches_host_f64(problem_1k):
    """Compiled fused Matern matvec vs host-f64 dense K @ V — the
    compiler/precision tier CPU interpret-mode tests cannot cover (a TF32
    tile product would miss the 2e-5 bound by ~50x)."""
    import jax.numpy as jnp
    from gppe_tpu.ops import kernels, pallas_kernels

    pts, z, X = problem_1k
    rng = np.random.RandomState(1)
    V = np.asarray(rng.standard_normal((1024, 7)), np.float32)

    got = np.asarray(pallas_kernels.matern_matmat(pts, 0.1, V, 0.5))

    d = np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)) / 0.1
    K = np.exp(-d)
    want = K @ V.astype(np.float64)
    # f32 distance rounding puts ~|d| * eps_f32 ~ 4e-6 absolute error on
    # each kernel entry; judge the matvec by norm, not tiny entries
    frob = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert frob < 2e-5, frob
    assert np.max(np.abs(got - want)) < 5e-4


def test_fused_matvec_symmetry(problem_1k):
    """u.(K v) vs v.(K u): the full-f32 tile product is linear in v, so
    the pairing is symmetric to f32 roundoff."""
    from gppe_tpu.ops import pallas_kernels

    pts, _, _ = problem_1k
    rng = np.random.RandomState(2)
    u = np.asarray(rng.standard_normal((1024, 1)), np.float32)
    v = np.asarray(rng.standard_normal((1024, 1)), np.float32)
    Kv = np.asarray(pallas_kernels.matern_matmat(pts, 0.1, v, 0.5))
    Ku = np.asarray(pallas_kernels.matern_matmat(pts, 0.1, u, 0.5))
    a = float(u[:, 0] @ Kv[:, 0])
    b = float(v[:, 0] @ Ku[:, 0])
    assert abs(a - b) / max(abs(a), 1.0) < 1e-5, (a, b)


def test_blocksparse_compiled_matches_plain(problem_1k):
    """Compiled tapered kernel vs the plain chunked XLA taper path."""
    from gppe_tpu.ops import taper

    rng = np.random.RandomState(6)
    pts = rng.rand(4096, 2)
    V = np.asarray(rng.standard_normal((4096, 7)), np.float32)
    kw = dict(nu=0.5, density=0.01, tile=256)
    got = np.asarray(taper.TaperedMaternOperator(
        pts, 0.02, use_pallas=True, **kw).matmat(V))
    want = np.asarray(taper.TaperedMaternOperator(
        pts, 0.02, use_pallas=False, **kw).matmat(V))
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-5


def test_gpu_dtype_policy():
    """f32 device math, f64 scalars, f32 products pinned to full f32."""
    import jax
    import jax.numpy as jnp
    from gppe_tpu.utils.config import compute_dtype, inference_dtype

    assert compute_dtype() == jnp.float32
    assert inference_dtype() == jnp.float64
    assert jax.config.jax_default_matmul_precision == "highest"


def test_krylov_profile_fit_n1024(problem_1k):
    """End-to-end profile MLE on the chip vs the host-f64 spectral
    answer — the f32-device + f64-scalar policy must land on the same
    optimum (the r2/r3 precision regressions were exactly here)."""
    import jax.numpy as jnp
    from gppe_tpu.models import direct_likelihood as dl
    from gppe_tpu.models import profile_likelihood as pl_mod
    from gppe_tpu.models.large_scale import KrylovProfileLikelihood
    from gppe_tpu.models.mixed_correlation import MixedCorrelation
    from gppe_tpu.ops import operators

    pts, z, X = problem_1k
    op = operators.MaternOperator(pts, 0.1, nu=0.5)
    eng = KrylovProfileLikelihood(op, X, z, lanczos_steps=32,
                                  num_probes=16)
    got = eng.fit()

    d = np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)) / 0.1
    K = np.exp(-d)
    data = dl.make_spectral_data(MixedCorrelation(jnp.asarray(K)), X, z)
    want = pl_mod.find_log_likelihood_der1_zeros(data, [1e-4, 1e3])
    assert got["success"]
    np.testing.assert_allclose(got["eta"], want["eta"], rtol=5e-2)
    np.testing.assert_allclose(got["sigma0"], want["sigma0"], rtol=5e-3)


def test_grid_krylov_multirho_chunk(problem_1k):
    """One matrix-free multi-rho Pallas chunk (compiled): per-point fits
    must agree with fresh single-operator engines at the same rhos."""
    from gppe_tpu.models.grid_krylov import GridKrylovProfileLikelihood
    from gppe_tpu.models.large_scale import KrylovProfileLikelihood
    from gppe_tpu.ops import operators

    pts, z, X = problem_1k
    rhos = np.asarray([0.08, 0.1, 0.15])
    nus = np.full(3, 0.5)
    g = GridKrylovProfileLikelihood(pts, X, z, rhos, nus, nu_static=0.5,
                                    lanczos_steps=32, num_probes=8,
                                    matrix_free=True, chunk=3)
    results = g.fit_all()
    assert len(results) == 3
    for r, rho in zip(results, rhos):
        op = operators.MaternOperator(pts, float(rho), nu=0.5)
        ref = KrylovProfileLikelihood(op, X, z, lanczos_steps=32,
                                      num_probes=16).fit()
        if np.isfinite(ref["eta"]) and ref["eta"] > 0:
            np.testing.assert_allclose(r["eta"], ref["eta"], rtol=0.1)
        np.testing.assert_allclose(r["sigma0"], ref["sigma0"], rtol=1e-2)


def test_traced_nu_matern_f32_finite():
    """The f32 traced-nu (Bessel) path across the sampler's nu range —
    overflow/underflow here NaN'd silently before the log-space kv."""
    import jax.numpy as jnp
    from gppe_tpu.ops import kernels

    x = jnp.asarray(np.geomspace(1e-5, 20, 256), jnp.float32)
    for nu in [3.5, 10.0, 24.9]:
        k = np.asarray(kernels.matern(x, jnp.asarray(nu, jnp.float32)))
        assert np.all(np.isfinite(k)), nu
        assert np.all((k >= 0) & (k <= 1.0)), nu


def test_sharded_step_1chip_pallas(problem_1k):
    """The sharded profile step on a 1-device GPU mesh with the fused
    local matvec: trace values against host-f64 eigenvalues."""
    import jax
    import jax.numpy as jnp
    from gppe_tpu.parallel import mesh as mesh_mod
    from gppe_tpu.parallel import sharded

    pts, z, X = problem_1k
    n = pts.shape[0]
    mesh = mesh_mod.make_mesh(1)
    assert sharded.default_use_pallas(0.5, mesh)
    step = sharded.build_sharded_profile_step(mesh, nu=0.5,
                                              lanczos_steps=30)
    rng = np.random.default_rng(0)
    probes = rng.choice([-1.0, 1.0], size=(n, 16))
    etas = jnp.asarray([0.3, 3.0, 30.0], jnp.float32)
    out = step(jnp.asarray(pts, jnp.float32),
               jnp.asarray([0.1, 0.1], jnp.float32),
               jnp.asarray(X, jnp.float32), jnp.asarray(z, jnp.float32),
               jnp.asarray(probes, jnp.float32), etas)
    jax.block_until_ready(out)
    der1, ti, ld = (np.asarray(o) for o in out)

    d = np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)) / 0.1
    lam = np.linalg.eigvalsh(np.exp(-d))
    for i, eta in enumerate([0.3, 3.0, 30.0]):
        want_ti = (1.0 / (lam + eta)).sum()
        want_ld = np.log(lam + eta).sum()
        assert abs(ti[i] - want_ti) / want_ti < 0.1, (eta, ti[i], want_ti)
        assert abs(ld[i] - want_ld) / n < 0.05, (eta, ld[i], want_ld)


def test_fft_grid_operator_f32(problem_1k):
    """GridMaternOperator (circulant-embedding FFT matvec) on the chip:
    f32 FFT vs host-f64 dense at a general (Bessel) nu, and the full
    profile fit vs the host-f64 spectral answer. Also exercises the
    jit_operands pass-through of the FFT tables."""
    import jax.numpy as jnp
    from gppe_tpu.models import direct_likelihood as dl
    from gppe_tpu.models import profile_likelihood as pl_mod
    from gppe_tpu.models.large_scale import KrylovProfileLikelihood
    from gppe_tpu.models.mixed_correlation import MixedCorrelation
    from gppe_tpu.ops import operators
    from gppe_tpu.utils import data as data_utils

    pts = data_utils.generate_points(32, dimension=2)    # n=1024 grid
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    nu = 2.2
    op = operators.GridMaternOperator(pts, 0.1, nu=nu)

    rng = np.random.RandomState(4)
    V = np.asarray(rng.standard_normal((1024, 5)), np.float32)
    got = np.asarray(op.matmat(V))
    ri = np.rint(pts[:, 0] * 31).astype(int)
    ci = np.rint(pts[:, 1] * 31).astype(int)
    K = op._k_tab[np.abs(ri[:, None] - ri[None, :]),
                  np.abs(ci[:, None] - ci[None, :])]
    want = K @ V.astype(np.float64)
    frob = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert frob < 2e-5, frob

    eng = KrylovProfileLikelihood(op, X, z, lanczos_steps=48,
                                  num_probes=16)
    got_fit = eng.fit()
    data = dl.make_spectral_data(
        MixedCorrelation(jnp.asarray(K, jnp.float64)), X, z)
    want_fit = pl_mod.find_log_likelihood_der1_zeros(data, [1e-4, 1e3])
    np.testing.assert_allclose(got_fit["eta"], want_fit["eta"], rtol=0.1)
    np.testing.assert_allclose(got_fit["sigma0"], want_fit["sigma0"],
                               rtol=1e-2)


def test_fft_grid_fit_n2e20_smoke():
    """The exact large-n path in the production dtype on the card: the
    2^20 FFT-grid Krylov fit. Lean settings (k = 32, 8 probes): a
    does-the-hot-path-run check, not a benchmark. The root must be
    interior (an edge of the [1e-4, 1e3] bracket is the spurious
    boundary optimum) and sigma0 near the injected 0.2."""
    import time

    from gppe_tpu.models.large_scale import KrylovProfileLikelihood
    from gppe_tpu.ops import operators
    from gppe_tpu.utils import data as data_utils

    pts = data_utils.generate_points(1024, dimension=2)   # n = 2^20
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    t0 = time.perf_counter()
    op = operators.GridMaternOperator(pts, 0.005, nu=0.5)
    eng = KrylovProfileLikelihood(op, X, z, lanczos_steps=32,
                                  num_probes=8)
    res = eng.fit()
    total = time.perf_counter() - t0
    assert res["success"]
    assert np.isfinite(res["eta"]) and 1.0 < res["eta"] < 1e3, res
    assert abs(res["sigma0"] / 0.2 - 1.0) < 0.05, res
    # sanity ceiling: a cold compile and fit take well under a minute
    assert total < 600, total


def test_chunked_hmc_on_rho_nu_surface():
    """Chunked-HMC steps on the tensor-node (rho, nu) FFT posterior
    surface: short device programs with the adaptation state carried
    across, f32 surface build on the card."""
    import jax
    from gppe_tpu.models import hmc
    from gppe_tpu.models.krylov_posterior import KrylovPosteriorSurfaceRhoNu
    from gppe_tpu.utils import data as data_utils

    pts = data_utils.generate_points(32, dimension=2)     # n = 1024 grid
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    surface = KrylovPosteriorSurfaceRhoNu(
        pts, z, X, log10_rho_bounds=(-1.2, -0.6), nu_bounds=(1.0, 25.0),
        num_rho_nodes=5, num_nu_nodes=6, lanczos_steps=24, num_probes=8,
        key=3)
    log_post, u_to_theta = surface.make_bounded_log_posterior(
        log10_eta_bounds=(-2.0, 3.0))
    init = 0.3 * jax.random.normal(jax.random.PRNGKey(0), (4, 3))
    res = hmc.hmc_sample(log_post, init, jax.random.PRNGKey(1),
                         num_samples=12, num_warmup=12, num_leapfrog=6,
                         chunk_steps=8)
    s = np.asarray(jax.vmap(jax.vmap(u_to_theta))(res.samples))
    assert s.shape == (12, 4, 3)
    assert np.all(np.isfinite(s))
    assert np.all((s[..., 2] >= 1.0) & (s[..., 2] <= 25.0))
    assert float(np.mean(np.asarray(res.accept_rate))) > 0.2
