"""Grid-batched Krylov profile likelihood vs exact per-point optima
(VERDICT r1 item 2: one vmapped Lanczos pass factorizes a (rho, nu) chunk;
the reference runs a fresh O(n^3) precompute per grid point,
examples/FindOptimalCovarianceParameters.py:632-702)."""

import numpy as np
import pytest

import jax.numpy as jnp

from gppe_tpu.models import direct_likelihood as dl
from gppe_tpu.models import profile_likelihood as pl_mod
from gppe_tpu.models.grid_krylov import GridKrylovProfileLikelihood
from gppe_tpu.models.mixed_correlation import MixedCorrelation
from gppe_tpu.ops import assembly
from gppe_tpu.utils import data as data_utils


@pytest.fixture(scope="module")
def grid_fit():
    pts = data_utils.generate_points(20, dimension=2)   # n = 400
    z = data_utils.generate_data(pts, 0.05)
    X = data_utils.generate_basis_functions(pts, 2)
    rhos = np.array([0.1, 0.15, 0.2])
    nus = np.array([1.0, 2.0, 5.0])
    R, N = np.meshgrid(rhos, nus, indexing="ij")
    grid = GridKrylovProfileLikelihood(pts, X, z, R.ravel(), N.ravel(),
                                       lanczos_steps=50, num_probes=32)
    return pts, z, X, grid.fit_all()


def test_grid_matches_exact_per_point(grid_fit):
    pts, z, X, results = grid_fit
    assert len(results) == 9
    for r in [results[0], results[4], results[8]]:
        K = np.asarray(assembly.dense_correlation(pts, r["rho"], r["nu"]))
        data = dl.make_spectral_data(MixedCorrelation(jnp.asarray(K)), X, z)
        exact = pl_mod.find_log_likelihood_der1_zeros(data, [1e-4, 1e3])
        assert r["success"]
        assert r["eta"] == pytest.approx(exact["eta"], rel=5e-2)
        assert r["sigma0"] == pytest.approx(exact["sigma0"], rel=5e-3)


def test_grid_lp_surface_ranks_like_exact(grid_fit):
    """The profile-lp surface must rank grid points like the exact one
    (the argmax drives the MAP search)."""
    pts, z, X, results = grid_fit
    lps = []
    for r in results:
        K = np.asarray(assembly.dense_correlation(pts, r["rho"], r["nu"]))
        data = dl.make_spectral_data(MixedCorrelation(jnp.asarray(K)), X, z)
        eta = r["eta"]
        sigma = float(pl_mod.find_optimal_sigma(data, eta))
        lps.append(float(pl_mod.log_likelihood(data, sigma, eta)))
    got = np.array([r["lp"] for r in results])
    assert np.argmax(got) == np.argmax(lps)
    # golden-grade surface values: the one-pass deflated + CV-regressed
    # SLQ logdet (ops.stochastic.deflated_quadrature) resolves the
    # surface to a tenth of a nat (VERDICT r2 item 5; was atol=1.5 with
    # the plain 32-probe quadrature)
    np.testing.assert_allclose(got, lps, atol=0.1)


def test_grid_chunking_consistent():
    """Chunked execution (chunk=2) gives the same answers as one chunk.

    Not bitwise: the flattened batched Lanczos sums in a B-dependent
    order, and once a chain has captured the numerically representable
    spectrum of a smooth kernel (nu = 2.5 at n = 100 by step ~15), its
    tail amplifies roundoff-level input differences chaotically — both
    tails are equally valid k-step factorizations and the eta they
    produce agrees to ~1e-4. rel=1e-3 still catches any real bug in the
    chunk flattening (a wrong b-major mapping is O(1) off)."""
    pts = data_utils.generate_points(10, dimension=2)   # n = 100
    z = data_utils.generate_data(pts, 0.1)
    X = data_utils.generate_basis_functions(pts, 1)
    rhos = np.array([0.1, 0.2, 0.1, 0.2, 0.15])
    nus = np.array([0.5, 0.5, 1.5, 1.5, 2.5])
    g1 = GridKrylovProfileLikelihood(pts, X, z, rhos, nus,
                                     lanczos_steps=30, num_probes=8)
    g2 = GridKrylovProfileLikelihood(pts, X, z, rhos, nus,
                                     lanczos_steps=30, num_probes=8,
                                     chunk=2)
    r1 = g1.fit_all()
    r2 = g2.fit_all()
    for a, b in zip(r1, r2):
        assert a["eta"] == pytest.approx(b["eta"], rel=1e-3)


def test_matrix_free_matches_dense():
    """The matrix-free factorization (general traced-(rho, nu) blocked
    matvec — the path that lets the grid reach n = 10^5+, VERDICT r2
    item 3) is numerically identical to the dense chunk: same Lanczos,
    different matvec engine."""
    pts = data_utils.generate_points(20, dimension=2)   # n = 400
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    rhos = np.array([0.08, 0.15, 0.25, 0.15])
    nus = np.array([0.5, 0.5, 0.5, 2.0])
    gd = GridKrylovProfileLikelihood(pts, X, z, rhos, nus,
                                     lanczos_steps=40, num_probes=8,
                                     matrix_free=False)
    gm = GridKrylovProfileLikelihood(pts, X, z, rhos, nus,
                                     lanczos_steps=40, num_probes=8,
                                     matrix_free=True, block_rows=128)
    for a, b in zip(gd.fit_all(), gm.fit_all()):
        assert a["lp"] == pytest.approx(b["lp"], abs=1e-6)
        assert np.log10(a["eta"]) == pytest.approx(np.log10(b["eta"]),
                                                   abs=1e-6)


def test_multirho_pallas_interpret_matches():
    """The multi-rho fused kernel (shared-distance tile, one exp + one
    tile product per rho) in Pallas interpret mode vs per-rho dense
    matmuls; n = 96 is not a multiple of the kernel tile."""
    import jax.numpy as jnp
    from gppe_tpu.ops import kernels, pallas_kernels

    rng = np.random.RandomState(5)
    pts = np.asarray(rng.rand(96, 2), np.float32)
    rhos = np.array([0.05, 0.12, 0.3], np.float32)
    V = np.asarray(rng.standard_normal((3, 96, 4)), np.float32)
    out = np.asarray(pallas_kernels.matern_matmat_multirho(
        pts, rhos, V, 0.5, interpret=True))
    for b, rho in enumerate(rhos):
        dist = kernels.pairwise_scaled_distance(
            jnp.asarray(pts, dtype=jnp.float32),
            jnp.asarray(pts, dtype=jnp.float32), float(rho))
        K = np.asarray(kernels.matern(dist, 0.5))
        ref = K @ V[b]
        np.testing.assert_allclose(out[b], ref, rtol=2e-5, atol=2e-5)
