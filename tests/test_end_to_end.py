"""End-to-end flows through the public package surface.

These are the configurations the verify recipe drives on the GPU;
in CI they run on the virtual CPU mesh (conftest forces cpu + x64). The
known-optimum constants are cross-checked against the f64 CPU path and
the reference's semantics (same data seed 31, same model).
"""

import numpy as np
import pytest

import gppe_tpu
from gppe_tpu.utils import data as data_utils


@pytest.fixture(scope="module")
def problem_400():
    pts = data_utils.generate_points(20, dimension=2)   # n = 400 grid
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    K = gppe_tpu.generate_correlation(pts, 0.1, nu=0.5)
    return pts, z, X, K


def test_train_profiled_known_optimum(problem_400):
    _, z, X, K = problem_400
    res = gppe_tpu.GaussianProcess(X, K, likelihood_method="profiled").train(z)
    assert res["success"]
    assert res["eta"] == pytest.approx(16.2312, abs=0.05)
    assert res["sigma0"] == pytest.approx(0.20385, abs=5e-4)


def test_train_direct_agrees_with_profiled(problem_400):
    _, z, X, K = problem_400
    r_d = gppe_tpu.GaussianProcess(X, K, likelihood_method="direct").train(z)
    r_p = gppe_tpu.GaussianProcess(X, K, likelihood_method="profiled").train(z)
    assert r_d["eta"] == pytest.approx(r_p["eta"], rel=1e-3)
    assert r_d["sigma"] == pytest.approx(r_p["sigma"], rel=1e-3)


def test_invalid_inputs_rejected(problem_400):
    pts, z, X, K = problem_400
    with pytest.raises(ValueError):
        gppe_tpu.generate_correlation(pts, -0.1, nu=0.5)
    with pytest.raises(ValueError):
        gppe_tpu.GaussianProcess(X, K, likelihood_method="bogus")


def test_correlation_matrix_properties():
    pts = np.random.default_rng(0).random((300, 2))
    K = np.asarray(gppe_tpu.generate_correlation(pts, 0.1, nu=1.5))
    assert np.all(np.isfinite(K))
    np.testing.assert_allclose(K, K.T, atol=1e-12)
    np.testing.assert_allclose(np.diag(K), 1.0)
    # positive semi-definite (Matern is a valid correlation)
    w = np.linalg.eigvalsh(K)
    assert w.min() > -1e-8
