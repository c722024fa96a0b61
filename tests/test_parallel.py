"""Multi-device tests on the virtual 8-device CPU mesh
(the multi-GPU substitute, SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gppe_tpu.models import direct_likelihood as dl
from gppe_tpu.models import profile_likelihood as pl_mod
from gppe_tpu.models.mixed_correlation import MixedCorrelation
from gppe_tpu.ops import assembly
from gppe_tpu.parallel import mesh as mesh_mod
from gppe_tpu.parallel import sharded
from gppe_tpu.utils import data as data_utils


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return mesh_mod.make_mesh(8)


def test_make_mesh_axes(mesh8):
    assert mesh8.axis_names == ("probe", "block")
    assert np.prod(list(mesh8.shape.values())) == 8


def test_sharded_profile_step_matches_exact(mesh8):
    pts = data_utils.generate_points(16, dimension=2)  # n=256
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    n = pts.shape[0]

    K = np.asarray(assembly.dense_correlation(pts, 0.1, 0.5))
    Km = MixedCorrelation(K)
    data = dl.make_spectral_data(Km, X, z)

    step = sharded.build_sharded_profile_step(mesh8, nu=0.5,
                                              lanczos_steps=40)
    rng = np.random.default_rng(0)
    p_per = int(mesh8.shape["probe"])
    probes = rng.choice([-1.0, 1.0], size=(n, 16 * p_per))
    etas = jnp.asarray([0.3, 3.0, 30.0])

    der1, traceinv, logdet = step(
        jnp.asarray(pts), jnp.asarray([0.1, 0.1]), jnp.asarray(X),
        jnp.asarray(z), jnp.asarray(probes), etas)

    lam = np.linalg.eigvalsh(K)
    for i, eta in enumerate([0.3, 3.0, 30.0]):
        want_ti = (1.0 / (lam + eta)).sum()
        want_ld = np.log(lam + eta).sum()
        # MC-limited accuracy for traces (no CV in the all-jit path);
        # absolute error scales with n
        assert abs(float(traceinv[i]) - want_ti) / want_ti < 0.1
        assert abs(float(logdet[i]) - want_ld) / n < 0.05
        want_d1 = float(pl_mod.log_likelihood_der1_eta(
            data, jnp.log10(jnp.asarray(eta))))
        # der1's solve part is Krylov-exact; trace part MC-limited
        assert abs(float(der1[i]) - want_d1) / n < 0.05, (eta, der1[i], want_d1)


def test_ring_matvec_matches_dense(mesh8):
    """ring_matern_matmat == K @ V with V kept sharded the whole time."""
    from jax.sharding import PartitionSpec as P

    n = 8 * 16
    rng = np.random.default_rng(3)
    pts = rng.random((n, 2))
    V = rng.standard_normal((n, 5))
    K = np.asarray(assembly.dense_correlation(pts, 0.2, 1.5))
    want = K @ V

    n_blocks = int(mesh8.shape["block"])

    def body(pts_l, pts_f, scale, V_l):
        return sharded.ring_matern_matmat(pts_l, pts_f, scale, V_l, 1.5,
                                          "block", n_blocks)

    got = jax.shard_map(
        body, mesh=mesh8,
        in_specs=(P("block"), P(), P(), P("block")),
        out_specs=P("block"), check_vma=False,
    )(jnp.asarray(pts), jnp.asarray(pts), jnp.asarray([0.2, 0.2]),
      jnp.asarray(V))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-8)


def test_ring_and_allgather_schedules_agree(mesh8):
    """The two matvec communication schedules compute the same step."""
    pts = data_utils.generate_points(16, dimension=2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    n = pts.shape[0]
    rng = np.random.default_rng(2)
    p_per = int(mesh8.shape["probe"])
    probes = rng.choice([-1.0, 1.0], size=(n, 8 * p_per))
    etas = jnp.asarray([0.5, 5.0])

    outs = []
    for comm in ("ring", "allgather"):
        step = sharded.build_sharded_profile_step(mesh8, nu=0.5,
                                                  lanczos_steps=25,
                                                  comm=comm)
        der1, ti, ld = step(jnp.asarray(pts), jnp.asarray([0.1, 0.1]),
                            jnp.asarray(X), jnp.asarray(z),
                            jnp.asarray(probes), etas)
        outs.append(np.asarray([der1, ti, ld]))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5)


def test_sharded_step_device_count_invariance():
    """Same math on a 4-device and 8-device mesh."""
    pts = data_utils.generate_points(16, dimension=2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    n = pts.shape[0]
    rng = np.random.default_rng(1)
    probes = rng.choice([-1.0, 1.0], size=(n, 16))
    etas = jnp.asarray([1.0])

    results = []
    for nd, probe_ext in [(4, 2), (8, 2)]:
        m = mesh_mod.make_mesh(nd, probe=probe_ext)
        step = sharded.build_sharded_profile_step(m, nu=0.5,
                                                  lanczos_steps=30)
        der1, ti, ld = step(jnp.asarray(pts), jnp.asarray([0.1, 0.1]),
                            jnp.asarray(X), jnp.asarray(z),
                            jnp.asarray(probes), etas)
        results.append((float(der1[0]), float(ti[0]), float(ld[0])))
    a, b = results
    np.testing.assert_allclose(a, b, rtol=1e-6)


def test_sharded_fit_matches_exact(mesh8):
    """End-to-end sharded MLE (VERDICT r3 item 3): one sharded Krylov
    factorization on the mesh, full bracket + Chandrupatla + boundary
    machinery on the host engine — the fit-level result must agree with
    the exact single-device spectral answer."""
    pts = data_utils.generate_points(16, dimension=2)   # n=256
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)

    K = np.asarray(assembly.dense_correlation(pts, 0.1, 0.5))
    Km = MixedCorrelation(K)
    data = dl.make_spectral_data(Km, X, z)
    want = pl_mod.find_log_likelihood_der1_zeros(data, [1e-4, 1e3])

    eng = sharded.ShardedKrylovProfileLikelihood(
        mesh8, pts, X, z, 0.1, nu=0.5, lanczos_steps=40, num_probes=16)
    got = eng.fit()
    assert got["success"]
    np.testing.assert_allclose(got["eta"], want["eta"], rtol=2e-2)
    np.testing.assert_allclose(got["sigma"], want["sigma"], rtol=1e-2)
    np.testing.assert_allclose(got["sigma0"], want["sigma0"], rtol=1e-2)


def test_sharded_fit_padding_invariance(mesh8):
    """n not divisible by the block extent: the far-point/zero-row
    padding must leave the factorization exactly unpadded-equivalent."""
    rng = np.random.default_rng(5)
    n = 250                                             # 250 % 4 != 0
    pts = rng.random((n, 2))
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)

    from gppe_tpu.models.large_scale import KrylovProfileLikelihood
    from gppe_tpu.ops import operators
    op = operators.MaternOperator(pts, 0.1, nu=0.5, block_rows=128)
    ref = KrylovProfileLikelihood(op, X, z, lanczos_steps=40,
                                  num_probes=16)
    r_ref = ref.fit()

    eng = sharded.ShardedKrylovProfileLikelihood(
        mesh8, pts, X, z, 0.1, nu=0.5, lanczos_steps=40, num_probes=16)
    r = eng.fit()
    np.testing.assert_allclose(r["eta"], r_ref["eta"], rtol=5e-2)
    np.testing.assert_allclose(r["sigma0"], r_ref["sigma0"], rtol=1e-2)
