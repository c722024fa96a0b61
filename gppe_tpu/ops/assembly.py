"""Covariance/correlation matrix assembly.

Replacement for the reference's OpenMP Cython assembly
(reference: gaussian_proc/generate_correlation/_generate_dense_correlation.pyx:25-162
and generate_correlation.py:32-222). Dense assembly is a fused
pairwise-distance + Matern evaluation that XLA fuses on the device; very
large N never materializes K at all (see :mod:`gppe_tpu.ops.operators`
matrix-free path). Tapered ("sparse") assembly lives in
:mod:`gppe_tpu.ops.taper`.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import kernels


@partial(jax.jit, static_argnames=("nu_static",))
def _dense_correlation_jit(points, scale, nu, nu_static):
    nu_arg = nu_static if nu_static is not None else nu
    d = kernels.pairwise_scaled_distance(points, points, scale)
    return kernels.matern(d, nu_arg)


def dense_correlation(points, scale, nu, dtype=None):
    """Dense Matern correlation matrix K (n x n) from points (n x d).

    ``nu`` static floats trace a single kernel branch. Assembly runs in
    the compute dtype (f32 on the GPU) regardless of the x64 mode — the
    inference layer re-promotes what it needs.
    """
    from ..utils.config import compute_dtype
    points = jnp.asarray(points, dtype=dtype or compute_dtype())
    scale = kernels.broadcast_scale(scale, points.shape[1]).astype(points.dtype)
    if isinstance(nu, (int, float)):
        return _dense_correlation_jit(points, scale, 0.0, float(nu))
    return _dense_correlation_jit(points, scale, nu, None)


def dense_correlation_blocked(points, scale, nu, block_size: int = 4096):
    """Row-blocked assembly for large n: bounds peak memory of the distance
    intermediate to block_size x n (the XLA analogue of the reference's
    row-parallel prange loop)."""
    points = jnp.asarray(points)
    n = points.shape[0]
    scale = kernels.broadcast_scale(scale, points.shape[1])
    if n <= block_size:
        return dense_correlation(points, scale, nu)
    blocks = []
    for start in range(0, n, block_size):
        rows = points[start:start + block_size]
        d = kernels.pairwise_scaled_distance(rows, points, scale)
        blocks.append(kernels.matern(d, nu))
    return jnp.concatenate(blocks, axis=0)


def generate_correlation(points, correlation_scale=0.1, nu=0.5, grid=True,
                         sparse=False, density=0.001, plot=False,
                         verbose=False):
    """Front-end matching the reference API
    (generate_correlation/generate_correlation.py:32-40).

    Returns a dense jnp array, or a scipy CSR matrix when ``sparse=True``
    (exact tapered correlation, built by the native C++/OpenMP cell-binned
    builder when available; the scalable on-device form of the same object is
    :class:`gppe_tpu.ops.taper.TaperedMaternOperator`).
    """
    points = jnp.asarray(points)
    if points.ndim != 2:
        raise ValueError("points must be a 2D array (n, dimension)")
    scale = kernels.broadcast_scale(correlation_scale, points.shape[1])
    if np.any(np.asarray(scale) <= 0.0):
        raise ValueError("correlation_scale must be positive")
    # the Matern class is defined for nu > 0 only (the reference's
    # general-nu branch divides by gamma(nu), _kernels.pyx:83-88)
    try:
        nu_ok = float(nu) > 0.0
    except (TypeError, ValueError):
        nu_ok = False
    if not nu_ok:
        raise ValueError(f"nu must be a positive scalar, got {nu!r}")

    if sparse:
        from . import taper
        matrix = taper.generate_tapered_correlation(
            points, scale, nu, density, verbose=verbose)
    else:
        matrix = dense_correlation_blocked(points, scale, nu)

    if verbose:
        n = points.shape[0]
        print(f"generated {n}x{n} correlation matrix "
              f"(sparse={sparse}, nu={nu})")
    if plot:
        from ..utils import plot as plot_utils
        plot_utils.plot_matrix(matrix, sparse, verbose=verbose)
    return matrix
