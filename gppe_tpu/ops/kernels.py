"""Matern correlation kernel and anisotropic distances, vectorized.

Re-designs the reference's scalar nogil-Cython kernels
(reference: gaussian_proc/generate_correlation/_kernels.pyx:17-136) as
array-level JAX ops: the closed-form nu branches become selectable
expressions, general nu uses the pure-JAX Bessel K_nu from
:mod:`gppe_tpu.ops.special`, and pairwise distances are computed with the
array (difference or Gram-matrix) formulations instead of scalar loops.

Branch semantics match the reference exactly
(_kernels.pyx:73-93): x == 0 -> 1; nu in {1/2, 3/2, 5/2} closed forms;
nu < 100 general Bessel form; nu >= 100 Gaussian limit exp(-x^2/2).
"""

import jax.numpy as jnp
from jax.scipy.special import gammaln

from . import special

_GAUSSIAN_NU_CUTOFF = 100.0


def _matern_general(x, nu):
    """2^{1-nu}/Gamma(nu) * (sqrt(2 nu) x)^nu * K_nu(sqrt(2 nu) x) for x>0.

    Evaluated fully in log space (special.log_kv): the prefactor
    underflows and K_nu overflows float32 separately around nu ~ 10 even
    though their product is a correlation in (0, 1] — the value-space
    form NaN'd the f32 traced-nu path the posterior-over-nu sampler
    runs on the device."""
    z = jnp.sqrt(2.0 * nu) * x
    z = jnp.maximum(z, jnp.asarray(1e-30, x.dtype))
    log_pref = (1.0 - nu) * jnp.log(2.0) - gammaln(nu) + nu * jnp.log(z)
    # the two logs are ~+-nu*|log z| and cancel; f32 absolute error in
    # the sum (~1e-5 at nu ~ 25) can push the correlation epsilon above
    # its mathematical bound 1 — clamp
    return jnp.minimum(jnp.exp(log_pref + special.log_kv(nu, z)), 1.0)


def matern(x, nu):
    """Matern correlation k(x; nu) of the *scaled* distance x = r / rho.

    ``nu`` may be a static Python float (single branch traced — the fast
    path for assembly kernels) or a traced array (all branches evaluated and
    selected — needed when sampling/optimizing over nu).
    """
    x = jnp.asarray(x)
    sqrt3 = jnp.sqrt(jnp.asarray(3.0, x.dtype))
    sqrt5 = jnp.sqrt(jnp.asarray(5.0, x.dtype))

    if isinstance(nu, (int, float)):
        # Static nu: trace only the relevant branch.
        if nu == 0.5:
            k = jnp.exp(-x)
        elif nu == 1.5:
            k = (1.0 + sqrt3 * x) * jnp.exp(-sqrt3 * x)
        elif nu == 2.5:
            k = (1.0 + sqrt5 * x + (5.0 / 3.0) * x * x) * jnp.exp(-sqrt5 * x)
        elif nu < _GAUSSIAN_NU_CUTOFF:
            k = _matern_general(x, jnp.asarray(nu, x.dtype))
        else:
            k = jnp.exp(-0.5 * x * x)
        return jnp.where(x == 0, jnp.ones_like(x), k)

    # Traced nu: evaluate branches, select elementwise.
    nu = jnp.asarray(nu, x.dtype)
    k_half = jnp.exp(-x)
    k_three_half = (1.0 + sqrt3 * x) * jnp.exp(-sqrt3 * x)
    k_five_half = (1.0 + sqrt5 * x + (5.0 / 3.0) * x * x) * jnp.exp(-sqrt5 * x)
    k_gauss = jnp.exp(-0.5 * x * x)
    k_general = _matern_general(x, jnp.where(nu < _GAUSSIAN_NU_CUTOFF, nu, 1.0))

    k = k_general
    k = jnp.where(nu >= _GAUSSIAN_NU_CUTOFF, k_gauss, k)
    k = jnp.where(nu == 0.5, k_half, k)
    k = jnp.where(nu == 1.5, k_three_half, k)
    k = jnp.where(nu == 2.5, k_five_half, k)
    return jnp.where(x == 0, jnp.ones_like(x), k)


def scaled_distance(p1, p2, scale):
    """Anisotropic Euclidean distance sqrt(sum_d ((p1_d-p2_d)/scale_d)^2).

    Mirrors reference _kernels.pyx:109-136 for single point pairs.
    """
    diff = (jnp.asarray(p1) - jnp.asarray(p2)) / jnp.asarray(scale)
    return jnp.sqrt(jnp.sum(diff * diff, axis=-1))


def pairwise_scaled_distance(points_a, points_b, scale):
    """All-pairs anisotropic distance matrix.

    Replacement for the reference's OpenMP row loop
    (_generate_dense_correlation.pyx:76-91). For spatial dimensions (d <= 8,
    the GP use case) the exact difference form sum_d ((a_d-b_d)/s_d)^2 is
    used: it is cancellation-free and XLA fuses the tiny-d reduction. For
    high-dimensional points the Gram form ||a||^2+||b||^2-2a.b (one
    matmul) is used instead.
    """
    scale = jnp.asarray(scale)
    a = jnp.asarray(points_a) / scale
    b = jnp.asarray(points_b) / scale
    if a.shape[-1] <= 8:
        diff = a[:, None, :] - b[None, :, :]
        d2 = jnp.sum(diff * diff, axis=-1)
    else:
        aa = jnp.sum(a * a, axis=-1)
        bb = jnp.sum(b * b, axis=-1)
        d2 = aa[:, None] + bb[None, :] - 2.0 * (a @ b.T)
    # NaN-safe sqrt under autodiff: d sqrt/d x -> inf at 0 would poison
    # gradients through the (constant) diagonal; zero-distance entries get
    # zero gradient instead (correct: k(0)=1 independent of scale).
    pos = d2 > 0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, d2, 1.0)), 0.0)


def broadcast_scale(scale, dimension: int):
    """Scalar -> per-dimension correlation scale (reference:
    generate_correlation.py:191-196)."""
    scale = jnp.atleast_1d(jnp.asarray(scale, dtype=jnp.result_type(scale, 0.0)))
    if scale.shape[0] == 1 and dimension > 1:
        scale = jnp.repeat(scale, dimension)
    return scale
