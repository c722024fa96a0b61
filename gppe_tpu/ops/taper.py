"""Kernel tapering ("sparse" correlation) — block-sparse form.

The reference sparsifies K by dropping entries whose kernel value falls
below a threshold estimated from the requested density via d-ball
geometry, building CSR with OpenMP threads and a retry-on-overflow loop
(reference: gaussian_proc/generate_correlation/_generate_sparse_correlation.pyx:
294-465 threshold math, :129-197 locked COO assembly, :550-577 retries).

Here the same statistical object is expressed two ways:

* ``generate_tapered_correlation`` — host-side exact CSR (scipy), built
  natively or from a KD-tree, for API parity and moderate n;
* ``TaperedMaternOperator`` — the scalable path: points are spatially
  sorted (grid-cell keys) so near points share tiles, a tile-pair
  adjacency mask is computed from tile bounding boxes and the taper
  radius, and matvecs touch only active tiles. The kernel value mask
  (k >= threshold) matches the reference's hard taper exactly. On the
  GPU the active tiles run through the fused Pallas kernel; K is never
  materialized.

Since k(.; nu) is monotone decreasing, the taper "k >= threshold" is the
distance ball "d <= kernel_radius" — tiles are pruned on distance,
entries masked on kernel value.
"""

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from . import kernels, pallas_kernels


# -- d-ball threshold math (reference :208-465, formulas preserved; the
#    reference's missing-argument bug at :390 is fixed) -------------------

def gamma_function(dimension):
    """Gamma(dimension/2 + 1) by half-integer recursion
    (reference :208-233)."""
    if dimension % 2 == 0:
        k = 0.5 * dimension
        gamma = 1.0
        while k > 0.0:
            gamma *= k
            k -= 1.0
    else:
        k = np.ceil(0.5 * dimension)
        gamma = np.sqrt(np.pi)
        while k > 0.0:
            gamma *= k - 0.5
            k -= 1.0
    return gamma


def ball_radius(volume, dimension):
    """Radius of the d-ball of given volume (reference :240-260)."""
    return (gamma_function(dimension) * volume) ** (1.0 / dimension) \
        / np.sqrt(np.pi)


def ball_volume(radius, dimension):
    """Volume of the d-ball of given radius (reference :267-287)."""
    return (radius * np.sqrt(np.pi)) ** dimension / gamma_function(dimension)


def estimate_kernel_radius(matrix_size, dimension, density,
                           correlation_scale):
    """Scaled taper radius (in units of d/rho) for a target density.

    Geometry (the intent of reference _estimate_kernel_threshold:294-413):
    a point should keep ``a = density * n`` neighbors; for ~uniform points
    in the unit hypercube with spacing ``l = 1/(n^{1/d}-1)``, those
    neighbors occupy a d-ball of volume ``a * l^d``, whose radius is the
    physical taper radius. (Note: the reference's own implementation also
    divides the adjacency by the correlation-ellipsoid volume and calls
    _ball_volume with a missing argument (:388-390) — a latent bug that
    would crash and, if patched literally, inflates the density ~100x;
    the clean derivation is used here and is validated against the
    *requested* density in tests.)
    """
    adjacency = density * matrix_size
    if adjacency < 1.0:
        raise ValueError(
            f"Adjacency {adjacency:.2f} < 1: correlation matrix "
            "would become identity. Increase density or correlation_scale.")

    scale = np.atleast_1d(np.asarray(correlation_scale, dtype=float))
    geometric_mean_scale = np.prod(scale) ** (1.0 / dimension)

    grid_axis_num_points = matrix_size ** (1.0 / dimension)
    grid_size = 1.0 / max(grid_axis_num_points - 1.0, 1.0)
    kernel_radius = ball_radius(adjacency * grid_size ** dimension,
                                dimension)
    # physical radius -> scaled-distance radius
    return kernel_radius / geometric_mean_scale


def estimate_kernel_threshold(matrix_size, dimension, density,
                              correlation_scale, nu):
    """Taper threshold tau = k(kernel_radius; nu) (reference :294-413)."""
    r = estimate_kernel_radius(matrix_size, dimension, density,
                               correlation_scale)
    return float(kernels.matern(np.asarray(r), float(nu)))


def estimate_max_nnz(matrix_size, correlation_scale, dimension, density):
    """Upper estimate of nnz (reference _estimate_max_nnz:420-465);
    informational here — the builders below size arrays exactly."""
    estimated_nnz = int(np.ceil(density * matrix_size ** 2))
    scale = np.atleast_1d(np.asarray(correlation_scale, dtype=float))
    normalized = scale / scale.max()
    geometric_mean_radius = np.prod(normalized) ** (1.0 / dimension)
    safety = 1.0 / ball_radius(geometric_mean_radius, dimension)
    return int(np.ceil(safety * estimated_nnz))


# -- host CSR builder (API parity with the reference) ---------------------

def generate_tapered_correlation(points, scale, nu, density, verbose=False):
    """Exact tapered correlation as scipy CSR (reference
    generate_sparse_correlation:472-594 semantics: keep k >= tau)."""
    import scipy.sparse

    points = np.asarray(points, dtype=float)
    n, d = points.shape
    scale = np.atleast_1d(np.asarray(scale, dtype=float))
    if scale.size == 1:
        scale = np.repeat(scale, d)
    tau = estimate_kernel_threshold(n, d, density, scale, nu)
    radius = estimate_kernel_radius(n, d, density, scale)
    pts_scaled = points / scale

    # native C++/OpenMP cell-binned builder (O(n k)); k >= tau is
    # equivalent to distance <= radius since the kernel is monotone
    from .. import native
    res = native.taper_csr(pts_scaled, radius, nu)
    if res is not None:
        values, indices, indptr = res
        csr = scipy.sparse.csr_matrix((values, indices, indptr),
                                      shape=(n, n))
        if verbose:
            print(f"tapered correlation (native, "
                  f"{native.num_threads()} threads): n={n} "
                  f"tau={tau:.3e} nnz={csr.nnz} "
                  f"density={csr.nnz / n ** 2:.3e}")
        return csr

    # scipy KD-tree fallback (O(n k)): candidate pairs within a slightly
    # widened radius, then the exact k >= tau mask on kernel values
    import scipy.spatial

    pairs = scipy.spatial.cKDTree(pts_scaled).query_pairs(
        radius * (1.0 + 1e-9), output_type="ndarray")
    dist = np.sqrt(((pts_scaled[pairs[:, 0]] - pts_scaled[pairs[:, 1]])
                    ** 2).sum(-1))
    kval = np.asarray(kernels.matern(dist, float(nu)))
    keep = kval >= tau
    i, j, kval = pairs[keep, 0], pairs[keep, 1], kval[keep]
    diag = np.arange(n)
    rows = np.concatenate([i, j, diag])
    cols = np.concatenate([j, i, diag])
    vals = np.concatenate([kval, kval, np.ones(n)])
    csr = scipy.sparse.csr_matrix((vals, (rows, cols)), shape=(n, n))
    if verbose:
        print(f"tapered correlation: n={n} tau={tau:.3e} "
              f"nnz={csr.nnz} density={csr.nnz / n ** 2:.3e}")
    return csr


# -- spatial sorting and the block-sparse operator ------------------------

def spatial_sort(points, cell_size):
    """Sort points by grid-cell key (row-major cells of width cell_size in
    scaled coordinates) so that spatial neighbors are contiguous.
    Returns the permutation."""
    pts = np.asarray(points)
    cells = np.floor(pts / cell_size).astype(np.int64)
    # lexicographic cell key, then original index for determinism
    order = np.lexsort(tuple(cells[:, k] for k in range(pts.shape[1] - 1,
                                                        -1, -1)))
    return order


class TaperedMaternOperator:
    """Block-sparse tapered Matern operator: matvec touches only tile
    pairs within the taper radius. The scalable replacement for the
    reference's CSR path (N = 2^20 with O(density n^2) work)."""

    def __init__(self, points, scale, nu=0.5, density=0.001, tile=512,
                 dtype=None, use_pallas=None):
        """``use_pallas``: run the fused GPU kernel
        (ops.pallas_kernels.matern_matmat_blocksparse); default
        :func:`pallas_kernels.use_fused_kernel`."""
        from ..utils.config import compute_dtype
        dtype = dtype or compute_dtype()
        points = np.asarray(points, dtype=np.float64)
        n, d = points.shape
        scale_arr = np.atleast_1d(np.asarray(scale, dtype=float))
        if scale_arr.size == 1:
            scale_arr = np.repeat(scale_arr, d)

        self.nu = float(nu)
        self.density = density
        self.tile = int(min(tile, n))
        self.radius = estimate_kernel_radius(n, d, density, scale_arr)
        self.threshold = estimate_kernel_threshold(n, d, density,
                                                   scale_arr, nu)

        # sort by spatial cells of the taper radius (scaled coordinates)
        pts_scaled = points / scale_arr
        self.perm = spatial_sort(pts_scaled, max(self.radius, 1e-12))
        self.inv_perm = np.argsort(self.perm)
        pts_sorted = pts_scaled[self.perm]

        # pad to a tile multiple with far-away points
        t = self.tile
        n_pad = -(-n // t) * t
        if n_pad > n:
            pad = np.zeros((n_pad - n, d))
            pad[:, 0] = 1e6 * (2.0 + np.arange(n_pad - n))
            pts_sorted = np.concatenate([pts_sorted, pad], axis=0)
        self._n = n
        self.n_pad = n_pad
        num_tiles = n_pad // t

        # tile bounding boxes -> active pairs (bbox distance <= radius)
        boxes_lo = pts_sorted.reshape(num_tiles, t, d).min(axis=1)
        boxes_hi = pts_sorted.reshape(num_tiles, t, d).max(axis=1)
        gap = np.maximum(
            np.maximum(boxes_lo[:, None, :] - boxes_hi[None, :, :],
                       boxes_lo[None, :, :] - boxes_hi[:, None, :]), 0.0)
        tile_dist = np.sqrt((gap ** 2).sum(-1))
        active = tile_dist <= self.radius
        pi, pj = np.nonzero(active)
        order = np.lexsort((pj, pi))      # sort by row tile then col tile
        self.pair_i = pi[order].astype(np.int32)
        self.pair_j = pj[order].astype(np.int32)
        # CSR form of the pairs: row tile i owns pair_j[rowptr[i]:rowptr[i+1]]
        self.rowptr = np.concatenate(
            [[0], np.cumsum(np.bincount(self.pair_i, minlength=num_tiles))]
        ).astype(np.int32)
        self.num_tiles = num_tiles
        self.tile_density = len(self.pair_i) / num_tiles ** 2

        self.points_sorted = jnp.asarray(pts_sorted, dtype=dtype)
        self.dtype = dtype
        if use_pallas is None:
            use_pallas = pallas_kernels.use_fused_kernel(self.nu)
        self.use_pallas = use_pallas

    @property
    def shape(self):
        return (self._n, self._n)

    def nnz_estimate(self):
        return estimate_max_nnz(self._n, 1.0, 2, self.density)

    def matmat(self, V):
        V = jnp.asarray(V, dtype=self.dtype)
        squeeze = V.ndim == 1
        if squeeze:
            V = V[:, None]
        # permute into sorted order, pad
        Vs = V[self.perm]
        if self.n_pad > self._n:
            Vs = jnp.concatenate(
                [Vs, jnp.zeros((self.n_pad - self._n, V.shape[1]),
                               dtype=self.dtype)], axis=0)
        if self.use_pallas:
            out = pallas_kernels.matern_matmat_blocksparse(
                self.points_sorted, Vs, self.nu, self.threshold,
                self.rowptr, self.pair_j, self.tile).astype(self.dtype)
        else:
            out = _blocksparse_matmat_xla(
                self.points_sorted, Vs, jnp.asarray(self.pair_i),
                jnp.asarray(self.pair_j), self.nu, self.threshold,
                self.tile)
        out = out[:self._n][self.inv_perm]
        return out[:, 0] if squeeze else out

    def matvec(self, v):
        return self.matmat(v)

    def trace_pow(self, exponent):
        if exponent in (0, 1):
            return jnp.asarray(float(self._n), dtype=self.dtype)
        if exponent == 2:
            # sum of squared *tapered* entries over active tiles; padded
            # diagonal tiles contribute matern(0)=1 per padded row
            acc = _blocksparse_frobenius2_xla(
                self.points_sorted, jnp.asarray(self.pair_i),
                jnp.asarray(self.pair_j), self.nu, self.threshold,
                self.tile)
            return acc - (self.n_pad - self._n)
        raise ValueError("exponent must be 0, 1 or 2")


def _pair_tiles(pts, pair_i, pair_j, nu, tau, t):
    """Tapered kernel tiles (C, t, t) of a chunk of active pairs."""
    num_tiles = pts.shape[0] // t
    tiles = pts.reshape(num_tiles, t, pts.shape[1])
    rows, cols = tiles[pair_i], tiles[pair_j]
    d2 = jnp.sum((rows[:, :, None, :] - cols[:, None, :, :]) ** 2, axis=-1)
    kblk = kernels.matern(jnp.sqrt(d2), nu)
    return jnp.where(kblk >= tau, kblk, 0.0)


# active tile pairs per step of the plain XLA path: a (64, 512, 512) f32
# tile batch is 64 MB
_PAIR_CHUNK = 64


def _chunk_pairs(pair_i, pair_j, chunk, dtype):
    """Pairs as (num_chunks, chunk) arrays plus a 0/1 weight; the last
    chunk is padded with zero-weight repeats of pair 0."""
    num_pairs = pair_i.shape[0]
    chunk = min(chunk, num_pairs)
    pad = -num_pairs % chunk
    w = (jnp.arange(num_pairs + pad) < num_pairs).astype(dtype)
    return (jnp.pad(pair_i, (0, pad)).reshape(-1, chunk),
            jnp.pad(pair_j, (0, pad)).reshape(-1, chunk),
            w.reshape(-1, chunk))


@partial(jax.jit, static_argnames=("nu", "tau", "t", "chunk"))
def _blocksparse_matmat_xla(pts, Vs, pair_i, pair_j, nu, tau, t,
                            chunk=_PAIR_CHUNK):
    """Plain XLA block-sparse K @ V: ``chunk`` active pairs per step are
    gathered, evaluated as one batched tile product and segment-summed
    into their row tiles."""
    num_tiles = pts.shape[0] // t
    Vt = Vs.reshape(num_tiles, t, Vs.shape[1])

    def body(out, c):
        ci, cj, cw = c
        kblk = _pair_tiles(pts, ci, cj, nu, tau, t)
        acc = jnp.einsum("cab,cbr->car", kblk, Vt[cj] * cw[:, None, None],
                         precision="highest")
        return out.at[ci].add(acc), None

    out, _ = jax.lax.scan(body, jnp.zeros_like(Vt),
                          _chunk_pairs(pair_i, pair_j, chunk, Vs.dtype))
    return out.reshape(Vs.shape)


@partial(jax.jit, static_argnames=("nu", "tau", "t", "chunk"))
def _blocksparse_frobenius2_xla(pts, pair_i, pair_j, nu, tau, t,
                                chunk=_PAIR_CHUNK):
    """Sum of the squared tapered entries over the active tile pairs."""
    def body(acc, c):
        ci, cj, cw = c
        kblk = _pair_tiles(pts, ci, cj, nu, tau, t)
        return acc + jnp.sum(kblk * kblk * cw[:, None, None]), None

    acc, _ = jax.lax.scan(body, jnp.zeros((), pts.dtype),
                          _chunk_pairs(pair_i, pair_j, chunk, pts.dtype))
    return acc
