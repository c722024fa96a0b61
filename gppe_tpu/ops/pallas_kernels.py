"""Fused Matern correlation products for the GPU (Pallas, Triton route).

The hot operation of the whole framework is K @ V where K is the Matern
correlation of n points. The reference materializes K with OpenMP Cython
(reference: _generate_dense_correlation.pyx:76-91) and hands it to BLAS;
at n = 10^5 that is 40 GB. The plain XLA path (ops.operators) computes K
in row blocks, but each (rows x n) block is written to device memory and
read back by the product. These kernels compute each (TM, TN) correlation
tile in registers from the scaled points, multiply it into the
right-hand-side tile and keep the (TM, r) sum in registers: device-memory
traffic is O(n (d + r)) per row program instead of O(n^2).

Layout: one program per row tile walks every column tile in an in-kernel
loop (GPU programs run in parallel and in no order, so nothing is carried
from one program to the next). Points are stored transposed, (d, n), and
each coordinate row is loaded as a vector; the distance uses the exact
difference form per dimension (no Gram-form cancellation). ``r`` is padded
to a power of two >= 16 (the product's minimum width); padded points sit
far away, so their correlation to every real point is exactly zero in f32.

The tile products run at f32 accuracy, never single-pass TF32 (~3
decimal digits, which moves the profile-likelihood root): on the GPU as
three TF32 tensor-core passes on operands split into high and low parts
(split-TF32; measured faster than IEEE FMAs and closer to f64, PERF.md),
in interpret mode as IEEE f32 (the CPU has no TF32 product).
"""

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Tile sizes (rows, cols) of every kernel program; powers of two, >= 16
# for the tile product. (64, 64) with 4 warps measured fastest among the
# sizes tried on the H100 (PERF.md).
TILE_M = 64
TILE_N = 64
NUM_WARPS = 4

_CLOSED_FORM_NU = (0.5, 1.5, 2.5)


def is_closed_form(nu) -> bool:
    """nu in {0.5, 1.5, 2.5} or the Gaussian limit (nu >= 100)."""
    return isinstance(nu, (int, float)) and (float(nu) in _CLOSED_FORM_NU
                                             or float(nu) >= 100.0)


def use_fused_kernel(nu, platform=None) -> bool:
    """The one place that chooses between the fused kernels and the plain
    XLA paths: the kernels run on a GPU for a closed-form (static) nu;
    every other case takes the plain path. ``platform`` defaults to the
    default backend; sharded callers pass their mesh's device platform."""
    if platform is None:
        platform = jax.default_backend()
    return platform == "gpu" and is_closed_form(nu)


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _pad_width(r: int) -> int:
    return max(16, _next_pow2(r))


def _matern_from_r(r, nu: float):
    """Matern correlation of the scaled distance r, static-nu branch
    (same branches as the reference _kernels.pyx:76-93)."""
    if nu == 0.5:
        return jnp.exp(-r)
    if nu == 1.5:
        s = r * 3.0 ** 0.5
        return (1.0 + s) * jnp.exp(-s)
    if nu == 2.5:
        s = r * 5.0 ** 0.5
        return (1.0 + s + (s * s) * (1.0 / 3.0)) * jnp.exp(-s)
    if nu >= 100.0:
        return jnp.exp(-0.5 * r * r)
    raise ValueError(
        f"fused matern kernels support nu in {{0.5, 1.5, 2.5, inf}}; "
        f"got {nu} (general nu uses the plain XLA path)")


def _tile_dist(rows, cols_ref, start, tn, d):
    """Scaled distance tile (TM, TN) between the loaded row coordinates
    ``rows`` (d vectors of TM) and the column tile at ``start``."""
    d2 = None
    for k in range(d):
        c = cols_ref[k, pl.ds(start, tn)]
        diff = rows[k][:, None] - c[None, :]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    return jnp.sqrt(d2)


def _dot(a, b, split_tf32):
    """Tile product at f32 accuracy: three TF32 tensor-core passes on
    operands split into high and low parts, or IEEE FMAs."""
    if split_tf32:
        return pl.dot(a, b,
                      precision=jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3)
    return pl.dot(a, b, precision=(jax.lax.Precision.HIGHEST,
                                   jax.lax.Precision.HIGHEST))


def _dense_kernel(inv_ref, rows_ref, cols_ref, v_ref, out_ref, *, nu, d, B,
                  tm, tn, num_col_tiles, split_tf32):
    i = pl.program_id(0)
    rs = pl.ds(pl.multiple_of(i * tm, tm), tm)
    rows = [rows_ref[k, rs] for k in range(d)]
    inv = [inv_ref[b] for b in range(B)]
    r_pad = v_ref.shape[-1]

    def body(j, accs):
        start = pl.multiple_of(j * tn, tn)
        r0 = _tile_dist(rows, cols_ref, start, tn, d)
        return tuple(
            acc + _dot(_matern_from_r(r0 * inv[b], nu),
                       v_ref[b, pl.ds(start, tn), :], split_tf32)
            for b, acc in enumerate(accs))

    accs = tuple(jnp.zeros((tm, r_pad), jnp.float32) for _ in range(B))
    accs = jax.lax.fori_loop(0, num_col_tiles, body, accs)
    for b in range(B):
        out_ref[b, rs, :] = accs[b]


@functools.partial(jax.jit, static_argnames=("nu", "tm", "tn", "num_warps",
                                              "split_tf32", "interpret"))
def _dense_padded(inv_rho, rows_t, cols_t, V, nu, tm, tn, num_warps,
                  split_tf32, interpret=False):
    """inv_rho: (B,); rows_t: (d, nr_pad); cols_t: (d, nc_pad);
    V: (B, nc_pad, r_pad). Returns (B, nr_pad, r_pad)."""
    d, nr_pad = rows_t.shape
    nc_pad = cols_t.shape[1]
    B, _, r_pad = V.shape
    kernel = functools.partial(_dense_kernel, nu=nu, d=d, B=B, tm=tm, tn=tn,
                               num_col_tiles=nc_pad // tn,
                               split_tf32=split_tf32 and not interpret)
    return pl.pallas_call(
        kernel,
        grid=(nr_pad // tm,),
        out_shape=jax.ShapeDtypeStruct((B, nr_pad, r_pad), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=2),
        cost_estimate=pl.CostEstimate(
            flops=2 * nr_pad * nc_pad * (B * r_pad + 2 * d + B * 4),
            bytes_accessed=4 * (nr_pad // tm) * nc_pad * (d + B * r_pad),
            transcendentals=nr_pad * nc_pad * (B + 1)),
        interpret=interpret,
        name="matern_matmat",
    )(inv_rho, rows_t, cols_t, V)


def _pad_points_t(points, n_pad):
    """(n, d) -> (d, n_pad); padded points sit far away and mutually
    apart (their correlation to every real point is exactly 0 in f32)."""
    n, d = points.shape
    out = jnp.zeros((d, n_pad), dtype=jnp.float32)
    out = out.at[:, :n].set(points.T)
    if n_pad > n:
        far = 1e6 * (2.0 + jnp.arange(n_pad - n, dtype=jnp.float32))
        out = out.at[0, n:].set(far)
    return out


def _round_up(n, m):
    return -(-n // m) * m


def matern_matmat(points, scale, V, nu, points_cols=None, interpret=False):
    """K @ V with K the Matern correlation, fused: K is never stored.

    ``points`` are the row points (nr, d); ``points_cols`` defaults to the
    same set (square K) but may differ; the rectangular form is the local
    matvec of the row-block-sharded engine (gppe_tpu.parallel). ``scale``
    is a scalar or per-dimension correlation scale. ``V``: (nc, r).
    Returns (nr, r) float32. The B = 1 case of
    :func:`matern_matmat_multirho` on pre-scaled points.
    """
    with jax.enable_x64(False):
        scale = jnp.asarray(scale, dtype=jnp.float32)
        rows = jnp.asarray(points, dtype=jnp.float32) / scale
        cols = rows if points_cols is None else (
            jnp.asarray(points_cols, dtype=jnp.float32) / scale)
        V = jnp.asarray(V, dtype=jnp.float32)
        return _fused_call(rows, cols, jnp.ones((1,), jnp.float32),
                           V[None], float(nu), interpret)[0]


def _fused_call(rows, cols, inv, V, nu, interpret, tm=TILE_M, tn=TILE_N,
                num_warps=NUM_WARPS, split_tf32=True):
    """Pad, call the dense kernel, crop. rows/cols are scaled (n, d).
    The tile sizes, warps and product are arguments for the sweep in
    drivers/kernel_timings.py; callers keep the defaults."""
    if not is_closed_form(nu):
        _matern_from_r(None, nu)        # raises the unsupported-nu error
    nr = rows.shape[0]
    nc = cols.shape[0]
    B, _, r = V.shape
    rows_t = _pad_points_t(rows, _round_up(nr, tm))
    cols_t = _pad_points_t(cols, _round_up(nc, tn))
    nc_pad = cols_t.shape[1]
    V_pad = jnp.zeros((B, nc_pad, _pad_width(r)), jnp.float32)
    V_pad = V_pad.at[:, :nc, :r].set(V)
    out = _dense_padded(inv, rows_t, cols_t, V_pad, nu, tm, tn, num_warps,
                        split_tf32, interpret)
    return out[:, :nr, :r]


def matern_matmat_multirho(points, rhos, V, nu, interpret=False):
    """K(rho_b) @ V_b for a batch of isotropic correlation scales, fused.

    ``points``: (n, d) RAW (unscaled) points; ``rhos``: (B,) scalar
    scales; ``V``: (B, n, r). Returns (B, n, r) float32. Each pairwise
    distance tile is computed once and shared by the whole rho batch (rho
    only rescales distance), so each extra grid point costs one exp and
    one tile product: the engine of the matrix-free grid-batched Krylov
    path (models.grid_krylov; the reference rebuilds K per grid point,
    examples/FindOptimalCovarianceParameters.py:87-117).
    """
    with jax.enable_x64(False):
        pts = jnp.asarray(points, dtype=jnp.float32)
        V = jnp.asarray(V, dtype=jnp.float32)
        inv = 1.0 / jnp.asarray(rhos, dtype=jnp.float32).reshape(-1)
        return _fused_call(pts, pts, inv, V, float(nu), interpret)


def _blocksparse_kernel(rowptr_ref, colidx_ref, pts_ref, v_ref, out_ref, *,
                        nu, d, tau, tile, tm, tn, split_tf32):
    i = pl.program_id(0)
    s = pl.program_id(1)
    row0 = pl.multiple_of(i * tile + s * tm, tm)
    rows = [pts_ref[k, pl.ds(row0, tm)] for k in range(d)]
    r_pad = v_ref.shape[-1]

    def pair(p, acc):
        j = colidx_ref[p]

        def sub(c, acc):
            start = pl.multiple_of(j * tile + c * tn, tn)
            kt = _matern_from_r(_tile_dist(rows, pts_ref, start, tn, d), nu)
            # hard taper: exact parity with the reference's threshold drop
            kt = jnp.where(kt >= tau, kt, 0.0)
            return acc + _dot(kt, v_ref[pl.ds(start, tn), :], split_tf32)

        return jax.lax.fori_loop(0, tile // tn, sub, acc)

    acc = jnp.zeros((tm, r_pad), jnp.float32)
    acc = jax.lax.fori_loop(rowptr_ref[i], rowptr_ref[i + 1], pair, acc)
    out_ref[pl.ds(row0, tm), :] = acc


@functools.partial(jax.jit, static_argnames=("nu", "tau", "tile", "tm", "tn",
                                              "interpret"))
def _blocksparse_padded(rowptr, colidx, pts_t, V, nu, tau, tile, tm, tn,
                        interpret=False):
    d, n_pad = pts_t.shape
    r_pad = V.shape[1]
    num_pairs = colidx.shape[0]
    kernel = functools.partial(_blocksparse_kernel, nu=nu, d=d, tau=tau,
                               tile=tile, tm=tm, tn=tn,
                               split_tf32=not interpret)
    return pl.pallas_call(
        kernel,
        grid=(n_pad // tile, tile // tm),
        out_shape=jax.ShapeDtypeStruct((n_pad, r_pad), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=2),
        cost_estimate=pl.CostEstimate(
            flops=2 * num_pairs * tile * tile * (r_pad + 2 * d + 5),
            bytes_accessed=4 * num_pairs * tile * (tile // tm)
            * (d + r_pad),
            transcendentals=2 * num_pairs * tile * tile),
        interpret=interpret,
        name="matern_matmat_blocksparse",
    )(rowptr, colidx, pts_t, V)


def matern_matmat_blocksparse(points_sorted, V, nu, tau, rowptr, colidx,
                              tile, interpret=False):
    """Tapered (block-sparse) K @ V over the active tile pairs only.

    ``points_sorted``: (n_pad, d) spatially sorted, *already scaled*
    points (padded to a ``tile`` multiple); ``rowptr`` (num_tiles + 1,)
    and ``colidx`` (num_pairs,): the active column tiles of each row tile
    in CSR form (gppe_tpu.ops.taper builds them). Each program owns a
    (tile_m, r) slice of one row tile and walks that row's active column
    tiles in (TILE_M, TILE_N) sub-tiles (the tile itself where smaller).
    """
    tm = min(TILE_M, tile)
    tn = min(TILE_N, tile)
    if tile % tm or tile % tn:
        raise ValueError(f"tile {tile} must be a multiple of the kernel "
                         f"sub-tiles ({tm}, {tn})")
    with jax.enable_x64(False):
        pts = jnp.asarray(points_sorted, dtype=jnp.float32)
        V = jnp.asarray(V, dtype=jnp.float32)
        n_pad, r = V.shape
        V_pad = jnp.zeros((n_pad, _pad_width(r)), jnp.float32)
        V_pad = V_pad.at[:, :r].set(V)
        out = _blocksparse_padded(
            jnp.asarray(rowptr, dtype=jnp.int32),
            jnp.asarray(colidx, dtype=jnp.int32), pts.T, V_pad,
            float(nu), float(tau), int(tile), tm, tn, interpret)
        return out[:, :r]
