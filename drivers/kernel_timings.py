"""Fused GPU kernels vs the plain XLA versions, on the card.

For each kernel of ops.pallas_kernels: a check against a numpy f64
reference at the main path's shapes, then its time next to the time of
the plain XLA version (median of 5 timed calls of a jitted chain of
dependent products, after warm-up). ``--e2e`` adds the end-to-end steps
that use each kernel, run with the kernel and with the plain path.

    python drivers/kernel_timings.py [--e2e] [--sweep [--tiles 64x64x4,...]]
                                     [--surface] [--skip-cases] [--out PATH]

``--sweep`` times matern_matmat for each tile product (split-TF32, IEEE
FMA) and tile setting; ``--surface`` builds the default n = 100k
posterior surface first and reports its peak device memory.

Needs a GPU; prints one JSON line per measurement, each with the card's
name and power limit.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

import argparse
import json
import subprocess
import time

import numpy as np


def card():
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def chain_seconds(step, x, length=10, reps=5):
    """Median seconds per call of ``step`` inside a jitted chain of
    ``length`` dependent calls (each output, normalized, feeds the
    next), after one warm-up chain."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chain(x):
        def body(_, x):
            y = step(x)
            return y / (jnp.linalg.norm(y) + 1e-30)
        return jax.lax.fori_loop(0, length, body, x)

    jax.block_until_ready(chain(x))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(x))
        times.append((time.perf_counter() - t0) / length)
    return float(np.median(times))


def rel_frob(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _rows_ref(pts, rows, scale, V, nu=0.5):
    """numpy f64 K[rows] @ V (ν = 0.5)."""
    d = np.sqrt((((pts[rows, None, :] - pts[None, :, :]) / scale) ** 2)
                .sum(-1))
    assert nu == 0.5
    return np.exp(-d) @ V


def dense_case(n=100_000, r=23, seed=0):
    """matern_matmat at the n = 100k main path: 1,024 sampled rows vs
    numpy f64, then kernel vs plain blocked XLA time."""
    import jax.numpy as jnp

    from gppe_tpu.ops import operators, pallas_kernels as pk

    rng = np.random.RandomState(seed)
    pts = rng.rand(n, 2)
    V = rng.standard_normal((n, r)).astype(np.float32)
    rows = rng.choice(n, min(n, 1024), replace=False)
    got = np.asarray(pk.matern_matmat(pts, 0.1, V, 0.5))[rows]
    err = rel_frob(got, _rows_ref(pts, rows, 0.1, V.astype(np.float64)))

    p32 = jnp.asarray(pts, jnp.float32)
    scale = jnp.full((2,), 0.1, jnp.float32)
    t_k = chain_seconds(lambda x: pk.matern_matmat(p32, scale, x, 0.5),
                        jnp.asarray(V))
    t_x = chain_seconds(
        lambda x: operators._matern_matmat_blocked(p32, scale, x, 0.5,
                                                   1024), jnp.asarray(V))
    return {"kernel": "matern_matmat", "n": n, "r": r,
            "rel_frob_vs_f64": err, "kernel_ms": 1e3 * t_k,
            "plain_xla_ms": 1e3 * t_x}


def multirho_case(n=100_000, B=8, r=9, seed=1):
    """matern_matmat_multirho at n = 100k, B = 8: sampled rows of each
    product vs f64, then its time next to the plain per-rho blocked XLA
    form. Also ||K_b||_F^2 from the plain f32 blocked reduction the grid
    engines use, vs f64, and its time."""
    import jax
    import jax.numpy as jnp

    from gppe_tpu.ops import operators, pallas_kernels as pk

    rng = np.random.RandomState(seed)
    pts = rng.rand(n, 2)
    rhos = np.geomspace(0.03, 0.3, B)
    V = rng.standard_normal((B, n, r)).astype(np.float32)
    rows = rng.choice(n, min(n, 1024), replace=False)
    out = np.asarray(pk.matern_matmat_multirho(pts, rhos, V, 0.5))
    errs = [rel_frob(out[b][rows], _rows_ref(pts, rows, rhos[b],
                                             V[b].astype(np.float64)))
            for b in range(B)]
    p32 = jnp.asarray(pts, jnp.float32)
    r32 = jnp.asarray(rhos, jnp.float32)

    def tk2(p, r):
        return jax.lax.map(lambda rho: operators._matern_frobenius2_blocked(
            p, jnp.full((2,), rho, p.dtype), 0.5, 1024), r)

    with jax.enable_x64(True):
        want_tk2 = np.asarray(tk2(jnp.asarray(pts), jnp.asarray(rhos)))
    tk2_err = float(np.max(np.abs(np.asarray(tk2(p32, r32)) / want_tk2
                                  - 1.0)))

    def plain(W):
        return jax.lax.map(
            lambda a: operators._matern_matmat_blocked(
                p32, jnp.full((2,), a[0]), a[1], 0.5, 1024), (r32, W))

    t_k = chain_seconds(
        lambda W: pk.matern_matmat_multirho(p32, r32, W, 0.5),
        jnp.asarray(V))
    t_x = chain_seconds(plain, jnp.asarray(V), length=3)
    t_xf = chain_seconds(lambda s: s + tk2(p32, r32), jnp.ones(B), length=3)
    return {"kernel": "matern_matmat_multirho", "n": n, "B": B, "r": r,
            "max_rel_frob_vs_f64": max(errs),
            "max_frobenius_rel_err": tk2_err,
            "kernel_ms": 1e3 * t_k, "plain_xla_ms": 1e3 * t_x,
            "frobenius_plain_xla_ms": 1e3 * t_xf}


def taper_case(side=256, r=24, scale=0.005, density=1e-3, seed=2,
               check=True):
    """Tapered block-sparse product on a side^2 grid: vs a scipy CSR f64
    matvec from taper.generate_tapered_correlation (``check``), then the
    kernel vs the plain chunked XLA form."""
    import jax.numpy as jnp

    from gppe_tpu import native
    from gppe_tpu.ops import pallas_kernels as pk, taper
    from gppe_tpu.utils import data as data_utils

    pts = data_utils.generate_points(side, dimension=2)
    n = pts.shape[0]
    rng = np.random.RandomState(seed)
    V = rng.standard_normal((n, r))
    op = taper.TaperedMaternOperator(pts, scale, nu=0.5, density=density,
                                     use_pallas=True)
    res = {"kernel": "matern_matmat_blocksparse", "n": n, "r": r,
           "tile": op.tile, "pairs": int(len(op.pair_j)),
           "tile_density": op.tile_density}
    if check:
        t0 = time.perf_counter()
        csr = taper.generate_tapered_correlation(pts, scale, 0.5, density)
        res["csr_build_s"] = time.perf_counter() - t0
        res["csr_native"] = native.available()
        want = csr @ V
        got = np.asarray(op.matmat(jnp.asarray(V, jnp.float32)))
        res["rel_frob_vs_csr_f64"] = rel_frob(got, want)
        res["max_abs_err_vs_csr_f64"] = float(np.max(np.abs(got - want)))
    Vs = jnp.zeros((op.n_pad, r), jnp.float32).at[:n].set(
        jnp.asarray(V[op.perm], jnp.float32))
    pts_s = op.points_sorted
    rowptr = jnp.asarray(op.rowptr)
    pi, pj = jnp.asarray(op.pair_i), jnp.asarray(op.pair_j)
    res["kernel_ms"] = 1e3 * chain_seconds(
        lambda x: pk.matern_matmat_blocksparse(
            pts_s, x, 0.5, op.threshold, rowptr, pj, op.tile), Vs)
    res["plain_xla_ms"] = 1e3 * chain_seconds(
        lambda x: taper._blocksparse_matmat_xla(
            pts_s, x, pi, pj, 0.5, op.threshold, op.tile), Vs)
    return res


SWEEP_TILES = ((64, 64, 4), (128, 32, 4), (32, 64, 4), (64, 128, 4),
               (128, 64, 4), (128, 128, 8))


def sweep_cases(tiles=SWEEP_TILES, n=100_000, r=23, seed=0):
    """matern_matmat at the main path's shape for each tile product
    (split-TF32, IEEE FMA) and (rows, cols, warps) tile setting: its
    accuracy on 1,024 sampled rows vs numpy f64 and its time."""
    import jax.numpy as jnp

    from gppe_tpu.ops import pallas_kernels as pk

    rng = np.random.RandomState(seed)
    pts = rng.rand(n, 2)
    V = rng.standard_normal((n, r)).astype(np.float32)
    rows = rng.choice(n, 1024, replace=False)
    want = _rows_ref(pts, rows, 0.1, V.astype(np.float64))
    p32 = jnp.asarray(pts / 0.1, jnp.float32)
    one = jnp.ones((1,), jnp.float32)
    out = []
    for product in ("split_tf32", "ieee"):
        for tm, tn, warps in tiles:
            def step(x, tm=tm, tn=tn, warps=warps):
                return pk._fused_call(p32, p32, one, x[None], 0.5, False,
                                      tm, tn, warps,
                                      product == "split_tf32")[0]
            got = np.asarray(step(jnp.asarray(V)))[rows]
            out.append({"sweep": "matern_matmat", "n": n, "r": r,
                        "product": product, "tile_m": tm, "tile_n": tn,
                        "num_warps": warps,
                        "rel_frob_vs_f64": rel_frob(got, want),
                        "kernel_ms": 1e3 * chain_seconds(step,
                                                         jnp.asarray(V))})
    return out


def surface_case(n=100_000, seed=7):
    """The default KrylovPosteriorSurface build (12 rho nodes, k = 64,
    24 probes) at n = 100k: its node chunk under the device-memory budget
    (models.krylov_posterior.surface_chunk_bytes), the seconds it takes
    and the device's peak memory. Run it first in its process: the peak
    is the process's own."""
    import jax

    from gppe_tpu.models import krylov_posterior as kp
    from gppe_tpu.utils import data as data_utils

    rng = np.random.RandomState(seed)
    pts = rng.rand(n, 2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    dev = jax.devices()[0]
    before = dev.memory_stats() or {}
    t0 = time.perf_counter()
    kp.KrylovPosteriorSurface(pts, z, X, nu=0.5)
    secs = time.perf_counter() - t0
    stats = dev.memory_stats() or {}
    C = 1 + X.shape[1] + 1 + 24
    bytes_per_node = 64 * n * C * 4
    budget = kp.surface_chunk_bytes()
    return {"step": "surface_build_n100k_B12_k64_p24", "seconds_cold": secs,
            "budget_bytes": budget, "bytes_per_node": bytes_per_node,
            "node_chunk": max(1, budget // bytes_per_node),
            "bytes_limit": stats.get("bytes_limit"),
            "peak_bytes_before": before.get("peak_bytes_in_use"),
            "peak_bytes_in_use": stats.get("peak_bytes_in_use")}


def e2e_cases(n=100_000, sides=(256, 1024)):
    """End-to-end steps with the kernel and with the plain path."""
    import jax
    import jax.numpy as jnp

    from gppe_tpu.models.grid_krylov import _factorize_chunk_matrixfree
    from gppe_tpu.models.large_scale import KrylovProfileLikelihood
    from gppe_tpu.ops import operators, taper
    from gppe_tpu.utils import data as data_utils

    out = []
    rng = np.random.RandomState(7)
    pts = rng.rand(n, 2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    for use in (True, False):
        op = operators.MaternOperator(pts, 0.1, nu=0.5, use_pallas=use)
        KrylovProfileLikelihood(op, X, z, lanczos_steps=64, num_probes=16)
        t0 = time.perf_counter()
        eng = KrylovProfileLikelihood(op, X, z, lanczos_steps=64,
                                      num_probes=16)
        setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = eng.fit()
        out.append({"step": "krylov_setup_n100k_k64_p16",
                    "use_pallas": use, "seconds": setup,
                    "fit_seconds": time.perf_counter() - t0,
                    "eta": float(res["eta"])})

    B, k = 8, 32
    dt = jnp.float32
    AB = jnp.asarray(np.concatenate(
        [z[:, None], X, rng.standard_normal((n, 1)),
         rng.choice([-1.0, 1.0], (n, 8))], axis=1), dt)
    rhos = jnp.asarray(np.geomspace(0.05, 0.2, B), dt)
    nus = jnp.full((B,), 0.5, dt)
    for use in (True, False):
        args = (jnp.asarray(pts, dt), rhos, nus, AB, k, X.shape[1] + 1,
                0.5, use, 1024)
        jax.block_until_ready(_factorize_chunk_matrixfree(*args))
        t0 = time.perf_counter()
        jax.block_until_ready(_factorize_chunk_matrixfree(*args))
        out.append({"step": "grid_chunk_n100k_B8_k32", "use_pallas": use,
                    "seconds": time.perf_counter() - t0})

    for side in sides:
        pts = data_utils.generate_points(side, dimension=2)
        z = data_utils.generate_data(pts, 0.2)
        X = data_utils.generate_basis_functions(pts, 2)
        for use in (True, False):
            op = taper.TaperedMaternOperator(pts, 0.005, nu=0.5,
                                             density=1e-3, use_pallas=use)
            KrylovProfileLikelihood(op, X, z, lanczos_steps=64,
                                    num_probes=16)
            t0 = time.perf_counter()
            eng = KrylovProfileLikelihood(op, X, z, lanczos_steps=64,
                                          num_probes=16)
            setup = time.perf_counter() - t0
            res = eng.fit()
            out.append({"step": f"taper_setup_n{side * side}_k64_p16",
                        "use_pallas": use, "seconds": setup,
                        "eta": float(res["eta"])})
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--e2e", action="store_true")
    p.add_argument("--skip-cases", action="store_true",
                   help="skip the per-kernel check + timing cases")
    p.add_argument("--sweep", action="store_true",
                   help="matern_matmat over tile products and tile sizes")
    p.add_argument("--tiles", default=None,
                   help="sweep tiles as ROWSxCOLSxWARPS,... (default: "
                   + ",".join("x".join(map(str, t)) for t in SWEEP_TILES)
                   + ")")
    p.add_argument("--surface", action="store_true",
                   help="the default n = 100k surface build first (its "
                   "peak device memory)")
    p.add_argument("--out", default="data/kernel_timings.json")
    a = p.parse_args()

    import jax

    from gppe_tpu.utils import config as cfg
    cfg.setup()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; found {dev.platform}")
    meta = {"card": card(), "device_kind": dev.device_kind}
    t_start = time.perf_counter()
    rows = []

    def report(row):
        row = {**row, **meta, "elapsed_s": time.perf_counter() - t_start}
        rows.append(row)
        print(json.dumps(row), flush=True)

    if a.surface:
        report(surface_case())
    if not a.skip_cases:
        report(dense_case())
        report(multirho_case())
        report(taper_case(256))
        report(taper_case(1024, check=False))
    if a.sweep:
        tiles = SWEEP_TILES if a.tiles is None else tuple(
            tuple(int(v) for v in t.split("x")) for t in a.tiles.split(","))
        for row in sweep_cases(tiles):
            report(row)
    if a.e2e:
        for row in e2e_cases():
            report(row)
    _os.makedirs(_os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
