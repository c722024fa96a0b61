"""BASELINE scorecard benchmark — incremental, deadline-bounded.

Headline (BASELINE.json north-star): profile log-likelihood derivative
evaluations/s at N=100k Matern points on one device, target >= 10/s.
The reference's own benchmark methodology
(examples/CompareVariousNumberOfPoints.py:241-280) times a
"pre-computation" phase (trace interpolation / eigendecomposition)
separately from the "maximize likelihood" phase; the numbers here follow
the same split, and every timed phase is reported {cold, warm}
(cold includes XLA/Pallas compilation — real work on a fresh machine but
not the steady-state cost; warm is the honest number for comparing
against the reference's purely numerical timings).

Survivability contract (round-5 redesign — round 3 lost every metric to
an environment timeout, round 4 completed but overran its own budget
and its 3 KB final aggregate line was clipped by the driver's 2000-char
tail window to ``parsed: null``):

* every metric is printed as its OWN flushed JSON line the moment its
  section finishes — a harness that captures the output tail gets
  everything completed so far even if the process is killed mid-run;
* the LAST stdout line is a COMPACT (~300 char) headline object — the
  BASELINE north-star metric, no embedded lists — so the driver's tail
  capture always parses it; the full aggregate (all metrics) is the
  second-to-last line;
* the CORE section estimates sum to <= 1000 s against the 1200 s
  budget (env ``GPPE_BENCH_BUDGET_S``), every section after the first
  is gated on its FULL estimate, and OPTIONAL sections run only when
  the core plan finished far enough under budget to fit theirs;
* a watchdog thread backstops a blocked XLA compile: past
  budget+grace it prints the aggregate + compact headline and exits 0;
* any section that raises makes the exit code non-zero (after the
  aggregate and headline are printed);
* the dense-Cholesky HMC moment anchor runs SECOND (it ran last and
  was cut by the timeout/watchdog in every previous round).

Scorecard contents:

* N=100k Krylov setup cold/warm + evals/s (BASELINE row 1) — headline;
* dense-Cholesky HMC anchor at n=900 (8 chains, 50+50 chunked steps)
  + moment cross-check against the amortized surface target;
* tapered-sparse totals at N=2^16/2^18/2^20 vs the reference's
  28 / 485 / 10,032 s — measured LIVE, slope refit from fresh rows;
* EXACT (FFT grid operator) 2^20 totals at nu=0.5 and general nu=2.2;
* achieved TFLOP/s of the Matern matvec at N=100k measured inside a
  jitted dependent chain (the cost Lanczos actually pays);
* matrix-free grid-batched Krylov: amortized setup s/point at n=100k;
* optional: large-N posterior samples/s (BASELINE config 5), the
  reference's N=4096 config, and the n=900 64-chain surface row.
"""

import functools
import json
import os
import sys
import threading
import time
import traceback

import numpy as np

_REPO = os.path.dirname(os.path.abspath(__file__))
_T0 = time.monotonic()
_BUDGET_S = float(os.environ.get("GPPE_BENCH_BUDGET_S", "1200"))
_WATCHDOG_GRACE_S = 45.0

_EMITTED = []
_LOCK = threading.Lock()


def _elapsed():
    return time.monotonic() - _T0


def _remaining():
    return _BUDGET_S - _elapsed()


def emit(metric):
    """Print one metric as its own JSON line, immediately flushed, and
    remember it for the final aggregate."""
    with _LOCK:
        _EMITTED.append(metric)
        print(json.dumps(metric), flush=True)


def _headline(state, truncated=False):
    """The COMPACT final line: the headline metric alone, no embedded
    metrics list. Round 3 lost the artifact to a timeout and round 4 to
    this very line growing past the driver's 2000-char tail window (the
    aggregate embedded all 12 metrics, ~3 KB, and the headline fields at
    its front were clipped out). The full aggregate goes to stdout as the
    SECOND-to-last line; the last line stays under ~300 chars."""
    head = state.get("head") or {}
    evals_per_s = head.get("evals_per_s", 0.0)
    return {
        "metric": "profile_loglik_derivative_evals_per_s_n100k",
        "value": round(evals_per_s, 2),
        "unit": "evals/s",
        "vs_baseline": round(evals_per_s / 10.0, 2),
        "source": "live" if head else "missing",
        "setup_warm_seconds": round(head.get("setup_warm_seconds", -1), 2),
        "eta_star": head.get("eta_star"),
        "n": 100_000,
        "wall_seconds": round(_elapsed(), 1),
        "truncated": bool(truncated),
    }


def _aggregate(state, truncated=False):
    """Full aggregate: every emitted metric + headline context, printed
    as the second-to-last stdout line (NOT last — see _headline)."""
    out = dict(_headline(state, truncated))
    out["metrics"] = list(_EMITTED)
    if state.get("errors"):
        out["errors"] = {k: v.splitlines()[-1]
                         for k, v in state["errors"].items()}
    return out


def _finish(state, truncated=False):
    agg = _aggregate(state, truncated=truncated)
    print(json.dumps(agg), flush=True)
    print(json.dumps(_headline(state, truncated)), flush=True)


def _start_watchdog(state):
    """Hard backstop: if a native call (XLA compile / device dispatch)
    blocks past the budget, print the aggregate-so-far and exit 0 —
    between-section checks cannot interrupt a blocked compile, and a
    SIGALRM handler would not run until the native call returns."""
    def _fire():
        emit({"metric": "bench_truncated", "value": round(_elapsed(), 1),
              "unit": "s",
              "vs_baseline": None,
              "note": f"watchdog: budget {_BUDGET_S:.0f}s exceeded "
                      f"mid-section; aggregate holds completed metrics"})
        _finish(state, truncated=True)
        os._exit(0)

    t = threading.Timer(max(_BUDGET_S + _WATCHDOG_GRACE_S - _elapsed(), 1.0),
                        _fire)
    t.daemon = True
    t.start()
    return t


# ---------------------------------------------------------------------------
# sections
# ---------------------------------------------------------------------------


def sec_der1_n100k(state):
    from gppe_tpu.models.large_scale import KrylovProfileLikelihood
    from gppe_tpu.ops import operators
    from gppe_tpu.utils import data as data_utils

    n = 100_000
    rng = np.random.RandomState(7)
    pts = rng.rand(n, 2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)

    op = operators.MaternOperator(pts, 0.1, nu=0.5)

    t0 = time.perf_counter()
    eng = KrylovProfileLikelihood(op, X, z, lanczos_steps=64,
                                  num_probes=16)
    setup_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = KrylovProfileLikelihood(op, X, z, lanczos_steps=64,
                                  num_probes=16)
    setup_warm = time.perf_counter() - t0

    # warm + measure the per-eta evaluation rate (the optimizer's inner
    # loop cost)
    eng.der1(1.0)
    n_evals = 100
    t0 = time.perf_counter()
    for i in range(n_evals):
        eng.der1(0.5 + 2.0 * (i / n_evals))
    eval_s = (time.perf_counter() - t0) / n_evals

    t0 = time.perf_counter()
    res = eng.fit()
    fit_s = time.perf_counter() - t0
    head = {
        "evals_per_s": 1.0 / eval_s,
        "setup_cold_seconds": setup_cold,
        "setup_warm_seconds": setup_warm,
        "fit_seconds": fit_s,
        "eta_star": res["eta"],
        "sigma0": res["sigma0"],
    }
    state["head"] = head
    emit({"metric": "profile_loglik_derivative_evals_per_s_n100k",
          "value": round(head["evals_per_s"], 2), "unit": "evals/s",
          # BASELINE.json target: >= 10 evals/s at N=100k
          "vs_baseline": round(head["evals_per_s"] / 10.0, 2),
          "eta_star": round(float(res["eta"]), 3),
          "sigma0": round(float(res["sigma0"]), 5)})
    # no same-N reference number exists; the reference's largest DENSE
    # precompute is 35.5 s at N=4096 — vs_baseline is that number over
    # this 24x-larger problem's setup (>1 = faster than the reference
    # was at 1/24 the size). Warm is the steady-state comparison; cold
    # additionally pays XLA/Pallas compilation.
    emit({"metric": "krylov_setup_warm_seconds_n100k",
          "value": round(setup_warm, 2), "unit": "s",
          "vs_baseline": round(35.5 / setup_warm, 2)})
    emit({"metric": "krylov_setup_cold_seconds_n100k",
          "value": round(setup_cold, 2), "unit": "s",
          "vs_baseline": round(35.5 / setup_cold, 2)})


def sec_n4096(state):
    """The reference's dense benchmark config: N=4096 (64x64 2-D grid),
    rho=0.1, nu=0.5, derivative method. Reference totals: 35.5 s
    precompute + 37.0 s root-find = 72.5 s (real numerical work on its
    CPU — compare against our WARM total; the cold total additionally
    carries XLA compilation, reported separately)."""
    from gppe_tpu.models.large_scale import KrylovProfileLikelihood
    from gppe_tpu.ops import operators
    from gppe_tpu.utils import data as data_utils

    pts = data_utils.generate_points(64, dimension=2)   # N = 4096
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    op = operators.MaternOperator(pts, 0.1, nu=0.5)

    def once():
        t0 = time.perf_counter()
        eng = KrylovProfileLikelihood(op, X, z, lanczos_steps=48,
                                      num_probes=16)
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = eng.fit()
        return setup_s, time.perf_counter() - t0, res

    setup_cold, fit_cold, res = once()
    setup_warm, fit_warm, res = once()
    # reference total at the same config: 72.5 s
    # (data/VariousNumberOfPoints-dense.pickle); >1 = speedup
    emit({"metric": "derivative_method_total_warm_seconds_n4096",
          "value": round(setup_warm + fit_warm, 2), "unit": "s",
          "vs_baseline": round(72.5 / (setup_warm + fit_warm), 2),
          "eta_star": round(float(res["eta"]), 3)})
    emit({"metric": "derivative_method_total_cold_seconds_n4096",
          "value": round(setup_cold + fit_cold, 2), "unit": "s",
          "vs_baseline": round(72.5 / (setup_cold + fit_cold), 2)})


def sec_hmc_anchor_n900(state):
    """Dense-Cholesky HMC anchor + surface cross-check at n=900 — run
    EARLY (VERDICT r4 missing #3: this moment cross-check ran last and
    was cut by timeout/watchdog in every previous round, so it has never
    produced a driver-captured number).

    Both samplers target the same flat-in-log10 posterior over the same
    support box; the dense target is the exact per-leapfrog Cholesky
    likelihood, the surface target the amortized Krylov approximation —
    their posterior moments must agree to the surface's sub-nat lp
    error. 50+50 steps x 8 chains suffice for a ~0.1-decade moment
    comparison; chunk_steps keeps each device program short."""
    import jax

    from gppe_tpu.models import hmc
    from gppe_tpu.models.krylov_posterior import KrylovPosteriorSurface
    from gppe_tpu.utils import data as data_utils

    pts = data_utils.generate_points(30, dimension=2)       # n = 900
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    support = ((-3.0, 4.0), (-1.5, -0.5))

    # dense-Cholesky target (the exact anchor), chunked
    kwargs = dict(nu=0.5, num_chains=8, num_samples=50, num_warmup=50,
                  key=0, log_prior=None, support_log10=support,
                  chunk_steps=25)
    res_d = hmc.sample_posterior(pts, z, X, **kwargs)
    jax.block_until_ready(res_d.samples)                 # compile + warm
    t0 = time.perf_counter()
    res_d = hmc.sample_posterior(pts, z, X, **kwargs)
    jax.block_until_ready(res_d.samples)
    wall = time.perf_counter() - t0
    sd = np.asarray(res_d.samples).reshape(-1, 2)
    emit({"metric": "hmc_samples_per_s_n900_1chip_dense_c8",
          "value": round(8 * 50 / wall, 2), "unit": "samples/s",
          "vs_baseline": None,
          "accept_rate": round(float(np.mean(
              np.asarray(res_d.accept_rate))), 3),
          "log10_eta_mean": round(float(sd[:, 0].mean()), 3)})

    # surface target over the SAME box, same budget
    surface = KrylovPosteriorSurface(pts, z, X, nu=0.5,
                                     log10_rho_bounds=(-1.5, -0.5))
    res_s, _ = hmc.sample_posterior_large(
        pts, z, X, nu=0.5, num_chains=8, num_samples=50, num_warmup=50,
        key=0, surface=surface, log10_eta_bounds=(-3.0, 4.0))
    jax.block_until_ready(res_s.samples)
    ss = np.asarray(res_s.samples).reshape(-1, 2)
    diff = abs(float(sd[:, 0].mean()) - float(ss[:, 0].mean()))
    # the moment cross-check number itself (BASELINE posterior-moment
    # correctness clause): dense-exact vs amortized-surface posterior
    # mean of log10(eta) — must agree within the posterior's own spread
    emit({"metric": "hmc_dense_vs_surface_log10eta_absdiff_n900",
          "value": round(diff, 3), "unit": "decades",
          "vs_baseline": None,
          "dense_mean": round(float(sd[:, 0].mean()), 3),
          "surface_mean": round(float(ss[:, 0].mean()), 3),
          "dense_std": round(float(sd[:, 0].std()), 3),
          "surface_std": round(float(ss[:, 0].std()), 3)})
    state["surface_n900"] = (pts, z, X, surface)


def sec_sparse_live(state):
    """Tapered-sparse totals vs the reference's sparse race, measured
    LIVE (driver-verifiable): grid points, rho=0.005, nu=0.5, tapered
    block-sparse operator, derivative method — the settings of reference
    CompareVariousNumberOfPoints.py:243-248. One repetition per N (r4
    ran 2 at the small sizes; the r5 budget discipline trades the median
    for fitting the whole plan inside the budget), slope refit from the
    fresh rows."""
    import drivers.compare_various_num_points as cvnp

    ref = {65536: 28.0, 262144: 485.0, 1048576: 10032.0}
    plan = [(65536, 60.0), (262144, 70.0), (1048576, 120.0)]
    live_ns, live_mins = [], []
    for n, est in plan:
        if _remaining() < est:
            emit({"metric": f"bench_skipped_sparse_n{n}",
                  "value": round(_remaining(), 1), "unit": "s-remaining",
                  "vs_baseline": None,
                  "note": f"budget cannot fit ~{est:.0f}s section"})
            continue
        r = cvnp.run_krylov(n, scale=0.005, density=1e-3, grid=True)
        total = r["pre_s"] + r["opt_s"]
        live_ns.append(n)
        live_mins.append(total)
        emit({"metric": f"sparse_derivative_total_seconds_n{n}",
              "value": round(total, 2), "unit": "s",
              "vs_baseline": round(ref[n] / total, 1),
              "reps": 1, "source": "live",
              "eta_star": round(float(r["eta"]), 3)})
    if len(live_ns) >= 2:
        slope = cvnp.log_regression(live_ns, live_mins)
        emit({"metric": "sparse_scaling_slope_live",
              "value": round(slope, 2), "unit": "log-log slope",
              # reference sparse path fits ~2.1 over the same three N
              # (28 / 485 / 10032 s); lower = better scaling
              "vs_baseline": None, "ns": live_ns})


def sec_fft_exact(state):
    """EXACT (untapered) derivative method at 2^20 via the FFT grid
    operator (r4): the reference's 10,032 s number is a TAPERED
    APPROXIMATION — this is the exact answer, at any nu, in O(n log n)
    per matvec. The closed-form and a general (Bessel) nu both run."""
    import jax

    from gppe_tpu.models.large_scale import KrylovProfileLikelihood
    from gppe_tpu.ops import operators
    from gppe_tpu.utils import data as data_utils

    # the 2^20 Lanczos basis plus its reorthogonalization temporaries
    # need most of HBM; earlier sections' cached executables pin their
    # bound constants — drop them (the persistent compile cache reloads
    # later shapes from disk in seconds), collect, and keep the basis
    # at (48, 2^20, 20) ~ 3.8 GB (k=64/p=16 was 6.4 GB and the r5
    # shakeout OOM'd here, poisoning every subsequent section).
    import gc

    pts = data_utils.generate_points(1024, dimension=2)     # n = 2^20
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    r = None
    for nu, ref_s in ((0.5, 10032.0), (2.2, None)):
        del r
        gc.collect()
        jax.clear_caches()
        t0 = time.perf_counter()
        op = operators.GridMaternOperator(pts, 0.005, nu=nu)
        eng = KrylovProfileLikelihood(op, X, z, lanczos_steps=48,
                                      num_probes=12)
        r = eng.fit()
        total = time.perf_counter() - t0
        emit({"metric": f"fft_exact_derivative_total_seconds_n1048576_nu{nu}",
              "value": round(total, 2), "unit": "s",
              # vs the reference's TAPERED total at the same config —
              # ours is the exact kernel
              "vs_baseline": (round(ref_s / total, 1) if ref_s else None),
              "eta_star": round(float(r["eta"]), 3),
              "exact": True})


def sec_pallas_matvec(state):
    """Achieved FLOP/s of the Matern matvec at N=100k (fused kernel
    where ops.pallas_kernels.use_fused_kernel picks it), steady state
    measured INSIDE a jitted dependent chain — the cost Lanczos actually
    pays. FLOPs are the logical 2 n^2 (r + d + 4), unpadded."""
    import jax
    import jax.numpy as jnp

    from gppe_tpu.ops import operators

    n, r, d = 100_000, 23, 2
    rng = np.random.RandomState(3)
    pts = rng.rand(n, 2)
    V = np.asarray(rng.standard_normal((n, r)), np.float32)
    op = operators.MaternOperator(pts, 0.1, nu=0.5)

    @functools.partial(jax.jit, static_argnames=("k",))
    def chain(V, k):
        def body(j, V):
            W = op.matmat(V)
            return W / jnp.linalg.norm(W, axis=0)
        return jax.lax.fori_loop(0, k, body, V)

    jax.block_until_ready(chain(V, 4))             # compile + warm
    reps = 30
    t0 = time.perf_counter()
    jax.block_until_ready(chain(V, reps))
    secs = (time.perf_counter() - t0) / reps

    flops = 2 * n * n * (r + d + 4)
    dev = jax.devices()[0]
    emit({"metric": "matern_matvec_tflops_n100k",
          "value": flops / secs / 1e12, "unit": "TFLOP/s",
          "vs_baseline": None, "seconds": secs,
          "pallas": bool(op.use_pallas),
          "device": {"platform": dev.platform, "kind": dev.device_kind}})


def sec_grid_krylov(state, num_points=8):
    """Matrix-free grid-batched Krylov at n=100k: amortized setup
    seconds/point over one multi-rho chunk (the reference rebuilds its
    whole precompute per grid point).

    k = 32: the matvec dominates each Lanczos step (reorthogonalization
    and the f64 sums are small beside it), so steps are the only
    random-points lever; the structured-grid FFT chunk below is the real
    fix and is reported alongside."""
    from gppe_tpu.models.grid_krylov import GridKrylovProfileLikelihood
    from gppe_tpu.utils import data as data_utils

    n = 100_000
    rng = np.random.RandomState(7)
    pts = rng.rand(n, 2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)
    rhos = np.linspace(0.05, 0.3, num_points)
    nus = np.full(num_points, 0.5)

    t0 = time.perf_counter()
    g = GridKrylovProfileLikelihood(pts, X, z, rhos, nus, nu_static=0.5,
                                    lanczos_steps=32, num_probes=8,
                                    matrix_free=True, chunk=num_points)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = g.fit_all()
    fit_s = time.perf_counter() - t0
    best = max(results, key=lambda r: r["lp"])
    head = state.get("head") or {}
    warm = head.get("setup_warm_seconds", -1)
    emit({"metric": "grid_krylov_setup_s_per_point_n100k",
          "value": round(setup_s / num_points, 2), "unit": "s",
          # the reference pays a full fresh precompute per grid point;
          # our single-point N=100k setup (warm) is the self-baseline
          "vs_baseline": (round(warm / (setup_s / num_points), 2)
                          if warm > 0 else None),
          "points": num_points, "fit_all_seconds": round(fit_s, 2),
          "best_rho": round(float(best["rho"]), 4)})

    # structured-grid variant: batched circulant-FFT factorization —
    # O(n log n) per node at ANY nu (every reference benchmark config
    # is a regular grid). Same engine the (rho, nu) posterior surface
    # uses (models.krylov_posterior._factorize_fft_chunk).
    if _remaining() < 60.0:
        emit({"metric": "bench_skipped_grid_fft",
              "value": round(_remaining(), 1), "unit": "s-remaining",
              "vs_baseline": None})
        return
    import jax.numpy as jnp

    from gppe_tpu.models.krylov_posterior import _factorize_fft_chunk
    from gppe_tpu.ops import operators as ops_operators

    pts_g = data_utils.generate_points(317, dimension=2)   # n = 100489
    z_g = data_utils.generate_data(pts_g, 0.2)
    X_g = data_utils.generate_basis_functions(pts_g, 2)
    ms, hs, to_r, from_r = ops_operators.grid_geometry(pts_g)
    base = ops_operators.grid_distance_table(ms, hs, 1.0)
    from gppe_tpu.ops import kernels as ops_kernels
    k_tabs = np.stack([np.asarray(ops_kernels.matern(
        jnp.asarray(base / r), 0.5)) for r in rhos])
    chat_b = ops_operators.circulant_rfft(
        k_tabs.astype(np.float32), ms, jnp.float32)
    tk2 = ops_operators.grid_trace_pow2(k_tabs, ms)
    A = np.concatenate([z_g[:, None], X_g], axis=1)
    rng2 = np.random.RandomState(1)
    AB = jnp.asarray(np.concatenate(
        [A, rng2.standard_normal((A.shape[0], 1)),
         rng2.choice([-1.0, 1.0], size=(A.shape[0], 8))],
        axis=1), jnp.float32)
    s = A.shape[1]
    args = (chat_b, jnp.asarray(to_r), jnp.asarray(from_r),
            jnp.asarray(tk2, jnp.float32), AB, 32, s, ms)
    import jax
    jax.block_until_ready(_factorize_fft_chunk(*args))   # compile+warm
    t0 = time.perf_counter()
    out = _factorize_fft_chunk(*args)
    jax.block_until_ready(out)
    fft_s = time.perf_counter() - t0
    emit({"metric": "grid_fft_setup_s_per_point_n100k",
          "value": round(fft_s / num_points, 2), "unit": "s",
          "vs_baseline": (round(warm / (fft_s / num_points), 2)
                          if warm > 0 else None),
          "points": num_points, "exact": True,
          "note": "structured grid, any nu (circulant-FFT matvecs)"})


def sec_posterior_large(state, num_chains=64, num_samples=200,
                        num_warmup=100):
    """Large-N posterior sampling (BASELINE config 5): HMC over
    (log10 eta, log10 rho) at N=100k on the amortized matrix-free Krylov
    surface — all O(n) work in setup, per-leapfrog cost independent of
    n (models.krylov_posterior)."""
    import jax

    from gppe_tpu.models import hmc
    from gppe_tpu.utils import data as data_utils

    n = 100_000
    rng = np.random.RandomState(7)
    pts = rng.rand(n, 2)
    z = data_utils.generate_data(pts, 0.2)
    X = data_utils.generate_basis_functions(pts, 2)

    # surface construction holds a multi-GB Lanczos basis; free earlier
    # sections' pinned executables first (see sec_fft_exact)
    import gc
    gc.collect()
    jax.clear_caches()

    t0 = time.perf_counter()
    res, surface = hmc.sample_posterior_large(
        pts, z, X, nu=0.5, num_chains=num_chains, num_samples=1,
        num_warmup=0, key=0)
    jax.block_until_ready(res.samples)
    setup_s = time.perf_counter() - t0          # surface + first compile

    t0 = time.perf_counter()
    res, _ = hmc.sample_posterior_large(
        pts, z, X, nu=0.5, num_chains=num_chains,
        num_samples=num_samples, num_warmup=num_warmup, key=0,
        surface=surface)
    jax.block_until_ready(res.samples)
    wall = time.perf_counter() - t0
    s = np.asarray(res.samples).reshape(-1, 2)
    emit({"metric": "posterior_samples_per_s_n100k_64chains",
          "value": round(num_chains * num_samples / wall, 2),
          "unit": "samples/s",
          # BASELINE config 5: unreachable for the reference (its outer
          # loop rebuilds an O(n^3) precompute per point)
          "vs_baseline": None,
          "setup_seconds": round(setup_s, 2),
          "accept_rate": round(float(np.mean(
              np.asarray(res.accept_rate))), 3),
          "log10_eta_mean": round(float(s[:, 0].mean()), 3),
          "log10_rho_mean": round(float(s[:, 1].mean()), 3)})


def sec_hmc_n900_c64(state, num_samples=100, num_warmup=100):
    """HMC samples/s at the reference config n=900, 64 chains on the
    amortized Krylov surface (BASELINE row 3's one-chip column). Reuses
    the surface sec_hmc_anchor_n900 built. num_samples is a static scan
    length, so the compile warm-up runs the SAME shapes: run twice,
    time the second.

    NOTE the 1-chip ring-vs-allgather metric of rounds 3-4 is GONE by
    design: on one device both schedules lower to the identical
    computation (nothing crosses devices), so the delta measured
    nothing. The schedule comparison lives in
    data/scaling_virtual_mesh.json (virtual 8-device CPU mesh,
    drivers/scaling_efficiency.py) and `chip_smoke.py --multi`."""
    import jax

    from gppe_tpu.models import hmc
    from gppe_tpu.models.krylov_posterior import KrylovPosteriorSurface
    from gppe_tpu.utils import data as data_utils

    if "surface_n900" in state:
        pts, z, X, surface = state["surface_n900"]
    else:
        pts = data_utils.generate_points(30, dimension=2)
        z = data_utils.generate_data(pts, 0.2)
        X = data_utils.generate_basis_functions(pts, 2)
        surface = KrylovPosteriorSurface(pts, z, X, nu=0.5,
                                         log10_rho_bounds=(-1.5, -0.5))

    kwargs = dict(nu=0.5, num_chains=64, num_samples=num_samples,
                  num_warmup=num_warmup, key=0, surface=surface,
                  log10_eta_bounds=(-3.0, 4.0))
    res, _ = hmc.sample_posterior_large(pts, z, X, **kwargs)
    jax.block_until_ready(res.samples)                # compile + warm
    t0 = time.perf_counter()
    res, _ = hmc.sample_posterior_large(pts, z, X, **kwargs)
    jax.block_until_ready(res.samples)
    wall = time.perf_counter() - t0
    s = np.asarray(res.samples).reshape(-1, 2)
    emit({"metric": "hmc_samples_per_s_n900_1chip_c64",
          "value": round(64 * num_samples / wall, 2),
          "unit": "samples/s",
          # BASELINE row 3: "measured" — no reference number exists
          "vs_baseline": None,
          "accept_rate": round(float(np.mean(
              np.asarray(res.accept_rate))), 3),
          "log10_eta_mean": round(float(s[:, 0].mean()), 3)})


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

# (name, worst-case estimate s with a COLD compile cache, fn).
#
# Budget discipline (VERDICT r4 next-1b, third attempt at a clean
# artifact): the CORE estimates sum to <= 1000 s against the 1200 s
# default budget — the whole plan fits even fully cold — and every
# section after the first is gated on its FULL estimate (r4 gated on
# half, which let sections start that could not finish and ran the
# bench into its own watchdog). The dense-HMC anchor runs SECOND (it
# ran last and was cut in every previous round). OPTIONAL sections are
# pure upside: they run only when the core plan came in far enough
# under budget to fit their full estimate too.
CORE_SECTIONS = [
    ("der1_n100k", 350.0, sec_der1_n100k),        # headline: always runs
    ("hmc_anchor_n900", 150.0, sec_hmc_anchor_n900),
    ("sparse_live", 250.0, sec_sparse_live),       # internal per-N checks
    ("fft_exact", 100.0, sec_fft_exact),
    ("pallas_matvec", 60.0, sec_pallas_matvec),
    ("grid_krylov", 90.0, sec_grid_krylov),
]                                                  # sum = 1000 s

# Optional estimates are WORST-CASE values — optional sections must
# skip cleanly on slow days, not gamble the budget.
OPTIONAL_SECTIONS = [
    ("posterior_large", 500.0, sec_posterior_large),  # BASELINE config 5
    ("n4096", 130.0, sec_n4096),
    ("hmc_n900_c64", 220.0, sec_hmc_n900_c64),
]


def main():
    from gppe_tpu.utils import config as cfg
    cfg.setup()

    state = {"errors": {}}
    _start_watchdog(state)

    truncated = False
    for i, (name, est, fn) in enumerate(CORE_SECTIONS + OPTIONAL_SECTIONS):
        if i > 0 and _remaining() < est:
            emit({"metric": f"bench_skipped_{name}",
                  "value": round(_remaining(), 1), "unit": "s-remaining",
                  "vs_baseline": None,
                  "note": f"budget cannot fit ~{est:.0f}s section"})
            continue
        try:
            fn(state)
        except Exception:
            tb = traceback.format_exc(limit=3)
            state["errors"][name] = tb
            emit({"metric": f"bench_error_{name}", "value": None,
                  "unit": None, "vs_baseline": None,
                  "error": tb.splitlines()[-1]})

    _finish(state, truncated=truncated)
    if state["errors"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
