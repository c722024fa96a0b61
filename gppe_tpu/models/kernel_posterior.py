"""Posterior / likelihood over the *outer* kernel hyperparameters.

The reference's outer loop evaluates, for each (rho, nu), the profile
likelihood at the inner-optimal (sigma, sigma0)
(reference: examples/FindOptimalCovarianceParameters.py:87-199 —
PartialLikelihoodFunction), optionally times a prior, on a process pool.

Redesign: ``profile_loglik(log10_eta, log10_rho)`` is one
jittable, differentiable pipeline — fused Matern assembly, Cholesky
factorization, batched triangular solves, profiled sigma^2 = zMz/(n-m) —
so outer grids, global optimizers and HMC chains are *vmapped batches of
Cholesky factorizations on the device* instead of process pools. Gradients
for HMC come from autodiff through the whole pipeline (Cholesky has
stable derivatives, unlike eigh on clustered spectra).
"""

from functools import partial

import jax
import jax.numpy as jnp

from ..ops import kernels


def make_profile_loglik(points, z, X, nu=0.5, dtype=None):
    """Returns jittable lp(log10_eta, log10_rho) — the profile REML
    log-likelihood with sigma profiled out (identities of reference
    _profile_likelihood.py:38-85, 259-275), as a pure function of the
    outer hyperparameters.

    All consts are closed over as device arrays; nu must be static
    (closed-form branch)."""
    from ..utils.config import compute_dtype
    dtype = dtype or compute_dtype()
    pts = jnp.asarray(points, dtype=dtype)
    z_ = jnp.asarray(z, dtype=dtype)
    X_ = jnp.asarray(X, dtype=dtype)
    n, m = X_.shape

    def lp(log10_eta, log10_rho):
        # full-f32 matmul accumulation: a reduced-precision (bf16/TF32)
        # product puts O(1) noise on the log-likelihood — enough to wreck
        # HMC/NUTS energy differences (measured: single-transition accept
        # 0.14 vs 0.99). HIGHEST is required.
        with jax.default_matmul_precision("highest"):
            eta = jnp.power(10.0, jnp.asarray(log10_eta, dtype))
            rho = jnp.power(10.0, jnp.asarray(log10_rho, dtype))
            dist = kernels.pairwise_scaled_distance(pts, pts, rho)
            K = kernels.matern(dist, nu)
            Kn = K + eta * jnp.eye(n, dtype=dtype)
            L = jnp.linalg.cholesky(Kn)
            rhs = jnp.concatenate([z_[:, None], X_], axis=1)
            W = jax.scipy.linalg.cho_solve((L, True), rhs)
            w = W[:, 0]
            Y = W[:, 1:]
            B = X_.T @ Y
            LB = jnp.linalg.cholesky(0.5 * (B + B.T))
            logdet_B = 2.0 * jnp.sum(jnp.log(jnp.diagonal(LB)))
            c = jax.scipy.linalg.cho_solve((LB, True), X_.T @ w)
            zMz = z_ @ w - (X_.T @ w) @ c
            sigma2 = zMz / (n - m)
            logdet_Kn = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
            # profile lp at sigma^2 = zMz/(n-m): the data term collapses
            # to (n-m)/2
            return (-0.5 * (n - m) * jnp.log(sigma2) - 0.5 * logdet_Kn
                    - 0.5 * logdet_B - 0.5 * (n - m))

    return lp


def make_profile_loglik_nu(points, z, X, dtype=None,
                           unique_distances=None):
    """Jittable lp(log10_eta, log10_rho, nu) with ``nu`` TRACED through
    the from-scratch Bessel K_nu (ops.special — Temme series + Steed CF2),
    so autodiff gradients flow through the kernel-order parameter too.

    The third coordinate the reference's flagship sweep showed matters:
    its MAP analysis moves nu from the bound 25 to 3.03
    (reference examples/FindOptimalCovarianceParameters.py:119-146,664-666;
    golden data/OptimalCovariance_WithPrior.pickle). Same Cholesky
    pipeline as :func:`make_profile_loglik` (stable derivatives, unlike
    eigh on the clustered spectra general-nu kernels have).

    ``unique_distances`` (default auto): the Bessel branch costs ~200
    fixed-trip iterations per element — the expensive part of the whole
    surface. On a structured m x m grid (every reference config) the n^2
    pairwise distances take only O(n) distinct values (59^2 offsets at
    n = 900), so K_nu is evaluated on the UNIQUE distance set and
    gathered back: ~230x fewer transcendental loops per evaluation, and
    the gather is autodiff-transparent. Auto-enables when the unique set
    is < 5% of n^2; random point sets keep the dense path."""
    import numpy as np

    from ..utils.config import compute_dtype
    dtype = dtype or compute_dtype()
    pts = jnp.asarray(points, dtype=dtype)
    z_ = jnp.asarray(z, dtype=dtype)
    X_ = jnp.asarray(X, dtype=dtype)
    n, m = X_.shape

    pts_np = np.asarray(points, dtype=np.float64)
    diff = pts_np[:, None, :] - pts_np[None, :, :]
    r0 = np.sqrt((diff * diff).sum(-1))
    uniq, inv = np.unique(np.round(r0, 10), return_inverse=True)
    if unique_distances is None:
        unique_distances = uniq.size < 0.05 * n * n
    if unique_distances:
        uniq_d = jnp.asarray(uniq, dtype=dtype)
        inv_d = jnp.asarray(inv.reshape(n, n).astype(np.int32))
    else:
        r0_d = jnp.asarray(r0, dtype=dtype)

    def lp(log10_eta, log10_rho, nu):
        with jax.default_matmul_precision("highest"):
            eta = jnp.power(10.0, jnp.asarray(log10_eta, dtype))
            rho = jnp.power(10.0, jnp.asarray(log10_rho, dtype))
            nu = jnp.asarray(nu, dtype)
            if unique_distances:
                k_uniq = kernels.matern(uniq_d / rho, nu)
                K = jnp.take(k_uniq, inv_d)
            else:
                K = kernels.matern(r0_d / rho, nu)  # traced-nu Bessel
            Kn = K + eta * jnp.eye(n, dtype=dtype)
            L = jnp.linalg.cholesky(Kn)
            rhs = jnp.concatenate([z_[:, None], X_], axis=1)
            W = jax.scipy.linalg.cho_solve((L, True), rhs)
            w = W[:, 0]
            Y = W[:, 1:]
            B = X_.T @ Y
            LB = jnp.linalg.cholesky(0.5 * (B + B.T))
            logdet_B = 2.0 * jnp.sum(jnp.log(jnp.diagonal(LB)))
            c = jax.scipy.linalg.cho_solve((LB, True), X_.T @ w)
            zMz = z_ @ w - (X_.T @ w) @ c
            sigma2 = zMz / (n - m)
            logdet_Kn = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
            return (-0.5 * (n - m) * jnp.log(sigma2) - 0.5 * logdet_Kn
                    - 0.5 * logdet_B - 0.5 * (n - m))

    return lp


def make_bounded_log_posterior_nu(points, z, X,
                                  log10_bounds=((-3.0, 4.0), (-2.0, 0.0)),
                                  nu_bounds=(1.0, 25.0), log_prior=None):
    """Posterior over theta = [log10_eta, log10_rho, nu] in unconstrained
    sigmoid coordinates (see :func:`make_bounded_log_posterior` for why
    HMC wants this form). ``nu`` is sampled in NATURAL units over
    ``nu_bounds`` (the reference sweep's [1, 25] range,
    FindOptimalCovarianceParameters.py:664-666); ``log_prior(eta, rho,
    nu)`` operates in natural parameters — the log10 change-of-variables
    Jacobian applies to eta and rho only. Returns (log_post_u,
    u_to_theta)."""
    lp = make_profile_loglik_nu(points, z, X)
    ln10 = jnp.log(10.0)

    def log_post_theta(theta):
        l_eta, l_rho, nu = theta[0], theta[1], theta[2]
        val = lp(l_eta, l_rho, nu)
        if log_prior is not None:
            eta = jnp.power(10.0, l_eta)
            rho = jnp.power(10.0, l_rho)
            val = val + log_prior(eta, rho, nu)
            val = val + (l_eta + l_rho) * ln10   # eta, rho only
        return val

    lo = jnp.asarray([log10_bounds[0][0], log10_bounds[1][0],
                      nu_bounds[0]], dtype=jnp.result_type(0.0))
    hi = jnp.asarray([log10_bounds[0][1], log10_bounds[1][1],
                      nu_bounds[1]], dtype=lo.dtype)
    margin = 1e-6

    def u_to_theta(u):
        s = margin + (1.0 - 2.0 * margin) * jax.nn.sigmoid(u)
        return lo + (hi - lo) * s

    def log_post_u(u):
        theta = u_to_theta(u)
        log_jac = jnp.sum(jnp.log(hi - lo) + jnp.log1p(-2.0 * margin)
                          + jax.nn.log_sigmoid(u) + jax.nn.log_sigmoid(-u))
        return log_post_theta(theta) + log_jac

    return log_post_u, u_to_theta


def make_profiled_rho_nu_posterior(points, z, X,
                                   log10_eta_bounds=(-3.0, 4.0),
                                   log10_rho_bounds=(-1.3, -0.3),
                                   nu_bounds=(1.0, 25.0),
                                   log_prior=None, eta_grid=29,
                                   golden_iters=22):
    """Posterior over (log10 rho, nu) on the ETA-PROFILED surface —
    the exact Bayesian counterpart of the reference's MAP sweep
    (examples/FindOptimalCovarianceParameters.py:632-702 evaluates
    Lp(rho, nu) = max_eta lp per grid point, then argmaxes).

    Why not the joint 3-coordinate posterior: at the golden config
    (n = 900, noise 0.2) the high-eta noise-only plateau sits only ~3
    nats below the narrow eta ~ 20 ridge but spans decades of eta x the
    whole (rho, nu) box — the JOINT posterior mass legitimately
    concentrates there (measured: chains equilibrate at
    log10 eta ~ 3.5, nu ~ 10). The profiled target maximizes eta out
    per (rho, nu) — a coarse grid + golden-section refinement inside
    the jitted target, autodiff flowing through the refined iterate
    (envelope: at the inner max the eta-partial vanishes) — so its mode
    IS the reference's MAP. Returns (log_post_u, u_to_theta) over
    unconstrained sigmoid coordinates, theta = [log10_rho, nu]."""
    lp3 = make_profile_loglik_nu(points, z, X)
    lo_e, hi_e = log10_eta_bounds
    gr = 0.5 * (jnp.sqrt(5.0) - 1.0)

    def _safe(v):
        # f32 Cholesky of the near-singular smooth-kernel Kn NaNs at the
        # small-eta end of the search grid (spectrum spans ~9 decades at
        # large nu); a NaN lane must lose the argmax and the golden
        # comparisons, not poison them — the inner optimum itself sits
        # at eta ~ 1-100 where the factorization is healthy
        return jnp.where(jnp.isnan(v), -jnp.inf, v)

    def lp_prof(l_rho, nu):
        grid = jnp.linspace(lo_e, hi_e, eta_grid)
        vals = _safe(jax.vmap(lambda le: lp3(le, l_rho, nu))(grid))
        i0 = jnp.argmax(vals)
        lo = grid[jnp.maximum(i0 - 1, 0)]
        hi = grid[jnp.minimum(i0 + 1, eta_grid - 1)]

        def golden(_, st):
            lo, hi = st
            x1 = hi - gr * (hi - lo)
            x2 = lo + gr * (hi - lo)
            f1 = _safe(lp3(x1, l_rho, nu))
            f2 = _safe(lp3(x2, l_rho, nu))
            lo = jnp.where(f1 > f2, lo, x1)
            hi = jnp.where(f1 > f2, x2, hi)
            return (lo, hi)

        lo, hi = jax.lax.fori_loop(0, golden_iters, golden, (lo, hi))
        return _safe(lp3(0.5 * (lo + hi), l_rho, nu))

    def log_post_theta(theta):
        l_rho, nu = theta[0], theta[1]
        val = lp_prof(l_rho, nu)
        if log_prior is not None:
            rho = jnp.power(10.0, l_rho)
            val = val + log_prior(rho, nu)
            val = val + l_rho * jnp.log(10.0)   # rho Jacobian only
        return val

    lo = jnp.asarray([log10_rho_bounds[0], nu_bounds[0]],
                     dtype=jnp.result_type(0.0))
    hi = jnp.asarray([log10_rho_bounds[1], nu_bounds[1]], dtype=lo.dtype)
    margin = 1e-6

    def u_to_theta(u):
        s = margin + (1.0 - 2.0 * margin) * jax.nn.sigmoid(u)
        return lo + (hi - lo) * s

    def log_post_u(u):
        theta = u_to_theta(u)
        log_jac = jnp.sum(jnp.log(hi - lo) + jnp.log1p(-2.0 * margin)
                          + jax.nn.log_sigmoid(u) + jax.nn.log_sigmoid(-u))
        return log_post_theta(theta) + log_jac

    return log_post_u, u_to_theta


def make_log_posterior(points, z, X, nu=0.5, log_prior=None):
    """lp + prior as a function of theta = [log10_eta, log10_rho].

    ``log_prior(eta, rho)`` operates in natural parameters; change of
    variables to log10 adds log(eta) + log(rho) + consts, included here.
    """
    lp = make_profile_loglik(points, z, X, nu=nu)
    ln10 = jnp.log(10.0)

    def log_post(theta):
        log10_eta, log10_rho = theta[0], theta[1]
        val = lp(log10_eta, log10_rho)
        if log_prior is not None:
            eta = jnp.power(10.0, log10_eta)
            rho = jnp.power(10.0, log10_rho)
            val = val + log_prior(eta, rho)
            # Jacobian of theta -> (eta, rho)
            val = val + (log10_eta + log10_rho) * ln10
        return val

    return log_post


def make_bounded_log_posterior(points, z, X, nu=0.5,
                               log10_bounds=((-3.0, 4.0), (-2.0, 0.0)),
                               log_prior=None):
    """Posterior over UNCONSTRAINED coordinates u for box-bounded
    hyperparameters: theta = lo + (hi-lo) * sigmoid(u) maps R^2 onto the
    log10 box, with the log-Jacobian included.

    Hard uniform-prior boundaries make HMC/NUTS leapfrog steps land on
    log p = -inf (registered as divergences, and they thrash the
    dual-averaging step size); sampling in u-space removes the boundary
    entirely. Returns (log_post_u, u_to_theta)."""
    log_post_theta = make_log_posterior(points, z, X, nu=nu,
                                        log_prior=log_prior)
    lo = jnp.asarray([b[0] for b in log10_bounds], dtype=jnp.result_type(0.0))
    hi = jnp.asarray([b[1] for b in log10_bounds], dtype=lo.dtype)
    # keep theta strictly INSIDE the box: a saturated sigmoid rounds theta
    # onto the edge and 10**theta can land epsilon outside a natural-
    # parameter prior bound (-inf -> spurious divergence)
    margin = 1e-6

    def u_to_theta(u):
        s = margin + (1.0 - 2.0 * margin) * jax.nn.sigmoid(u)
        return lo + (hi - lo) * s

    def log_post_u(u):
        theta = u_to_theta(u)
        log_jac = jnp.sum(jnp.log(hi - lo) + jnp.log1p(-2.0 * margin)
                          + jax.nn.log_sigmoid(u) + jax.nn.log_sigmoid(-u))
        return log_post_theta(theta) + log_jac

    return log_post_u, u_to_theta


@partial(jax.jit, static_argnames=("lp_fn",))
def grid_evaluate(lp_fn, log10_etas, log10_rhos):
    """Dense (eta, rho) grid of the profile likelihood as one vmapped
    batch (replaces the reference's multiprocessing pool grid,
    FindOptimalCovarianceParameters.py:632-702)."""
    f = jax.vmap(jax.vmap(lp_fn, in_axes=(None, 0)), in_axes=(0, None))
    return f(log10_etas, log10_rhos)
