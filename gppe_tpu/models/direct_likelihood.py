"""Direct (sigma, sigma0) restricted maximum-likelihood.

Re-derivation of the reference's DirectLikelihood suite
(reference: gaussian_proc/_likelihood/_direct_likelihood.py:25-405) in the
eigenbasis of K: with K = Q diag(lam) Q^T, every quantity in the REML
log-likelihood

    lp = -1/2 (n-m) log 2pi - 1/2 logdet(S) - 1/2 logdet(X^T S^-1 X)
         - 1/2 z^T M z,      S = sigma^2 K + sigma0^2 I

reduces to diagonal arithmetic on the *rotated* design Xt = Q^T X and data
zt = Q^T z. One O(n^3) eigendecomposition up front, then each likelihood /
gradient / Hessian evaluation costs O(n m) — no per-iteration n x n solve,
unlike the reference's call stack (SURVEY.md §3.1). Functions are pure and
jittable; derivatives for the optimizer come from autodiff, while the
reference's analytic identities (jacobian :89-157, hessian :163-270) are
also implemented for cross-validation.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.optimize import trust_region_minimize

_SIGMA_TOL = 1e-8


class SpectralData(NamedTuple):
    """Problem data rotated into the eigenbasis of K."""
    lam: jnp.ndarray   # (n,) eigenvalues of K
    Xt: jnp.ndarray    # (n, m) Q^T X
    zt: jnp.ndarray    # (n,)  Q^T z


def make_spectral_data(K_mixed, X, z):
    """Rotate (X, z) into the eigenbasis held by a MixedCorrelation and
    promote to the inference precision.

    The O(n^2 m) rotation runs in the compute dtype (f32 on the GPU, full-
    precision products); the resulting O(n m) data is promoted to float64,
    where every likelihood / derivative / root evaluation is an O(n m)
    f64 op. Validated: f32 basis + f64 scalars reproduces the full-f64
    optimum to 6 significant digits, while pure f32 scalars are
    qualitatively wrong.
    """
    from ..utils.config import ensure_inference_precision, inference_dtype
    ensure_inference_precision()
    dt = inference_dtype()
    Xt = K_mixed.rotate(jnp.asarray(X))
    zt = K_mixed.rotate(jnp.asarray(z))

    def promote(a):
        return jnp.asarray(a).astype(dt)

    return SpectralData(lam=promote(K_mixed.eigenvalues),
                        Xt=promote(Xt), zt=promote(zt))


def _spd_inv_logdet(B):
    """Inverse and logdet of a small SPD matrix via Cholesky.

    (B = X^T Kn^-1 X is SPD, so Cholesky is the right primitive.)
    """
    L = jnp.linalg.cholesky(B)
    eye = jnp.eye(B.shape[0], dtype=B.dtype)
    Binv = jax.scipy.linalg.cho_solve((L, True), eye)
    logdet_B = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
    return Binv, logdet_B


def _projector_stats(data, D):
    """Shared pieces: Yt = D*Xt (rotated Kn^-1 X up to scaling), B, Mz.

    Returns (Yt, B, Binv, logdet_B, Mzt) where Mzt is the rotated M z with
    M = Kn^-1 (I - X (X^T Kn^-1 X)^-1 X^T Kn^-1) — *without* the 1/sigma^2
    factors (callers scale).
    """
    lam, Xt, zt = data
    Yt = D[:, None] * Xt
    B = Xt.T @ Yt
    Binv, logdet_B = _spd_inv_logdet(B)
    wt = D * zt
    Mzt = wt - Yt @ (Binv @ (Yt.T @ zt))
    return Yt, B, Binv, logdet_B, Mzt


def log_likelihood(data, sigma, sigma0):
    """REML log-likelihood at (sigma, sigma0); jittable and autodiff-able.

    Matches reference _direct_likelihood.py:32-83 including the degenerate
    sigma -> 0 branch (:50-55), selected with a NaN-safe double-where.
    """
    lam, Xt, zt = data
    n, m = Xt.shape
    dtype = zt.dtype
    sigma = jnp.asarray(sigma, dtype)
    sigma0 = jnp.asarray(sigma0, dtype)

    degenerate = jnp.abs(sigma) < _SIGMA_TOL
    sigma_safe = jnp.where(degenerate, 1.0, sigma)

    # --- regular branch (sigma > 0): work with Kn = K + eta I -----------
    eta = (sigma0 / sigma_safe) ** 2
    D = 1.0 / (lam + eta)
    logdet_S_reg = n * jnp.log(sigma_safe ** 2) + jnp.sum(jnp.log(lam + eta))
    Yt, B, Binv, logdet_B, Mzt = _projector_stats(data, D)
    # S^-1-scaled: Y_S = Yt/sigma^2, B_S = B/sigma^2, Mz_S = Mzt/sigma^2
    logdet_XtSinvX_reg = logdet_B - m * jnp.log(sigma_safe ** 2)
    zMz_reg = (zt @ Mzt) / sigma_safe ** 2

    # --- degenerate branch (sigma ~ 0): S = sigma0^2 I ------------------
    logdet_S_deg = n * jnp.log(sigma0 ** 2)
    B0 = Xt.T @ Xt
    B0inv, logdet_B0 = _spd_inv_logdet(B0)
    logdet_XtSinvX_deg = logdet_B0 - m * jnp.log(sigma0 ** 2)
    Mzt_deg = zt - Xt @ (B0inv @ (Xt.T @ zt))
    zMz_deg = (zt @ Mzt_deg) / sigma0 ** 2

    logdet_S = jnp.where(degenerate, logdet_S_deg, logdet_S_reg)
    logdet_XtSinvX = jnp.where(degenerate, logdet_XtSinvX_deg,
                               logdet_XtSinvX_reg)
    zMz = jnp.where(degenerate, zMz_deg, zMz_reg)

    lp = (-0.5 * (n - m) * jnp.log(2.0 * jnp.pi) - 0.5 * logdet_S
          - 0.5 * logdet_XtSinvX - 0.5 * zMz)
    return lp


def log_likelihood_jacobian(data, sigma, sigma0):
    """Analytic derivatives (d lp / d sigma^2, d lp / d sigma0^2).

    The reference feeds these same trace identities to scipy as if they
    were (d/d sigma, d/d sigma0) (_direct_likelihood.py:148-152 — the
    2*sigma chain factor is absent there); we keep the mathematically
    consistent sigma^2-coordinates and the caller applies the chain rule.
    Identities: d lp/d(sigma^2) = -1/2 tr(KM) + 1/2 z M K M z,
                d lp/d(sigma0^2) = -1/2 tr(M) + 1/2 z M M z.
    """
    lam, Xt, zt = data
    n, m = Xt.shape
    eta = (sigma0 / sigma) ** 2
    D = 1.0 / (lam + eta)
    Yt, B, Binv, logdet_B, Mzt = _projector_stats(data, D)
    Mzt = Mzt / sigma ** 2                      # true M z (rotated)
    KMzt = lam * Mzt
    zMMz = Mzt @ Mzt
    zMKMz = Mzt @ KMzt

    trace_Sinv = jnp.sum(D) / sigma ** 2
    trace_BinvYtY = jnp.trace(Binv @ (Yt.T @ Yt))  # scale-free
    trace_M = trace_Sinv - trace_BinvYtY / sigma ** 2
    trace_KM = (n - m) / sigma ** 2 - eta * trace_M

    der_sigma2 = -0.5 * trace_KM + 0.5 * zMKMz
    der_sigma02 = -0.5 * trace_M + 0.5 * zMMz
    return jnp.stack([der_sigma2, der_sigma02])


def log_likelihood_hessian(data, sigma, sigma0):
    """Analytic Hessian in (sigma^2, sigma0^2) coordinates
    (identities of reference _direct_likelihood.py:163-270)."""
    lam, Xt, zt = data
    n, m = Xt.shape
    eta = (sigma0 / sigma) ** 2
    D = 1.0 / (lam + eta)
    Yt, B, Binv, logdet_B, Mzt_raw = _projector_stats(data, D)

    s2 = sigma ** 2
    Mzt = Mzt_raw / s2
    # V = S^-1 Y (rotated, true scaling): D^2 Xt / sigma^4
    YtY = Yt.T @ Yt
    YtV = (D[:, None] * Yt).T @ Yt   # = Xt^T D^3 Xt (scale-free pieces)
    A = Binv @ YtY                   # scale-free: B^-1 (Xt^T D^2 Xt)
    C = Binv @ YtV

    # True-scale projector apply (rotated): M v = [D v - Yt B^-1 Yt^T v]/s2
    def M_dot(v):
        return (D * v - Yt @ (Binv @ (Yt.T @ v))) / s2

    MMzt = M_dot(Mzt)
    KMzt = lam * Mzt
    MKMzt = M_dot(KMzt)

    zMMMz = Mzt @ MMzt
    zMMKMz = MMzt @ KMzt
    zMKMKMz = KMzt @ MKMzt

    trace_Sinv = jnp.sum(D) / s2
    trace_M = trace_Sinv - jnp.trace(A) / s2
    trace_S2inv = jnp.sum(D * D) / s2 ** 2
    trace_M2 = trace_S2inv - 2.0 * jnp.trace(C) / s2 ** 2 \
        + jnp.trace(A @ A) / s2 ** 2
    trace_KMKM = (n - m) / s2 ** 2 - (2 * eta / s2) * trace_M \
        + eta ** 2 * trace_M2
    trace_KMM = trace_M / s2 - eta * trace_M2

    der2_s02_s02 = 0.5 * (trace_M2 - 2.0 * zMMMz)
    der2_s2_s2 = 0.5 * (trace_KMKM - 2.0 * zMKMKMz)
    der2_s2_s02 = 0.5 * (trace_KMM - 2.0 * zMMKMz)
    return jnp.array([[der2_s2_s2, der2_s2_s02],
                      [der2_s2_s02, der2_s02_s02]])


@partial(jax.jit, static_argnames=("max_iter",))
def _maximize(data, hyperparam_guess, tol, max_iter):
    def neg_lp(hp):
        return -log_likelihood(data, hp[0], hp[1])
    return trust_region_minimize(neg_lp, hyperparam_guess, gtol=tol,
                                 max_iter=max_iter,
                                 initial_radius=0.1)


def maximize_log_likelihood(data, tol=1e-3, hyperparam_guess=(0.2, 0.2),
                            max_iter=100, verbose=False):
    """MLE over (sigma, sigma0) by trust-region Newton on the spectral
    likelihood; mirrors reference _direct_likelihood.py:346-405 (guess
    [0.2, 0.2], tol 1e-3, trust-region with exact Hessian)."""
    guess = jnp.asarray(hyperparam_guess, dtype=data.lam.dtype)
    guess = jax.device_put(guess, list(data.lam.devices())[0])
    res = _maximize(data, guess, tol, max_iter)
    sigma = abs(float(res.x[0]))
    sigma0 = abs(float(res.x[1]))
    if verbose:
        print(f"direct MLE: iters={int(res.iterations)} "
              f"|grad|={float(res.grad_norm):.3e} success={bool(res.success)}")
    eta = (sigma0 / sigma) ** 2 if sigma > 0 else float("inf")
    return {
        "sigma": sigma,
        "sigma0": sigma0,
        "eta": eta,
        "max_lp": -float(res.fun),
        "iterations": int(res.iterations),
        "success": bool(res.success),
    }
