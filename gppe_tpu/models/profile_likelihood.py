"""Profile likelihood over eta with sigma profiled out analytically.

Spectral re-derivation of the reference's ProfileLikelihood
(reference: gaussian_proc/_likelihood/_profile_likelihood.py:32-542):
the optimal sigma^2(eta) = z^T M z / (n - m) is substituted, and the MLE
over eta reduces to the zero of d lp / d eta, found by bracketing +
Chandrupatla (reference :244-415). All per-eta quantities are diagonal
operations in the eigenbasis (O(n m) each), and the derivative function is
jittable/vmappable so root finds batch across (rho, nu) grids or chains.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import root_finding
from .direct_likelihood import (SpectralData, _spd_inv_logdet,  # noqa: F401
                                make_spectral_data)


def _eta_stats(data, eta):
    """Shared per-eta pieces: Yt = D Xt, B, Binv, Mzt (Kn-scale, no sigma).

    B is SPD, so its inverse/logdet go through Cholesky."""
    lam, Xt, zt = data
    D = 1.0 / (lam + eta)
    Yt = D[:, None] * Xt
    B = Xt.T @ Yt
    Binv, logdet_B = _spd_inv_logdet(B)
    wt = D * zt
    Mzt = wt - Yt @ (Binv @ (Yt.T @ zt))
    return D, Yt, B, Binv, logdet_B, Mzt


def log_likelihood(data, sigma, eta):
    """lp(sigma, eta) (reference _profile_likelihood.py:38-85)."""
    lam, Xt, zt = data
    n, m = Xt.shape
    D, Yt, B, Binv, logdet_B, Mzt = _eta_stats(data, eta)
    logdet_Kn = jnp.sum(jnp.log(lam + eta))
    zMz = zt @ Mzt
    lp = (-0.5 * (n - m) * jnp.log(sigma ** 2) - 0.5 * logdet_Kn
          - 0.5 * logdet_B - 0.5 / sigma ** 2 * zMz)
    return lp


def log_likelihood_der1_eta(data, log_eta):
    """d lp / d eta at the profiled sigma^2(eta), input in log10(eta)
    (reference _profile_likelihood.py:91-132). Jittable, vectorized over
    ``log_eta`` of any shape."""
    lam, Xt, zt = data
    n, m = Xt.shape

    def scalar(le):
        eta = jnp.power(10.0, le)
        D, Yt, B, Binv, logdet_B, Mzt = _eta_stats(data, eta)
        trace_Kninv = jnp.sum(D)
        trace_BinvYtY = jnp.trace(Binv @ (Yt.T @ Yt))
        trace_M = trace_Kninv - trace_BinvYtY
        zMz = zt @ Mzt
        zM2z = Mzt @ Mzt
        sigma2 = zMz / (n - m)
        return -0.5 * (trace_M - zM2z / sigma2)

    log_eta = jnp.asarray(log_eta)
    if log_eta.ndim == 0:
        return scalar(log_eta)
    flat = jnp.reshape(log_eta, (-1,))
    return jnp.reshape(jax.vmap(scalar)(flat), log_eta.shape)


def log_likelihood_der2_eta(data, eta):
    """d^2 lp / d eta^2 at the profiled sigma (reference :138-192)."""
    lam, Xt, zt = data
    n, m = Xt.shape
    eta = jnp.asarray(eta)
    D, Yt, B, Binv, logdet_B, Mzt = _eta_stats(data, eta)

    trace_Kninv = jnp.sum(D)
    YtY = Yt.T @ Yt
    A = Binv @ YtY
    trace_M = trace_Kninv - jnp.trace(A)

    trace_Kn2inv = jnp.sum(D * D)
    YtV = Yt.T @ (D[:, None] * Yt)          # = Xt^T D^3 Xt
    C = Binv @ YtV
    trace_M2 = trace_Kn2inv - 2.0 * jnp.trace(C) + jnp.trace(A @ A)

    MMzt = D * Mzt - Yt @ (Binv @ (Yt.T @ Mzt))
    zMz = zt @ Mzt
    zM3z = Mzt @ MMzt
    sigma2 = zMz / (n - m)
    d2 = (0.5 / sigma2) * ((trace_M2 / (n - m)
                            + (trace_M / (n - m)) ** 2) * zMz - 2.0 * zM3z)
    return d2


def find_optimal_sigma(data, eta):
    """Closed-form sigma(eta) (reference :259-275)."""
    lam, Xt, zt = data
    n, m = Xt.shape
    D, Yt, B, Binv, logdet_B, Mzt = _eta_stats(data, eta)
    sigma2 = (zt @ Mzt) / (n - m)
    return jnp.sqrt(sigma2)


def find_optimal_sigma0(data):
    """sigma0 at eta -> inf where sigma = 0 (reference :281-295)."""
    lam, Xt, zt = data
    n, m = Xt.shape
    B0 = Xt.T @ Xt
    B0inv, _ = _spd_inv_logdet(B0)
    v = Xt @ (B0inv @ (Xt.T @ zt))
    sigma02 = (zt @ (zt - v)) / (n - m)
    return jnp.sqrt(sigma02)


def compute_bounds_der1_eta(data, eta):
    """Analytic upper/lower bounds of d lp/d eta from extreme eigenvalues
    (reference :456-477)."""
    lam, Xt, zt = data
    n, m = Xt.shape
    eig_min = lam[0]
    eig_max = lam[-1]
    ub = 0.5 * (n - m) * (1.0 / (eta + eig_min) - 1.0 / (eta + eig_max))
    return ub, -ub


def compute_asymptote_der1_eta(K, X, z, eta):
    """Direct dense implementation of the reference's asymptote formulas
    (reference _profile_likelihood.py:483-542)."""
    K = np.asarray(K)
    X = np.asarray(X)
    z = np.asarray(z)
    eta = np.atleast_1d(np.asarray(eta, dtype=float))
    n, m = X.shape
    I_n = np.eye(n)
    Q = X @ np.linalg.solve(X.T @ X, X.T)
    R = I_n - Q
    N = K @ R
    N2 = N @ N
    N3 = N2 @ N
    N4 = N3 @ N
    mtrN = np.trace(N) / (n - m)
    mtrN2 = np.trace(N2) / (n - m)
    A0 = -R @ (mtrN * I_n - N)
    A1 = R @ (mtrN * N + mtrN2 * I_n - 2 * N2)
    A2 = -R @ (mtrN * N2 + mtrN2 * N - 2 * N3)
    A3 = R @ (mtrN2 * N2 - N4)
    zRz = z @ (R @ z)
    zc = z / np.sqrt(zRz)
    a0 = zc @ (A0 @ zc)
    a1 = zc @ (A1 @ zc)
    a2 = zc @ (A2 @ zc)
    a3 = zc @ (A3 @ zc)
    asym1 = (-0.5 * (n - m)) * (a0 + a1 / eta) / eta ** 2
    asym2 = (-0.5 * (n - m)) * (a0 + a1 / eta + a2 / eta ** 2
                                + a3 / eta ** 3) / eta ** 2
    roots1 = np.roots([a0, a1])
    roots2 = np.roots([a0, a1, a2, a3])
    roots2 = np.sort(np.real(roots2[np.abs(np.imag(roots2)) < 1e-10]))
    return asym1, asym2, roots1, roots2


def find_log_likelihood_der1_zeros(data, interval_eta, tol=1e-6,
                                   max_iterations=100, num_bracket_trials=3,
                                   verbose=False):
    """Root-finding driver for d lp/d eta = 0 in log10(eta)
    (reference :244-415), including the boundary-optimum fallback using the
    sign of the second derivative at eta = 0 (:352-405)."""
    der1 = jax.jit(lambda le: log_likelihood_der1_eta(data, le))

    log_eta_start = float(np.log10(interval_eta[0]))
    log_eta_end = float(np.log10(interval_eta[1]))

    found, bracket, bracket_values = root_finding.find_interval_with_sign_change(
        lambda le: float(der1(jnp.asarray(le))),
        [log_eta_start, log_eta_end], num_bracket_trials, verbose=verbose)

    if found:
        root, iters = root_finding.chandrupatla(
            der1, jnp.asarray(bracket[0]), jnp.asarray(bracket[1]),
            f0=jnp.asarray(bracket_values[0]),
            f1=jnp.asarray(bracket_values[1]),
            eps_m=tol, eps_a=tol, max_iter=max_iterations)
        eta = float(10.0 ** float(root))
        sigma = float(find_optimal_sigma(data, eta))
        sigma0 = float(np.sqrt(eta) * sigma)
        return {"sigma": sigma, "sigma0": sigma0, "eta": eta,
                "success": True, "iterations": int(iters)}

    # No sign change: pick the boundary optimum from the sign of the
    # second derivative at eta = 0.
    f_left, f_right = bracket_values
    d2_zero = float(log_likelihood_der2_eta(data, 0.0))
    if f_left > 0 and f_right > 0:
        eta = 0.0 if d2_zero > 0 else np.inf
    elif f_left < 0 and f_right < 0:
        eta = 0.0 if d2_zero < 0 else np.inf
    else:
        # mixed signs but the bracket search failed anyway: degenerate
        # (the reference reasons about this case through der2 too and
        # warns, _profile_likelihood.py:383-405) — say so, don't silently
        # pick a boundary
        import warnings
        warnings.warn(
            "profile-likelihood derivative has mixed signs at the "
            "interval ends but no sign-change bracket was found: "
            "degenerate case, falling back to the eta = 0 boundary; "
            "widen interval_eta or raise num_bracket_trials",
            stacklevel=2)
        eta = 0.0
    if eta == 0.0:
        sigma = float(find_optimal_sigma(data, 0.0))
        result = {"sigma": sigma, "sigma0": 0.0, "eta": 0.0, "success": True}
    else:
        sigma0 = float(find_optimal_sigma0(data))
        result = {"sigma": 0.0, "sigma0": sigma0, "eta": np.inf,
                  "success": True}
    result["iterations"] = 0
    return result


def maximize_log_likelihood_with_sigma_eta(data, tol=1e-6,
                                           hyperparam_guess=(0.1, 0.1)):
    """2-parameter (sigma, eta) maximization (reference :198-238, which
    uses Nelder-Mead; here trust-region Newton on log-parameters for
    positivity)."""
    from ..ops.optimize import trust_region_minimize

    def neg_lp(q):
        sigma = jnp.exp(q[0])
        eta = jnp.exp(q[1])
        return -log_likelihood(data, sigma, eta)

    q0 = jnp.log(jnp.asarray(hyperparam_guess, dtype=jnp.result_type(0.0)))
    res = trust_region_minimize(neg_lp, q0, gtol=tol, max_iter=200,
                                initial_radius=1.0)
    sigma = float(jnp.exp(res.x[0]))
    eta = float(jnp.exp(res.x[1]))
    return {"sigma": sigma, "sigma0": float(np.sqrt(eta) * sigma),
            "eta": eta, "max_lp": -float(res.fun),
            "success": bool(res.success)}
