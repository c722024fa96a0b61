"""Dense and iterative linear algebra building blocks.

Replacement for the reference's solver dispatch
(reference: gaussian_proc/_mixed_correlation/_linear_solver.py:24-73 —
scipy dense solve / sparse CG) and for the exact trace/logdet paths that
the reference delegates to imate (mixed_correlation.py:183-191,250-261).
Everything here is jittable and shape-static.
"""

from functools import partial

import jax
import jax.numpy as jnp


def eigh_f64(K, out_dtype=None):
    """Symmetric eigendecomposition in float64 on the default device.

    The exact-eigenvalue path (reference: mixed_correlation.py:76-79 —
    one scipy eigh, then O(n) per optimizer step) is a ONE-TIME O(n^3)
    precompute; running it in f64 keeps the small eigenvalues that the
    likelihood's (lam + eta)^-1 terms amplify. Returns (eigenvalues,
    eigenvectors) cast to ``out_dtype`` (default: K's dtype).
    """
    out_dtype = out_dtype or jnp.asarray(K).dtype
    with jax.enable_x64(True):
        lam, Q = jnp.linalg.eigh(jnp.asarray(K).astype(jnp.float64))
        return lam.astype(out_dtype), Q.astype(out_dtype)


def cholesky_factor(Kn):
    """Lower Cholesky factor of an SPD matrix (XLA's blocked kernel).

    Traced under highest matmul precision: the blocked factorization's
    inner f32 matmuls at reduced (TF32) precision lose ~3 digits.
    """
    with jax.default_matmul_precision("highest"):
        return jnp.linalg.cholesky(Kn)


def cholesky_solve(L, B):
    """Solve K x = B given the lower Cholesky factor L of K."""
    with jax.default_matmul_precision("highest"):
        return jax.scipy.linalg.cho_solve((L, True), B)


def cholesky_logdet(L):
    """log det K from its Cholesky factor."""
    return 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))


def cholesky_traceinv(L, exponent: int = 1):
    """Exact trace(K^-p) from the Cholesky factor.

    p=1: trace(K^-1) = ||L^-1||_F^2 ; p=2: trace(K^-2) = ||K^-1||_F^2.
    Mirrors the semantics of the reference's imate cholesky method
    (mixed_correlation.py:183-191).
    """
    n = L.shape[0]
    eye = jnp.eye(n, dtype=L.dtype)
    # full-f32 products (an f32 GPU matmul may otherwise run in TF32)
    with jax.default_matmul_precision("highest"):
        Linv = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
        if exponent == 1:
            return jnp.sum(Linv * Linv)
        if exponent == 2:
            Kinv = Linv.T @ Linv
            return jnp.sum(Kinv * Kinv)
    raise ValueError("exponent must be 1 or 2")


@partial(jax.jit, static_argnames=("A", "max_iter"))
def _cg_solve_callable(A, B, shift, tol, max_iter, M_diag):
    return _cg_body(lambda V: A(V) + shift * V, B, tol, max_iter, M_diag)


@partial(jax.jit, static_argnames=("max_iter",))
def _cg_solve_dense(A, B, shift, tol, max_iter, M_diag):
    mv = lambda V: jnp.matmul(A, V, precision="highest") + shift * V  # noqa: E731
    return _cg_body(mv, B, tol, max_iter, M_diag)


def cg_solve(A, B, tol=1e-6, max_iter=1000, M_diag=None, shift=0.0):
    """Batched conjugate gradient for SPD ``A + shift I``.

    ``A``: (n, n) array or a callable matvec on (n, k). Pass a *stable*
    callable (e.g. a bound method) — it is a static jit argument, so a
    fresh lambda per call would recompile every time. ``shift`` is traced,
    so one compilation serves every eta of the affine family.
    ``B``: (n,) or (n, k) right-hand sides solved simultaneously (each
    column has its own alpha/beta — a batched CG, the accelerator-friendly
    replacement for the reference's per-column scipy CG loop
    (_linear_solver.py:49-60)).
    Runs a fixed-shape while_loop with per-column convergence masking.
    """
    B = jnp.asarray(B)
    shift = jnp.asarray(shift, dtype=B.dtype)
    tol = jnp.asarray(tol, dtype=B.dtype)
    if callable(A):
        return _cg_solve_callable(A, B, shift, tol, max_iter, M_diag)
    return _cg_solve_dense(jnp.asarray(A), B, shift, tol, max_iter, M_diag)


@partial(jax.jit, static_argnames=("A", "max_iter"))
def _minres_callable(A, B, shift, tol, max_iter):
    return _minres_body(lambda V: A(V) + shift * V, B, tol, max_iter)


@partial(jax.jit, static_argnames=("max_iter",))
def _minres_dense(A, B, shift, tol, max_iter):
    mv = lambda V: jnp.matmul(A, V, precision="highest") + shift * V  # noqa: E731
    return _minres_body(mv, B, tol, max_iter)


def minres_solve(A, B, tol=1e-6, max_iter=1000, shift=0.0):
    """Batched MINRES for symmetric (possibly INDEFINITE) ``A + shift I``.

    The role of the reference's symmetric-indefinite fallback
    (_linear_solver.py:61-63, scipy minres). Needed only off the SPD hot
    path: hard-tapered correlation matrices can lose positive
    definiteness (reference warns at
    _generate_sparse_correlation.pyx:481-489), making K + eta*I
    indefinite for eta < |lambda_min|. Same calling convention as
    :func:`cg_solve`; per-column convergence on the MINRES residual-norm
    recurrence.
    """
    B = jnp.asarray(B)
    shift = jnp.asarray(shift, dtype=B.dtype)
    tol = jnp.asarray(tol, dtype=B.dtype)
    if callable(A):
        return _minres_callable(A, B, shift, tol, max_iter)
    return _minres_dense(jnp.asarray(A), B, shift, tol, max_iter)


def _minres_body(matvec, B, tol, max_iter):
    """Lanczos + on-the-fly Givens QR (Paige–Saunders), vectorized over
    RHS columns; all rotation scalars are (r,) lanes."""
    b_was_vector = B.ndim == 1
    if b_was_vector:
        B = B[:, None]
    n, r = B.shape
    dtype = B.dtype

    beta1 = jnp.linalg.norm(B, axis=0)
    beta_safe = jnp.where(beta1 > 0, beta1, 1.0)
    v = B / beta_safe
    zeros_nr = jnp.zeros_like(B)
    ones_r = jnp.ones(r, dtype=dtype)
    zeros_r = jnp.zeros(r, dtype=dtype)

    # state: x, v (current Lanczos vec), v_prev, beta (current), w0, w_m1,
    # gamma0/1, sigma0/1, eta (residual coeff), it
    state0 = (zeros_nr, v, zeros_nr, zeros_r, zeros_nr, zeros_nr,
              ones_r, ones_r, zeros_r, zeros_r, beta1,
              jnp.asarray(0))
    tol_abs = tol * jnp.maximum(beta1, 1e-300)

    def cond(state):
        *_, eta, it = state
        return jnp.logical_and(it < max_iter,
                               jnp.any(jnp.abs(eta) > tol_abs))

    def body(state):
        (x, v, v_prev, beta, w0, w_m1, gamma0, gamma1, sigma0, sigma1,
         eta, it) = state
        active = jnp.abs(eta) > tol_abs

        d = matvec(v)
        alpha = jnp.sum(v * d, axis=0)
        d = d - alpha[None, :] * v - beta[None, :] * v_prev
        beta_next = jnp.linalg.norm(d, axis=0)
        v_next = d / jnp.where(beta_next > 0, beta_next, 1.0)

        a0 = gamma1 * alpha - gamma0 * sigma1 * beta
        a1 = jnp.sqrt(a0 * a0 + beta_next * beta_next)
        a2 = sigma1 * alpha + gamma0 * gamma1 * beta
        a3 = sigma0 * beta
        a1_safe = jnp.where(a1 > 0, a1, 1.0)
        gamma0_n, gamma1_n = gamma1, a0 / a1_safe
        sigma0_n, sigma1_n = sigma1, beta_next / a1_safe

        w_new = (v - a3[None, :] * w_m1 - a2[None, :] * w0) / a1_safe
        x_new = x + (gamma1_n * eta)[None, :] * w_new
        eta_new = -sigma1_n * eta

        # freeze converged lanes
        x = jnp.where(active[None, :], x_new, x)
        eta = jnp.where(active, eta_new, eta)
        return (x, v_next, v, beta_next, w_new, w0,
                gamma0_n, gamma1_n, sigma0_n, sigma1_n, eta, it + 1)

    out = jax.lax.while_loop(cond, body, state0)
    X = out[0]
    return X[:, 0] if b_was_vector else X


def _cg_body(matvec, B, tol, max_iter, M_diag):

    b_was_vector = B.ndim == 1
    if b_was_vector:
        B = B[:, None]

    if M_diag is not None:
        precond = lambda R: R / M_diag[:, None]  # noqa: E731
    else:
        precond = lambda R: R  # noqa: E731

    X = jnp.zeros_like(B)
    R = B - matvec(X)
    Z = precond(R)
    P = Z
    rz = jnp.sum(R * Z, axis=0)
    b_norm2 = jnp.sum(B * B, axis=0)
    tol2 = (tol * tol) * jnp.maximum(b_norm2, 1e-300)

    def cond(state):
        X, R, Z, P, rz, it = state
        r2 = jnp.sum(R * R, axis=0)
        return jnp.logical_and(it < max_iter, jnp.any(r2 > tol2))

    def body(state):
        X, R, Z, P, rz, it = state
        AP = matvec(P)
        pAp = jnp.sum(P * AP, axis=0)
        r2 = jnp.sum(R * R, axis=0)
        active = r2 > tol2
        alpha = jnp.where(pAp > 0, rz / jnp.where(pAp > 0, pAp, 1.0), 0.0)
        alpha = jnp.where(active, alpha, 0.0)
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * AP
        Z = precond(R)
        rz_new = jnp.sum(R * Z, axis=0)
        beta = jnp.where(rz > 0, rz_new / jnp.where(rz > 0, rz, 1.0), 0.0)
        P = Z + beta[None, :] * P
        return (X, R, Z, P, rz_new, it + 1)

    X, R, Z, P, rz, it = jax.lax.while_loop(
        cond, body, (X, R, Z, P, rz, jnp.asarray(0)))
    return X[:, 0] if b_was_vector else X
