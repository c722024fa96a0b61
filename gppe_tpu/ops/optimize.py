"""Optimizers for small hyperparameter spaces, fully in JAX.

The reference maximizes the direct likelihood with
``scipy.optimize.minimize(method='trust-exact', jac=..., hess=...)``
(reference: gaussian_proc/_likelihood/_direct_likelihood.py:346-405).
Here the whole trust-region Newton iteration is a ``lax.while_loop``:
value/grad/Hessian come from ``jax.grad``/``jax.hessian`` of the jitted
objective, the trust-region subproblem for the k-dimensional hyperparameter
vector (k = 2..4) is solved *exactly* via eigendecomposition + bisection on
the Levenberg parameter, and the optimizer itself is jit/vmap-compatible so
grids of MLE problems batch onto the device.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class TrustRegionResult(NamedTuple):
    x: jnp.ndarray
    fun: jnp.ndarray
    grad_norm: jnp.ndarray
    iterations: jnp.ndarray
    success: jnp.ndarray


def _solve_subproblem(g, H, radius, n_bisect=60):
    """Exact solution of min_p g.p + 0.5 p.H.p  s.t. ||p|| <= radius.

    Eigendecompose H = U diag(s) U^T; p(lmb) = -U (s+lmb)^-1 U^T g with
    lmb >= max(0, -s_min) chosen so ||p|| <= radius (secular equation by
    bisection — branch-free and robust for the k<=4 problems here).
    """
    s, U = jnp.linalg.eigh(H)
    gt = U.T @ g
    s_min = s[0]

    def p_norm(lmb):
        d = s + lmb
        d = jnp.where(jnp.abs(d) < 1e-300, 1e-300, d)
        p = gt / d
        return jnp.sqrt(jnp.sum(p * p))

    lmb_lo = jnp.maximum(0.0, -s_min) + 1e-12
    # Interior Newton step if H is PD and the step fits in the region.
    interior_ok = jnp.logical_and(s_min > 0, p_norm(0.0) <= radius)

    # Otherwise find lmb on [lmb_lo, lmb_hi] with ||p(lmb)|| = radius.
    g_norm = jnp.sqrt(jnp.sum(g * g))
    lmb_hi = lmb_lo + g_norm / jnp.maximum(radius, 1e-300) + 1.0

    def bisect_body(_, lohid):
        lo, hi = lohid
        mid = 0.5 * (lo + hi)
        big = p_norm(mid) > radius
        lo = jnp.where(big, mid, lo)
        hi = jnp.where(big, hi, mid)
        return (lo, hi)

    lo, hi = jax.lax.fori_loop(0, n_bisect, bisect_body, (lmb_lo, lmb_hi))
    lmb = 0.5 * (lo + hi)

    lmb_use = jnp.where(interior_ok, 0.0, lmb)
    d = s + lmb_use
    d = jnp.where(jnp.abs(d) < 1e-300, 1e-300, d)
    p = -(U @ (gt / d))
    # Hard case guard: if the boundary solve still undershoots (g ⟂ v_min),
    # pad along the smallest eigenvector to reach the boundary.
    pn = jnp.sqrt(jnp.sum(p * p))
    need_pad = jnp.logical_and(jnp.logical_not(interior_ok),
                               pn < 0.9 * radius)
    tau = jnp.sqrt(jnp.maximum(radius ** 2 - pn ** 2, 0.0))
    p = jnp.where(need_pad, p + tau * U[:, 0], p)
    return p


@partial(jax.jit, static_argnames=("fun", "max_iter"))
def trust_region_minimize(fun, x0, gtol=1e-5, max_iter=100,
                          initial_radius=1.0, max_radius=1e3):
    """Minimize ``fun`` (R^k -> R) by exact trust-region Newton.

    ``fun`` must be jittable; derivatives come from autodiff. Matches the
    role of the reference's scipy 'trust-exact' call
    (_direct_likelihood.py:378-384) but runs as one XLA program.
    """
    x0 = jnp.asarray(x0, dtype=jnp.result_type(x0, 0.0))
    value_and_grad = jax.value_and_grad(fun)
    hess = jax.hessian(fun)

    f0, g0 = value_and_grad(x0)
    radius0 = jnp.asarray(initial_radius, x0.dtype)

    def cond(state):
        x, f, g, radius, it, done = state
        return jnp.logical_and(it < max_iter, jnp.logical_not(done))

    def body(state):
        x, f, g, radius, it, done = state
        H = hess(x)
        p = _solve_subproblem(g, H, radius)
        pred = -(g @ p + 0.5 * p @ (H @ p))     # predicted decrease
        x_new = x + p
        f_new, g_new = value_and_grad(x_new)
        actual = f - f_new
        rho = actual / jnp.where(pred > 0, pred, 1e-300)

        step_norm = jnp.sqrt(jnp.sum(p * p))
        # Standard radius update
        radius = jnp.where(rho < 0.25, 0.25 * radius,
                           jnp.where(jnp.logical_and(rho > 0.75,
                                                     step_norm > 0.8 * radius),
                                     jnp.minimum(2.0 * radius, max_radius),
                                     radius))
        accept = rho > 0.1
        x = jnp.where(accept, x_new, x)
        f = jnp.where(accept, f_new, f)
        g = jnp.where(accept, g_new, g)
        g_norm = jnp.sqrt(jnp.sum(g * g))
        done = jnp.logical_or(g_norm < gtol, radius < 1e-12)
        return (x, f, g, radius, it + 1, done)

    state = (x0, f0, g0, radius0, jnp.asarray(0), jnp.asarray(False))
    x, f, g, radius, it, done = jax.lax.while_loop(cond, body, state)
    g_norm = jnp.sqrt(jnp.sum(g * g))
    return TrustRegionResult(x=x, fun=f, grad_norm=g_norm, iterations=it,
                             success=g_norm < 10 * gtol)
