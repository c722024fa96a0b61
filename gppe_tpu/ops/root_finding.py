"""Bracketing and Chandrupatla root finding, JAX-native and vectorized.

Re-implements the reference's root-finding toolkit
(reference: gaussian_proc/_likelihood/_root_finding.py:21-148 bracketing,
:155-309 Chandrupatla) with two differences dictated by XLA execution:

* the Chandrupatla iteration is a ``lax.while_loop`` over *array* state
  with per-lane termination masks, so an entire batch of root problems
  (e.g. one per (rho, nu) grid point or per HMC chain) runs as one
  compiled program and can be vmapped/sharded;
* the bracket search is expressed with the same mid-point/extension policy
  but as a host-side driver (few evaluations, each jitted).
"""

import jax
import jax.numpy as jnp
import numpy as np


def find_interval_with_sign_change(f, bracket, num_bracket_trials=3,
                                   verbose=False):
    """Search for [x0, x1] with sign(f(x0)) != sign(f(x1)).

    Port of the reference policy (_root_finding.py:21-148): try the given
    interval; on failure probe the midpoint, then extend outward on the
    side with the larger |f|.
    Returns (found, bracket, bracket_values).
    """
    x0, x1 = float(bracket[0]), float(bracket[1])
    f0 = float(f(x0))
    f1 = float(f(x1))

    for _ in range(num_bracket_trials):
        if np.sign(f0) != np.sign(f1):
            return True, [x0, x1], [f0, f1]

        if verbose:
            print(f"bracket search: x0={x0:.3g} f0={f0:.3g} "
                  f"x1={x1:.3g} f1={f1:.3g}")

        # Probe midpoint
        x_new = 0.5 * (x0 + x1)
        f_new = float(f(x_new))
        if np.sign(f0) != np.sign(f_new):
            if abs(f0) < abs(f1):
                return True, [x0, x_new], [f0, f_new]
            return True, [x_new, x1], [f_new, f1]

        if abs(f_new) < min(abs(f0), abs(f1)):
            # refine toward the smaller-|f| side
            if abs(f0) < abs(f1):
                x1, f1 = x_new, f_new
            else:
                x0, f0 = x_new, f_new
            continue

        # extend outward on the side with larger |f|
        if abs(f0) > abs(f1):
            t = 1.5      # right of x1
        else:
            t = -0.5     # left of x0
        x_new = x0 * (1 - t) + x1 * t
        f_new = float(f(x_new))
        if np.sign(f0) != np.sign(f_new):
            if abs(f0) > abs(f1):
                return True, [x_new, x0], [f_new, f0]
            return True, [x1, x_new], [f1, f_new]
        if t > 0:
            x0, f0, x1, f1 = x1, f1, x_new, f_new
        else:
            x1, f1, x0, f0 = x0, f0, x_new, f_new

    return False, [x0, x1], [f0, f1]


def chandrupatla_scalar(f, x0, x1, f0, f1, tol=1e-6, max_iter=100):
    """Host-mode scalar Chandrupatla (float64 python floats).

    The same algorithm as :func:`chandrupatla` for the sequential-host
    callers (models.large_scale.KrylovProfileLikelihood.fit): the per-eta
    evaluation there is O(k^2) host numpy, so a jitted while_loop would
    only add dispatch overhead. ``f0``/``f1`` are the already-computed
    bracket values. Returns (root, iterations)."""
    b, a = x0, x1
    fb, fa = f0, f1
    c, fc = a, fa
    t = 0.5
    iters = 0
    xm, fm = (a, fa) if abs(fa) < abs(fb) else (b, fb)
    while iters < max_iter:
        xt = a + t * (b - a)
        ft = f(xt)
        if np.sign(ft) == np.sign(fa):
            c, fc = a, fa
        else:
            c, b, fc, fb = b, a, fb, fa
        a, fa = xt, ft
        if abs(fa) < abs(fb):
            xm, fm = a, fa
        else:
            xm, fm = b, fb
        tol_x = 2 * tol * abs(xm) + tol
        tlim = tol_x / max(abs(b - c), 1e-300)
        if fm == 0 or tlim > 0.5:
            return xm, iters
        xi = (a - b) / (c - b)
        phi = (fa - fb) / (fc - fb)
        if phi ** 2 < xi and (1 - phi) ** 2 < 1 - xi:
            t = (fa / (fb - fa) * fc / (fb - fc)
                 + (c - a) / (b - a) * fa / (fc - fa) * fb / (fc - fb))
        else:
            t = 0.5
        t = min(1 - tlim, max(tlim, t))
        iters += 1
    return xm, iters


def chandrupatla(f, x0, x1, f0=None, f1=None, eps_m=None, eps_a=None,
                 max_iter=50):
    """Vectorized Chandrupatla root finder (derivative-free, bracketed).

    ``x0``, ``x1`` may be scalars or arrays (one root problem per lane);
    ``f`` must map arrays to arrays elementwise. Jittable; the whole
    iteration is a single ``lax.while_loop``.

    Returns (root, iterations).
    """
    x0 = jnp.asarray(x0, dtype=jnp.result_type(x0, 0.0))
    x1 = jnp.asarray(x1, dtype=x0.dtype)
    shape = jnp.broadcast_shapes(x0.shape, x1.shape)
    b = jnp.broadcast_to(x0, shape)
    a = jnp.broadcast_to(x1, shape)
    fa = jnp.asarray(f(a) if f1 is None else f1, dtype=x0.dtype)
    fb = jnp.asarray(f(b) if f0 is None else f0, dtype=x0.dtype)
    fa = jnp.broadcast_to(fa, shape)
    fb = jnp.broadcast_to(fb, shape)
    c, fc = a, fa

    eps = jnp.finfo(x0.dtype).eps
    eps_m = eps if eps_m is None else eps_m
    eps_a = 2 * eps if eps_a is None else eps_a

    t = jnp.full(shape, 0.5, dtype=x0.dtype)
    terminate = jnp.zeros(shape, dtype=bool)
    xm0 = jnp.where(jnp.abs(fa) < jnp.abs(fb), a, b)

    def cond(state):
        a, b, c, fa, fb, fc, t, xm, terminate, it = state
        return jnp.logical_and(it < max_iter,
                               jnp.logical_not(jnp.all(terminate)))

    def body(state):
        a, b, c, fa, fb, fc, t, xm, terminate, it = state
        xt = a + t * (b - a)
        ft = f(xt)

        samesign = jnp.sign(ft) == jnp.sign(fa)
        c_n = jnp.where(samesign, a, b)
        b_n = jnp.where(samesign, b, a)
        fc_n = jnp.where(samesign, fa, fb)
        fb_n = jnp.where(samesign, fb, fa)
        a_n, fa_n = xt, ft

        fa_smaller = jnp.abs(fa_n) < jnp.abs(fb_n)
        xm_n = jnp.where(fa_smaller, a_n, b_n)
        fm_n = jnp.where(fa_smaller, fa_n, fb_n)

        tol = 2 * eps_m * jnp.abs(xm_n) + eps_a
        denom = jnp.where(b_n == c_n, 1.0, jnp.abs(b_n - c_n))
        tlim = tol / denom
        term_n = jnp.logical_or(terminate,
                                jnp.logical_or(fm_n == 0, tlim > 0.5))

        # inverse quadratic interpolation vs bisection
        xi = (a_n - b_n) / jnp.where(c_n == b_n, 1.0, c_n - b_n)
        phi = (fa_n - fb_n) / jnp.where(fc_n == fb_n, 1.0, fc_n - fb_n)
        iqi = jnp.logical_and(phi ** 2 < xi, (1 - phi) ** 2 < 1 - xi)

        safe = lambda x: jnp.where(x == 0, 1.0, x)  # noqa: E731
        t_iqi = (fa_n / safe(fb_n - fa_n) * fc_n / safe(fb_n - fc_n)
                 + (c_n - a_n) / safe(b_n - a_n)
                 * fa_n / safe(fc_n - fa_n) * fb_n / safe(fc_n - fb_n))
        t_n = jnp.where(iqi, t_iqi, 0.5)
        t_n = jnp.minimum(1 - tlim, jnp.maximum(tlim, t_n))

        # frozen lanes keep their previous xm
        xm_out = jnp.where(terminate, xm, xm_n)
        return (a_n, b_n, c_n, fa_n, fb_n, fc_n, t_n, xm_out, term_n, it + 1)

    state = (a, b, c, fa, fb, fc, t, xm0, terminate, jnp.asarray(0))
    a, b, c, fa, fb, fc, t, xm, terminate, it = jax.lax.while_loop(
        cond, body, state)
    return xm, it
