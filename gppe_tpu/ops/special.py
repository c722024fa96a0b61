"""Special functions needed by the Matern kernel, in pure JAX.

The reference obtains the modified Bessel function of the second kind
K_nu and the Gamma function from ``scipy.special.cython_special`` inside a
nogil Cython kernel (reference: gaussian_proc/generate_correlation/_kernels.pyx:6,87-88).
JAX has no ``kv``; this module implements it from scratch so that general-nu
Matern kernels are jittable, vmappable, differentiable-in-x, and run on the
accelerator.

Algorithm (classic Temme / Thompson-Barnett approach, as popularized by
Numerical Recipes' ``bessik``):

* reduce the order to ``mu in [-1/2, 1/2]`` with ``nu = mu + nl``,
* small argument (x < 2): Temme's series for K_mu and K_{mu+1},
* large argument (x >= 2): Steed's continued fraction CF2 for K_mu, K_{mu+1},
* upward recurrence K_{mu+j+1} = 2(mu+j)/x K_{mu+j} + K_{mu+j-1} (stable for K),

all with fixed iteration counts (XLA-friendly: no data-dependent trips) and
``jnp.where`` branch selection instead of Python control flow.
"""

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

_EULER_GAMMA = 0.57721566490153286060651209008240243


def gamma(x):
    """Gamma function for positive real x (via exp(gammaln))."""
    x = jnp.asarray(x)
    return jnp.exp(gammaln(x))


def _chepolish(x):
    """gam1(x) = [1/Gamma(1-x) - 1/Gamma(1+x)] / (2x) and
    gam2(x) = [1/Gamma(1-x) + 1/Gamma(1+x)] / 2 for |x| <= 1/2.

    gam1 has a removable singularity at x=0 with limit EulerGamma; we switch
    to a small-|x| Taylor expansion there.
    """
    # reciprocal gammas; Gamma(1 +/- x) > 0 for |x| <= 1/2
    rg_plus = jnp.exp(-gammaln(1.0 + x))   # 1/Gamma(1+x)
    rg_minus = jnp.exp(-gammaln(1.0 - x))  # 1/Gamma(1-x)
    gam2 = 0.5 * (rg_minus + rg_plus)

    small = jnp.abs(x) < 1e-4
    x_safe = jnp.where(small, 1.0, x)
    gam1_direct = (rg_minus - rg_plus) / (2.0 * x_safe)
    # Removable singularity at x=0: 1/Gamma(1+x) = 1 + gamma*x + O(x^2),
    # 1/Gamma(1-x) = 1 - gamma*x + O(x^2), so gam1 -> -EulerGamma. For
    # |x|<1e-4 the constant term is accurate to ~1e-8 absolute.
    gam1 = jnp.where(small, -_EULER_GAMMA, gam1_direct)
    return gam1, gam2


def _kv_temme_small(mu, x, n_terms=30):
    """Temme series: K_mu(x), K_{mu+1}(x) for x < 2, |mu| <= 1/2."""
    x2 = 0.5 * x
    pimu = jnp.pi * mu
    fact = jnp.where(jnp.abs(pimu) < 1e-30, 1.0, pimu / jnp.sin(jnp.where(jnp.abs(pimu) < 1e-30, 1.0, pimu)))
    d = -jnp.log(x2)
    e = mu * d
    fact2 = jnp.where(jnp.abs(e) < 1e-30, 1.0, jnp.sinh(e) / jnp.where(jnp.abs(e) < 1e-30, 1.0, e))
    gam1, gam2 = _chepolish(mu)
    gampl = gam2 - mu * gam1   # 1/Gamma(1+mu)
    gammi = gam2 + mu * gam1   # 1/Gamma(1-mu)
    ones = jnp.ones_like(x * mu)
    ff = fact * (gam1 * jnp.cosh(e) + gam2 * fact2 * d) * ones
    s = ff
    e = jnp.exp(e)
    p = 0.5 * e / gampl * ones
    q = 0.5 / (e * gammi) * ones
    c = ones
    dd = x2 * x2
    s1 = p

    eps = jnp.asarray(jnp.finfo(x.dtype).eps, x.dtype)
    done = jnp.zeros_like(ones, dtype=bool)

    def body(i, carry):
        ff, p, q, c, s, s1, done = carry
        fi = i.astype(x.dtype)
        ff_n = (fi * ff + p + q) / (fi * fi - mu * mu)
        c_n = c * (dd / fi)
        p_n = p / (fi - mu)
        q_n = q / (fi + mu)
        dl = c_n * ff_n
        s_n = s + dl
        dl1 = c_n * (p_n - fi * ff_n)
        s1_n = s1 + dl1
        # Freeze converged lanes: keeps fp32 finite past convergence.
        # BOTH series must have converged: freezing on s alone truncates
        # the autodiff chain of s1 (and of any lane whose s-increments
        # vanish identically while derivative terms do not — the
        # mu = +-1/2 pathology of the CF2 branch, see _kv_cf2_large).
        upd = jnp.logical_not(done)
        done = jnp.logical_or(
            done, jnp.logical_and(jnp.abs(dl) < jnp.abs(s_n) * eps,
                                  jnp.abs(dl1) < jnp.abs(s1_n) * eps))
        pick = lambda new, old: jnp.where(upd, new, old)  # noqa: E731
        return (pick(ff_n, ff), pick(p_n, p), pick(q_n, q), pick(c_n, c),
                pick(s_n, s), pick(s1_n, s1), done)

    ff, p, q, c, s, s1, done = jax.lax.fori_loop(
        1, n_terms + 1, body, (ff, p, q, c, s, s1, done))
    k_mu = s
    k_mu1 = s1 * 2.0 / x
    return k_mu, k_mu1


def _kv_cf2_large(mu, x, n_iters=60):
    """Steed's CF2: K_mu(x), K_{mu+1}(x) for x >= 2, |mu| <= 1/2."""
    mu2 = mu * mu
    ones = jnp.ones_like(x * mu)
    b = 2.0 * (1.0 + x) * ones
    d = 1.0 / b
    h = d
    delh = d
    q1 = jnp.zeros_like(ones)
    q2 = ones
    a1 = (0.25 - mu2) * ones
    q = a1
    c = a1
    a = -a1
    s = 1.0 + q * delh

    eps = jnp.asarray(jnp.finfo(x.dtype).eps, x.dtype)
    done = jnp.zeros_like(ones, dtype=bool)

    def body(i, carry):
        a, b, c, d, h, delh, q, q1, q2, s, done = carry
        fi = i.astype(x.dtype)
        a_n = a - 2.0 * (fi - 1.0)
        c_n = -a_n * c / fi
        qnew = (q1 - b * q2) / a_n
        q_n = q + c_n * qnew
        b_n = b + 2.0
        d_n = 1.0 / (b_n + a_n * d)
        delh_n = (b_n * d_n - 1.0) * delh
        h_n = h + delh_n
        dels = q_n * delh_n
        s_n = s + dels
        # Freeze converged lanes: c ~ i! overflows fp32 if left running.
        # The criterion must ALSO require the h continued fraction to
        # have converged: at mu = +-1/2 (half-integer nu) a1 = 0 makes
        # every dels identically zero, so an s-only test froze the loop
        # at iteration 2 — the VALUE is exact (K_{1/2} is elementary) but
        # the truncation cut the autodiff chain and d K/d nu came out
        # ~5-40% wrong in the z in [2, 6] range (caught by
        # tests/test_special.py::test_kv_nu_gradient_matches_fd). delh
        # rides the true CF contraction, so freezing on both keeps the
        # loop live for the full convergence duration; the derivative
        # series contracts at the same geometric rate.
        upd = jnp.logical_not(done)
        done = jnp.logical_or(
            done, jnp.logical_and(
                jnp.abs(dels) < jnp.abs(s_n) * eps,
                jnp.abs(delh_n) < jnp.abs(h_n) * eps))
        pick = lambda new, old: jnp.where(upd, new, old)  # noqa: E731
        return (pick(a_n, a), pick(b_n, b), pick(c_n, c), pick(d_n, d),
                pick(h_n, h), pick(delh_n, delh), pick(q_n, q),
                pick(q2, q1), pick(qnew, q2), pick(s_n, s), done)

    a, b, c, d, h, delh, q, q1, q2, s, done = jax.lax.fori_loop(
        2, n_iters + 1, body,
        (a, b, c, d, h, delh, q, q1, q2, s, done),
    )
    h = a1 * h
    # e^x-SCALED values (true K = these * e^{-x}): the caller keeps the
    # exponential in a log-scale so large-x lanes neither underflow the
    # value nor overflow any rescaling factor (f32: e^{-x} dies at
    # x ~ 88 while these stay O(1/sqrt(x)))
    k_mu = jnp.sqrt(jnp.pi / (2.0 * x)) / s
    k_mu1 = k_mu * (mu + x + 0.5 - h) / x
    return k_mu, k_mu1


def _kv_parts(nu, x, max_order: int = 128):
    """Scaled evaluation: K_nu(x) = val * exp(log_scale), elementwise.

    The upward recurrence K_{mu+j+1} = 2(mu+j)/x K_{mu+j} + K_{mu+j-1}
    grows like Gamma(nu)(2/x)^nu — far past float32 range for large nu /
    small x (K_25(1e-3) ~ 10^100), which made the f32 Matern NaN above
    nu ~ 10. Carrying the magnitude in a separate log-scale keeps every
    intermediate O(1): the recurrence renormalizes k_hi to unit magnitude
    each step, and the large-x branch keeps its e^{-x} factor in the
    scale too (so log-space consumers stay exact past the f32 underflow
    at x ~ 88). All renormalizations are differentiable (K > 0
    throughout), so autodiff in nu and x flows through unchanged.
    """
    x = jnp.asarray(x)
    dtype = x.dtype
    nu = jnp.asarray(nu, dtype=dtype)
    nu = jnp.abs(nu)  # K_{-nu} = K_nu

    nl = jnp.floor(nu + 0.5)          # number of upward recurrences
    mu = nu - nl                       # in [-1/2, 1/2]

    x_safe = jnp.maximum(x, jnp.asarray(1e-30, dtype))
    small = x_safe < 2.0
    # Evaluate both branches on clamped arguments, select.
    xs = jnp.minimum(x_safe, 2.0)
    xl = jnp.maximum(x_safe, 2.0)
    k_mu_s, k_mu1_s = _kv_temme_small(mu, xs)
    k_mu_l, k_mu1_l = _kv_cf2_large(mu, xl)
    # CF2 returns e^x-scaled values (its e^{-x} factor lives in the log
    # scale), so large-x lanes neither underflow nor overflow
    k_mu = jnp.where(small, k_mu_s, k_mu_l)
    k_mu1 = jnp.where(small, k_mu1_s, k_mu1_l)
    sc = jnp.where(small, jnp.zeros_like(x_safe), -xl)

    # Upward recurrence with masking + per-step renormalization:
    # invariant before step j: k_lo = K_{mu+j} e^{-sc},
    # k_hi = K_{mu+j+1} e^{-sc}.
    xi2 = 2.0 / x_safe

    def rec_body(j, carry):
        k_lo, k_hi, sc = carry
        fj = j.astype(dtype)
        do = fj < nl
        mag = jnp.abs(k_hi)
        mag = jnp.where(mag > 0, mag, 1.0)
        k_lo_r = k_lo / mag
        k_hi_r = k_hi / mag
        sc_r = sc + jnp.log(mag)
        k_new = (mu + fj + 1.0) * xi2 * k_hi_r + k_lo_r
        k_lo = jnp.where(do, k_hi_r, k_lo)
        k_hi = jnp.where(do, k_new, k_hi)
        sc = jnp.where(do, sc_r, sc)
        return (k_lo, k_hi, sc)

    # After j recurrences, k_lo e^{sc} = K_{mu+j}; we need K_{mu+nl}.
    k_lo, k_hi, sc_rec = jax.lax.fori_loop(
        0, max_order, rec_body, (k_mu, k_mu1, sc))
    val = jnp.where(nl == 0, k_mu, k_lo)
    scale = jnp.where(nl == 0, sc, sc_rec)
    return val, scale


def kv(nu, x, max_order: int = 128):
    """Modified Bessel function of the second kind K_nu(x), elementwise.

    Supports real nu >= 0 (traced or static) and x > 0. ``max_order`` bounds
    the upward-recurrence trip count (static for XLA); nu must satisfy
    ``round(nu) <= max_order``.

    Matches ``scipy.special.kv`` to ~1e-12 relative in float64 over the
    domain exercised by Matern kernels (x in [1e-6, 700], nu in [0, 100]).
    Overflows to inf where K_nu exceeds the dtype range (large nu, small
    x) — log-space consumers should use :func:`log_kv` instead.
    """
    x = jnp.asarray(x)
    val, scale = _kv_parts(nu, x, max_order=max_order)
    result = val * jnp.exp(scale)
    return jnp.where(x <= 0, jnp.asarray(jnp.inf, x.dtype), result)


def log_kv(nu, x, max_order: int = 128):
    """log K_nu(x), overflow- and underflow-free across the dtype range.

    The f32-safe form for large-nu Matern kernels: K_25(10^-3) ~ 10^100
    overflows float32 as a value but its log is a tame ~230. Fully
    differentiable in nu and x (the traced-nu sampling path,
    models.kernel_posterior.make_profile_loglik_nu)."""
    x = jnp.asarray(x)
    val, scale = _kv_parts(nu, x, max_order=max_order)
    tiny = jnp.asarray(jnp.finfo(x.dtype).tiny, x.dtype)
    result = jnp.log(jnp.maximum(val, tiny)) + scale
    return jnp.where(x <= 0, jnp.asarray(jnp.inf, x.dtype), result)


def kve(nu, x, max_order: int = 128):
    """Exponentially scaled K: kve(nu, x) = exp(x) * K_nu(x).

    Avoids underflow of K_nu for large x (the far tail of Matern kernels).
    """
    x = jnp.asarray(x)
    val, scale = _kv_parts(nu, x, max_order=max_order)
    result = val * jnp.exp(scale + x)
    return jnp.where(x <= 0, jnp.asarray(jnp.inf, x.dtype), result)
