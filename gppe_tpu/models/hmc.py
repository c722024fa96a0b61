"""Hamiltonian Monte Carlo over kernel hyperparameters, chain-parallel.

The Bayesian counterpart of the reference's grid/MAP outer loop
(reference: examples/FindOptimalCovarianceParameters.py — its docstring
:4-8 records a retired Ray-parallel posterior exploration). Design:

* the whole sampler is ONE jitted ``lax.scan``; chains are a vmapped
  batch axis, so C chains advance as a single batched-Cholesky program,
  and the chain axis shards over the mesh's 'probe'/'chain' axis
  (jax.sharding);
* dual-averaging step-size adaptation (Nesterov/Hoffman-Gelman) during
  warmup, per-chain;
* diagonal mass-matrix adaptation from warmup iterates (Welford);
* gradients via autodiff through the fused assembly+Cholesky likelihood
  (gppe_tpu.models.kernel_posterior).
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class HMCResult(NamedTuple):
    samples: jnp.ndarray        # (num_samples, chains, dim)
    log_probs: jnp.ndarray      # (num_samples, chains)
    accept_rate: jnp.ndarray    # (chains,)
    step_size: jnp.ndarray      # (chains,)
    inv_mass: jnp.ndarray       # (chains, dim)
    final_theta: jnp.ndarray    # (chains, dim) — raw (unconstrained) state
    final_key: jnp.ndarray      # PRNG key after the last step

    def state(self):
        """Chain state for checkpoint/resume (see utils.checkpoint and
        resume_hmc): continuing from this state reproduces the
        uninterrupted chain exactly (adaptation is frozen after warmup,
        so a num_warmup=0 restart with the adapted step size and mass
        matrix reproduces the chain the running scan would have produced
        to XLA scheduling rounding, ~1e-13 relative on f64)."""
        return {
            "theta": self.final_theta,
            "key": self.final_key,
            "step_size": self.step_size,
            "inv_mass": self.inv_mass,
        }


def _leapfrog(grad_fn, theta, momentum, step_size, inv_mass, num_steps):
    """Velocity-Verlet with fused half-kicks: the textbook per-step
    (half-kick, drift, half-kick) evaluates 2L gradients; chaining the
    adjacent half-kicks into full kicks gives the identical trajectory
    at L+1 gradients — the gradient IS the whole cost for the
    kernel-hyperparameter targets (a Cholesky factorization per
    evaluation)."""
    mo = momentum + 0.5 * step_size * grad_fn(theta)

    def body(_, carry):
        th, mo = carry
        th = th + step_size * inv_mass * mo
        mo = mo + step_size * grad_fn(th)
        return (th, mo)

    theta, mo = jax.lax.fori_loop(0, num_steps - 1, body, (theta, mo))
    theta = theta + step_size * inv_mass * mo
    mo = mo + 0.5 * step_size * grad_fn(theta)
    return (theta, mo)


def _hmc_carry0(log_prob_fn, init_theta, key, init_step_size,
                init_inv_mass):
    """Initial sampler carry (a pytree dict) — everything the chain
    needs to continue, including the dual-averaging and Welford
    adaptation state, so a run can be split across device programs."""
    chains, dim = init_theta.shape
    dtype = init_theta.dtype
    lp0 = jax.vmap(lambda th: log_prob_fn(th).astype(dtype))(init_theta)
    iss = jnp.broadcast_to(jnp.asarray(init_step_size, dtype), (chains,))
    return {
        "theta": init_theta,
        "lp": lp0,
        "key": key,
        "mu": jnp.log(10.0 * iss),
        # log_eps_bar starts at log(init_step_size): during warmup the
        # first dual-averaging step overwrites it fully (eta_1 = 1), and
        # with num_warmup = 0 it IS the fixed post-warmup step size —
        # the resume contract
        "log_eps": jnp.log(iss),
        "log_eps_bar": jnp.log(iss),
        "h_bar": jnp.zeros(chains, dtype),
        "w_mean": jnp.zeros((chains, dim), dtype),
        "w_m2": jnp.zeros((chains, dim), dtype),
        "inv_mass": (jnp.ones((chains, dim), dtype)
                     if init_inv_mass is None else jnp.broadcast_to(
                         jnp.asarray(init_inv_mass, dtype),
                         (chains, dim))),
        "n_accept": jnp.zeros(chains, dtype),
    }


@partial(jax.jit,
         static_argnames=("log_prob_fn", "n_steps", "num_warmup",
                          "num_leapfrog", "grad_mode"))
def _hmc_chunk(log_prob_fn, carry, it0, n_steps, num_warmup,
               num_leapfrog, target_accept, grad_mode):
    """Advance the sampler ``n_steps`` GLOBAL steps starting at index
    ``it0``. Warmup scheduling (dual averaging, the Welford window, the
    mass switch) is driven by the global index, so one long run can be
    split into many short device programs (see hmc_sample's
    chunk_steps)."""
    chains, dim = carry["theta"].shape
    dtype = carry["theta"].dtype

    def _lp(th):
        # keep scan carries in the sampler-state dtype even when the
        # target computes in another precision
        return log_prob_fn(th).astype(dtype)

    grad_fn = {"rev": jax.grad, "fwd": jax.jacfwd}[grad_mode]

    def _grad(th):
        return grad_fn(log_prob_fn)(th).astype(dtype)

    gamma, t0, kappa = 0.05, 10.0, 0.75

    def step(c, it):
        key, k_mo, k_u = jax.random.split(c["key"], 3)
        eps = jnp.exp(c["log_eps"])
        inv_mass = c["inv_mass"]
        theta, lp = c["theta"], c["lp"]

        # momentum ~ N(0, M); M = 1/inv_mass (diagonal)
        mo = (jax.random.normal(k_mo, (chains, dim), dtype)
              / jnp.sqrt(inv_mass))

        def one_chain(th, m, e, im):
            return _leapfrog(_grad, th, m, e, im, num_leapfrog)
        theta_new, mo_new = jax.vmap(one_chain)(theta, mo, eps, inv_mass)
        lp_new = jax.vmap(_lp)(theta_new)
        lp_new = jnp.where(jnp.isfinite(lp_new), lp_new, -jnp.inf)

        ke_old = 0.5 * jnp.sum(mo * mo * inv_mass, axis=1)
        ke_new = 0.5 * jnp.sum(mo_new * mo_new * inv_mass, axis=1)
        log_accept = (lp_new - ke_new) - (lp - ke_old)
        log_accept = jnp.where(jnp.isnan(log_accept), -jnp.inf, log_accept)
        accept_prob = jnp.minimum(1.0, jnp.exp(log_accept))
        u = jax.random.uniform(k_u, (chains,), dtype)
        accept = u < accept_prob
        theta = jnp.where(accept[:, None], theta_new, theta)
        lp = jnp.where(accept, lp_new, lp)

        in_warmup = it < num_warmup
        # --- dual averaging (warmup only) -------------------------------
        t = it.astype(dtype) + 1.0
        h_bar_n = ((1.0 - 1.0 / (t + t0)) * c["h_bar"]
                   + (target_accept - accept_prob) / (t + t0))
        log_eps_n = c["mu"] - jnp.sqrt(t) / gamma * h_bar_n
        eta_t = t ** (-kappa)
        log_eps_bar_n = eta_t * log_eps_n + (1 - eta_t) * c["log_eps_bar"]
        log_eps = jnp.where(in_warmup, log_eps_n, c["log_eps_bar"])
        log_eps_bar = jnp.where(in_warmup, log_eps_bar_n,
                                c["log_eps_bar"])
        h_bar = jnp.where(in_warmup, h_bar_n, c["h_bar"])

        # --- Welford mass accumulation over the 2nd warmup half ---------
        in_window = jnp.logical_and(it >= num_warmup // 2, in_warmup)
        cnt = jnp.maximum(it - num_warmup // 2 + 1, 1).astype(dtype)
        delta = theta - c["w_mean"]
        w_mean_n = c["w_mean"] + delta / cnt
        w_m2_n = c["w_m2"] + delta * (theta - w_mean_n)
        w_mean = jnp.where(in_window, w_mean_n, c["w_mean"])
        w_m2 = jnp.where(in_window, w_m2_n, c["w_m2"])
        # switch in the adapted mass at the end of warmup
        var = w_m2 / jnp.maximum(cnt - 1.0, 1.0)
        var = jnp.where(var > 1e-10, var, 1.0)
        inv_mass = jnp.where(it == num_warmup - 1, var, inv_mass)

        n_accept = c["n_accept"] + jnp.where(it >= num_warmup,
                                             accept.astype(dtype), 0.0)
        c_out = {"theta": theta, "lp": lp, "key": key, "mu": c["mu"],
                 "log_eps": log_eps, "log_eps_bar": log_eps_bar,
                 "h_bar": h_bar, "w_mean": w_mean, "w_m2": w_m2,
                 "inv_mass": inv_mass, "n_accept": n_accept}
        return c_out, (theta, lp)

    its = jnp.arange(n_steps) + it0
    carry, (thetas, lps) = jax.lax.scan(step, carry, its)
    return carry, thetas, lps


def hmc_sample(log_prob_fn, init_theta, key, num_samples=1000,
               num_warmup=500, num_leapfrog=16, init_step_size=0.1,
               target_accept=0.8, init_inv_mass=None, grad_mode="rev",
               chunk_steps=None):
    """Run HMC. ``init_theta``: (chains, dim); ``log_prob_fn`` maps (dim,)
    -> scalar and is vmapped internally. Returns HMCResult.

    ``init_step_size`` may be a scalar or a per-chain (chains,) array;
    ``init_inv_mass`` an optional (chains, dim) diagonal inverse-mass.
    Passing a saved ``HMCResult.state()`` as (theta, key, step_size,
    inv_mass) with ``num_warmup=0`` continues the chain exactly — see
    :func:`resume_hmc`.

    ``grad_mode``: "rev" (default, jax.grad) or "fwd" (jax.jacfwd) —
    forward mode pays dim tangent passes but stores NO loop residuals;
    required when the target runs long fixed-trip loops over (n, n)
    arrays (the traced-nu Bessel kernel: reverse mode materializes ~200
    iterations x n^2 residuals and OOMs HBM at n = 900).

    ``chunk_steps``: when set, the scan is split into device programs of
    at most this many steps, with the FULL adaptation state (dual
    averaging, Welford window, global step index) carried across
    programs — warmup continues seamlessly. Use for expensive targets
    where one long device program is unwelcome (progress output,
    checkpoints, runtimes that bound a single program); pure overhead
    otherwise."""
    init_theta = jnp.asarray(init_theta)
    carry = _hmc_carry0(log_prob_fn, init_theta, key, init_step_size,
                        init_inv_mass)
    total = num_warmup + num_samples
    if chunk_steps is None or chunk_steps >= total:
        carry, thetas, lps = _hmc_chunk(
            log_prob_fn, carry, 0, total, num_warmup, num_leapfrog,
            target_accept, grad_mode)
        samples, lp_out = thetas[num_warmup:], lps[num_warmup:]
    else:
        smp, lpl = [], []
        it0 = 0
        while it0 < total:
            n = int(min(chunk_steps, total - it0))
            carry, thetas, lps = _hmc_chunk(
                log_prob_fn, carry, it0, n, num_warmup, num_leapfrog,
                target_accept, grad_mode)
            jax.block_until_ready(thetas)
            keep = max(num_warmup - it0, 0)
            if keep < n:
                smp.append(thetas[keep:])
                lpl.append(lps[keep:])
            it0 += n
        samples = jnp.concatenate(smp, axis=0)
        lp_out = jnp.concatenate(lpl, axis=0)
    return HMCResult(samples=samples,
                     log_probs=lp_out,
                     accept_rate=carry["n_accept"] / num_samples,
                     step_size=jnp.exp(carry["log_eps"]),
                     inv_mass=carry["inv_mass"],
                     final_theta=carry["theta"],
                     final_key=carry["key"])



def resume_hmc(log_prob_fn, state, num_samples, num_leapfrog=16,
               grad_mode="rev", chunk_steps=None):
    """Continue a chain from a saved ``HMCResult.state()`` dict.

    No warmup, adaptation frozen at the saved step size / inverse mass:
    the continued samples are those the uninterrupted run would have
    produced, up to last-ulp XLA scheduling rounding (tested at 1e-10
    on the f64 CPU path).

    ``grad_mode``/``chunk_steps`` must match the original run for
    targets that need them (the traced-nu Bessel posterior requires
    forward-mode gradients and short device programs — see
    hmc_sample): sample_posterior_nu's resume branch forwards both."""
    return hmc_sample(log_prob_fn, jnp.asarray(state["theta"]),
                      jnp.asarray(state["key"]),
                      num_samples=num_samples, num_warmup=0,
                      num_leapfrog=num_leapfrog,
                      init_step_size=jnp.asarray(state["step_size"]),
                      init_inv_mass=jnp.asarray(state["inv_mass"]),
                      grad_mode=grad_mode, chunk_steps=chunk_steps)


def sample_posterior(points, z, X, nu=0.5, num_chains=8, num_samples=500,
                     num_warmup=300, num_leapfrog=16, key=0,
                     init=None, log_prior=None, mesh=None,
                     support_log10=None, resume_state=None,
                     chunk_steps=None):
    """Sample the (log10 eta, log10 rho) posterior of a GP dataset.

    Chains are a batch axis; with ``mesh`` given, the chain axis is
    sharded over the mesh's 'probe' axis so chains distribute across
    chips/hosts (BASELINE config 5).

    ``support_log10``: optional ((lo, hi), (lo, hi)) log10 box; when given,
    sampling runs in unconstrained sigmoid-transformed coordinates (no
    hard prior boundary for the leapfrog to fall off) and the returned
    samples are mapped back to (log10 eta, log10 rho).

    ``resume_state``: a saved ``HMCResult.state()`` dict (see
    utils.checkpoint.save_hmc_state) — continues the chains exactly
    where a previous run stopped (no warmup, adaptation frozen); the
    other posterior arguments must match the original run.

    ``chunk_steps``: split the scan into device programs of at most
    this many steps (see hmc_sample — the dense-Cholesky target at
    many chains/steps makes one long program otherwise).
    """
    from .kernel_posterior import (make_bounded_log_posterior,
                                   make_log_posterior)
    u_to_theta = None
    if support_log10 is not None:
        log_post, u_to_theta = make_bounded_log_posterior(
            points, z, X, nu=nu, log10_bounds=support_log10,
            log_prior=log_prior)
    else:
        log_post = make_log_posterior(points, z, X, nu=nu,
                                      log_prior=log_prior)

    if resume_state is not None:
        res = resume_hmc(log_post, resume_state, num_samples,
                         num_leapfrog=num_leapfrog,
                         chunk_steps=chunk_steps)
        if u_to_theta is not None:
            res = res._replace(samples=u_to_theta(res.samples))
        return res

    rng = jax.random.PRNGKey(key)
    k_init, k_run = jax.random.split(rng)
    if init is None:
        if support_log10 is not None:
            init = 0.5 * jax.random.normal(k_init, (num_chains, 2))
        else:
            base = jnp.asarray([1.0, -1.0])  # log10 eta ~ 10, rho ~ 0.1
            init = base + 0.5 * jax.random.normal(k_init, (num_chains, 2))
            # chains drawn outside the prior support (lp = -inf) cannot
            # move; fall back to the in-support base point
            lp_init = jax.vmap(log_post)(init)
            init = jnp.where(jnp.isfinite(lp_init)[:, None], init, base)
    init = jnp.asarray(init, dtype=jnp.result_type(0.0))

    if mesh is not None:
        from ..parallel.mesh import PROBE_AXIS
        sharding = jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(PROBE_AXIS, None))
        init = jax.device_put(init, sharding)

    res = hmc_sample(log_post, init, k_run, num_samples=num_samples,
                     num_warmup=num_warmup, num_leapfrog=num_leapfrog,
                     chunk_steps=chunk_steps)
    if u_to_theta is not None:
        res = res._replace(samples=u_to_theta(res.samples))
    return res


def sample_posterior_nu(points, z, X, num_chains=8, num_samples=500,
                        num_warmup=300, num_leapfrog=16, key=0,
                        log_prior="reference",
                        log10_eta_bounds=(-3.0, 4.0),
                        log10_rho_bounds=(-2.0, 0.0),
                        nu_bounds=(1.0, 25.0), mesh=None,
                        resume_state=None, chunk_steps=None):
    """Sample the FULL (log10 eta, log10 rho, nu) posterior — inference
    over the kernel-order parameter the reference's flagship sweep
    covers (nu in [1, 25], FindOptimalCovarianceParameters.py:664-666)
    and its MAP analysis showed matters (prior moves nu from the bound
    25 to 3.03, golden data/OptimalCovariance_WithPrior.pickle).

    ``nu`` is traced through the from-scratch Bessel K_nu, so leapfrog
    gradients include d lp/d nu (validated against central differences
    in tests/test_nu_posterior.py). ``log_prior="reference"`` applies
    the golden pickle's priors — inverse-square on rho and on nu/25
    (reference :119-146); pass None for flat-in-box, or a callable
    ``log_prior(eta, rho, nu)`` in natural parameters.

    Returns an HMCResult whose samples are (num_samples, chains, 3) in
    (log10 eta, log10 rho, nu) coordinates.
    """
    from .kernel_posterior import make_bounded_log_posterior_nu
    from .priors import inverse_square_log_prior

    if log_prior == "reference":
        def log_prior(eta, rho, nu):  # noqa: F811
            return (inverse_square_log_prior(rho)
                    + inverse_square_log_prior(nu, scale=25.0))

    log_post, u_to_theta = make_bounded_log_posterior_nu(
        points, z, X, log10_bounds=(log10_eta_bounds, log10_rho_bounds),
        nu_bounds=nu_bounds, log_prior=log_prior)

    if resume_state is not None:
        # forward-mode + chunked programs are REQUIRED here, exactly as
        # on the fresh path below: reverse mode through the traced-nu
        # Bessel loops OOMs device memory (~31 GB at n = 900), and the
        # chunks keep each device program short
        res = resume_hmc(log_post, resume_state, num_samples,
                         num_leapfrog=num_leapfrog, grad_mode="fwd",
                         chunk_steps=chunk_steps)
        return res._replace(samples=u_to_theta(res.samples))

    rng = jax.random.PRNGKey(key)
    k_init, k_run = jax.random.split(rng)
    init = 0.5 * jax.random.normal(k_init, (num_chains, 3))
    init = jnp.asarray(init, dtype=jnp.result_type(0.0))

    if mesh is not None:
        from ..parallel.mesh import PROBE_AXIS
        sharding = jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(PROBE_AXIS, None))
        init = jax.device_put(init, sharding)

    # forward-mode gradients: reverse mode through the Bessel loops
    # stores ~200 fixed-trip iterations of (n, n) residuals (31 GB at
    # n = 900, 4 chains); 3 tangent passes store nothing.
    # chunk_steps splits the scan into short device programs (full
    # adaptation state carried across).
    res = hmc_sample(log_post, init, k_run, num_samples=num_samples,
                     num_warmup=num_warmup, num_leapfrog=num_leapfrog,
                     grad_mode="fwd", chunk_steps=chunk_steps)
    return res._replace(samples=u_to_theta(res.samples))


def sample_profile_posterior_rho_nu(points, z, X, num_chains=8,
                                    num_samples=400, num_warmup=200,
                                    num_leapfrog=10, key=0,
                                    log_prior="reference",
                                    log10_eta_bounds=(-3.0, 4.0),
                                    log10_rho_bounds=(-1.3, -0.3),
                                    nu_bounds=(1.0, 25.0),
                                    chunk_steps=None, eta_grid=29,
                                    golden_iters=22):
    """HMC over (log10 rho, nu) on the ETA-PROFILED likelihood surface —
    the sampler counterpart of the reference's MAP sweep (its grid
    maximizes eta out per (rho, nu) before arg-maxing; golden
    data/OptimalCovariance_WithPrior.pickle puts the mode at
    rho ~ 0.1767, nu ~ 3.034). The joint (eta, rho, nu) posterior
    (sample_posterior_nu) legitimately concentrates on the high-eta
    plateau at this config — see
    kernel_posterior.make_profiled_rho_nu_posterior for the analysis.

    ``log_prior="reference"``: inverse-square priors on rho and nu/25
    (reference FindOptimalCovarianceParameters.py:119-146). Returns an
    HMCResult with samples (S, C, 2) in (log10 rho, nu)."""
    from .kernel_posterior import make_profiled_rho_nu_posterior
    from .priors import inverse_square_log_prior

    if log_prior == "reference":
        def log_prior(rho, nu):  # noqa: F811
            return (inverse_square_log_prior(rho)
                    + inverse_square_log_prior(nu, scale=25.0))

    log_post, u_to_theta = make_profiled_rho_nu_posterior(
        points, z, X, log10_eta_bounds=log10_eta_bounds,
        log10_rho_bounds=log10_rho_bounds, nu_bounds=nu_bounds,
        log_prior=log_prior, eta_grid=eta_grid,
        golden_iters=golden_iters)

    rng = jax.random.PRNGKey(key)
    k_init, k_run = jax.random.split(rng)
    init = 0.5 * jax.random.normal(k_init, (num_chains, 2))
    init = jnp.asarray(init, dtype=jnp.result_type(0.0))

    res = hmc_sample(log_post, init, k_run, num_samples=num_samples,
                     num_warmup=num_warmup, num_leapfrog=num_leapfrog,
                     grad_mode="fwd", chunk_steps=chunk_steps)
    return res._replace(samples=u_to_theta(res.samples))


def sample_posterior_rho_nu_large(points, z, X, num_chains=64,
                                  num_samples=500, num_warmup=300,
                                  num_leapfrog=16, key=0,
                                  log_prior="reference", mesh=None,
                                  log10_eta_bounds=(0.5, 4.0),
                                  log10_rho_bounds=(-1.2, -0.3),
                                  nu_bounds=(1.0, 25.0),
                                  surface=None, surface_kwargs=None,
                                  resume_state=None, verbose=False):
    """HMC over the FULL (log10 eta, log10 rho, nu) posterior at LARGE n
    — the amortized counterpart of sample_posterior_nu, built on the 2-D
    tensor-node FFT surface
    (:class:`gppe_tpu.models.krylov_posterior.KrylovPosteriorSurfaceRhoNu`;
    requires regular-grid points, every reference benchmark config).
    All O(n log n) work happens once at surface construction; each
    leapfrog gradient afterwards is tiny Ritz math independent of n, so
    nu-inference at n = 10^5+ costs what the reference's n = 900 sweep
    costs it (reference examples/FindOptimalCovarianceParameters.py:
    664-666 — its nu machinery tops out there).

    ``log_prior="reference"``: the golden pickle's priors —
    inverse-square on rho and on nu/25 (reference :119-146); None for
    flat-in-box; or a callable ``log_prior(eta, rho, nu)`` in natural
    parameters. Returns ``(HMCResult, surface)`` with samples
    (S, C, 3) in (log10 eta, log10 rho, nu)."""
    from .krylov_posterior import KrylovPosteriorSurfaceRhoNu
    from .priors import inverse_square_log_prior

    if log_prior == "reference":
        def log_prior(eta, rho, nu):  # noqa: F811
            return (inverse_square_log_prior(rho)
                    + inverse_square_log_prior(nu, scale=25.0))

    if surface is None:
        surface = KrylovPosteriorSurfaceRhoNu(
            points, z, X, log10_rho_bounds=log10_rho_bounds,
            nu_bounds=nu_bounds, verbose=verbose,
            **(surface_kwargs or {}))
    log_post, u_to_theta = surface.make_bounded_log_posterior(
        log10_eta_bounds=log10_eta_bounds, log_prior=log_prior)

    if resume_state is not None:
        res = resume_hmc(log_post, resume_state, num_samples,
                         num_leapfrog=num_leapfrog)
        return res._replace(samples=u_to_theta(res.samples)), surface

    rng = jax.random.PRNGKey(key)
    k_init, k_run = jax.random.split(rng)
    init = 0.5 * jax.random.normal(k_init, (num_chains, 3),
                                   dtype=jnp.float64)
    if mesh is not None:
        from ..parallel.mesh import PROBE_AXIS
        sharding = jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(PROBE_AXIS, None))
        init = jax.device_put(init, sharding)

    res = hmc_sample(log_post, init, k_run, num_samples=num_samples,
                     num_warmup=num_warmup, num_leapfrog=num_leapfrog)
    return res._replace(samples=u_to_theta(res.samples)), surface


def sample_posterior_large(points, z, X, nu=0.5, num_chains=64,
                           num_samples=500, num_warmup=300, num_leapfrog=16,
                           key=0, log_prior=None, mesh=None,
                           log10_eta_bounds=(-3.0, 3.0),
                           log10_rho_bounds=(-1.5, -0.5),
                           surface=None, surface_kwargs=None,
                           resume_state=None, verbose=False):
    """HMC posterior over (log10 eta, log10 rho) at LARGE N — the
    matrix-free path for BASELINE config 5 (NUTS/HMC, hundreds of
    chains, N ~ 10^5-2*10^5; reference outer-loop counterpart:
    examples/FindOptimalCovarianceParameters.py:632-702).

    The target is an amortized Krylov surface
    (:class:`gppe_tpu.models.krylov_posterior.KrylovPosteriorSurface`):
    all O(n) work happens ONCE at construction (B rho nodes x one fused
    Lanczos pass each); every leapfrog gradient step afterwards is tiny
    elementwise Ritz math, so chain count and chain length are
    essentially free on one chip. Returns ``(HMCResult, surface)`` —
    keep the surface to resume (``resume_state``) or to draw more
    samples without paying the setup again. Sampling always runs in
    unconstrained sigmoid coordinates over the
    (log10_eta_bounds x log10_rho_bounds) box (rho cannot leave the
    surface's interpolated node range).
    """
    from .krylov_posterior import KrylovPosteriorSurface

    if surface is None:
        surface = KrylovPosteriorSurface(
            points, z, X, nu=nu, log10_rho_bounds=log10_rho_bounds,
            verbose=verbose, **(surface_kwargs or {}))
    log_post, u_to_theta = surface.make_bounded_log_posterior(
        log10_eta_bounds=log10_eta_bounds, log_prior=log_prior)

    if resume_state is not None:
        res = resume_hmc(log_post, resume_state, num_samples,
                         num_leapfrog=num_leapfrog)
        return res._replace(samples=u_to_theta(res.samples)), surface

    rng = jax.random.PRNGKey(key)
    k_init, k_run = jax.random.split(rng)
    init = 0.5 * jax.random.normal(k_init, (num_chains, 2),
                                   dtype=jnp.float64)
    if mesh is not None:
        from ..parallel.mesh import PROBE_AXIS
        sharding = jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(PROBE_AXIS, None))
        init = jax.device_put(init, sharding)

    res = hmc_sample(log_post, init, k_run, num_samples=num_samples,
                     num_warmup=num_warmup, num_leapfrog=num_leapfrog)
    return res._replace(samples=u_to_theta(res.samples)), surface
