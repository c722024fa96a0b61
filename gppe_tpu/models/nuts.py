"""No-U-Turn sampler (NUTS) over kernel hyperparameters, chain-parallel.

Dynamic-trajectory upgrade of gppe_tpu.models.hmc: trajectory lengths
adapt per step by tree doubling until the trajectory makes a U-turn
(Hoffman & Gelman 2014, with the multinomial state sampling and
generalized U-turn criterion of Betancourt 2017). The Bayesian
counterpart of the reference's grid/MAP outer loop
(reference: examples/FindOptimalCovarianceParameters.py).

Accelerator design constraints drive the implementation:

* XLA needs static control flow, so the recursive tree build is
  expressed ITERATIVELY: a ``lax.while_loop`` over tree doublings with an
  inner ``lax.while_loop`` over the new subtree's leaves, using an
  O(max_depth) checkpoint stack of momenta for the sub-U-turn checks
  (the standard iterative formulation of NUTS used by JAX-native PPLs;
  leaf -> checkpoint indexing via popcount/trailing-ones bit arithmetic).
* chains are a vmapped batch axis (vmap of while_loop runs all chains
  until the slowest terminates — the batch lanes are cheap), and
  the chain axis shards over the mesh like hmc.sample_posterior.
* warmup adaptation matches hmc.py: dual-averaging step size on the
  per-trajectory mean acceptance statistic, Welford diagonal mass.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

_MAX_DELTA_ENERGY = 1000.0   # divergence threshold (Stan's default)


class NUTSResult(NamedTuple):
    samples: jnp.ndarray        # (num_samples, chains, dim)
    log_probs: jnp.ndarray      # (num_samples, chains)
    accept_rate: jnp.ndarray    # (chains,) mean acceptance statistic
    step_size: jnp.ndarray      # (chains,)
    inv_mass: jnp.ndarray       # (chains, dim)
    mean_tree_depth: jnp.ndarray  # (chains,)
    divergences: jnp.ndarray    # (chains,) count in the sampling phase
    final_theta: jnp.ndarray    # (chains, dim) raw (unconstrained) state
    final_key: jnp.ndarray      # PRNG key after the last step

    def state(self):
        """Chain state for checkpoint/resume (same contract as
        hmc.HMCResult.state): a num_warmup=0 restart with the adapted
        step size and mass matrix continues the chain the uninterrupted
        scan would have produced — see :func:`resume_nuts`."""
        return {
            "theta": self.final_theta,
            "key": self.final_key,
            "step_size": self.step_size,
            "inv_mass": self.inv_mass,
        }


def _popcount(n):
    """Number of set bits of a non-negative int32 scalar."""
    def body(carry):
        v, c = carry
        return (v >> 1, c + (v & 1))
    _, count = jax.lax.while_loop(lambda carry: carry[0] > 0, body, (n, 0))
    return count


def _trailing_ones(n):
    def body(carry):
        v, c = carry
        return (v >> 1, c + 1)
    _, count = jax.lax.while_loop(lambda carry: (carry[0] & 1) == 1, body,
                                  (n, 0))
    return count


def _is_turning(r_left, r_right, r_sum, inv_mass):
    """Generalized U-turn criterion (Betancourt 2017, app. A.4.2)."""
    rho = r_sum - 0.5 * (r_left + r_right)
    turn_l = jnp.dot(inv_mass * r_left, rho) <= 0.0
    turn_r = jnp.dot(inv_mass * r_right, rho) <= 0.0
    return jnp.logical_or(turn_l, turn_r)


def _leapfrog(vg_fn, z, r, grad, eps, inv_mass):
    """One velocity-Verlet step; returns (z, r, lp, grad)."""
    r_half = r + 0.5 * eps * grad
    z_new = z + eps * inv_mass * r_half
    lp_new, grad_new = vg_fn(z_new)
    r_new = r_half + 0.5 * eps * grad_new
    return z_new, r_new, lp_new, grad_new


class _TreeState(NamedTuple):
    # endpoints (leftmost / rightmost in trajectory time)
    z_left: jnp.ndarray
    r_left: jnp.ndarray
    grad_left: jnp.ndarray
    z_right: jnp.ndarray
    r_right: jnp.ndarray
    grad_right: jnp.ndarray
    # multinomial proposal
    z_prop: jnp.ndarray
    lp_prop: jnp.ndarray
    grad_prop: jnp.ndarray
    log_weight: jnp.ndarray      # logsumexp of -energy over tree leaves
    r_sum: jnp.ndarray           # sum of momenta over tree leaves
    depth: jnp.ndarray
    turning: jnp.ndarray
    diverging: jnp.ndarray
    sum_accept: jnp.ndarray      # sum of per-leaf accept probabilities
    num_leaves: jnp.ndarray
    key: jnp.ndarray


def _nuts_transition(vg_fn, z0, lp0, grad0, key, eps, inv_mass, max_depth):
    """One NUTS update for a single chain. Returns
    (z, lp, grad, accept_stat, depth, diverged)."""
    dim = z0.shape[0]
    dtype = z0.dtype
    key, k_mo = jax.random.split(key)
    r0 = jax.random.normal(k_mo, (dim,), dtype) / jnp.sqrt(inv_mass)
    energy0 = -lp0 + 0.5 * jnp.sum(r0 * r0 * inv_mass)
    # a chain initialized outside the posterior support has lp0 = -inf;
    # keep the energies finite so NaNs cannot poison the adaptation
    energy0 = jnp.where(jnp.isfinite(energy0), energy0,
                        jnp.asarray(jnp.inf, dtype))

    def build_subtree(state, direction):
        """Expand the tree by 2^depth leaves in ``direction``; returns the
        new subtree (as a _TreeState rooted at the expansion start)."""
        num = jnp.int32(2) ** state.depth
        eps_d = eps * direction.astype(dtype)

        # start from the moving endpoint
        z_e = jnp.where(direction > 0, state.z_right, state.z_left)
        r_e = jnp.where(direction > 0, state.r_right, state.r_left)
        g_e = jnp.where(direction > 0, state.grad_right, state.grad_left)

        r_ckpts = jnp.zeros((max_depth, dim), dtype)
        rsum_ckpts = jnp.zeros((max_depth, dim), dtype)

        init = dict(
            leaf=jnp.int32(0), z=z_e, r=r_e, grad=g_e,
            z_first=z_e, r_first=r_e, grad_first=g_e,
            z_prop=z_e, lp_prop=-jnp.inf * jnp.ones((), dtype),
            grad_prop=g_e,
            log_weight=-jnp.inf * jnp.ones((), dtype),
            r_sum=jnp.zeros((dim,), dtype),
            sum_accept=jnp.zeros((), dtype),
            turning=jnp.zeros((), bool), diverging=jnp.zeros((), bool),
            r_ckpts=r_ckpts, rsum_ckpts=rsum_ckpts, key=state.key)

        def leaf_cond(s):
            return jnp.logical_and(
                s["leaf"] < num,
                jnp.logical_not(jnp.logical_or(s["turning"],
                                               s["diverging"])))

        def leaf_body(s):
            n = s["leaf"]
            z, r, lp, grad = _leapfrog(vg_fn, s["z"], s["r"], s["grad"],
                                       eps_d, inv_mass)
            energy = -lp + 0.5 * jnp.sum(r * r * inv_mass)
            energy = jnp.where(jnp.isnan(energy), jnp.inf, energy)
            delta = energy - energy0
            delta = jnp.where(jnp.isnan(delta), jnp.inf, delta)  # inf - inf
            diverging = delta > _MAX_DELTA_ENERGY
            accept = jnp.minimum(1.0, jnp.exp(-delta))

            # multinomial progressive sampling within the subtree
            w_leaf = -energy
            log_weight = jnp.logaddexp(s["log_weight"], w_leaf)
            key, k_u = jax.random.split(s["key"])
            take = (jnp.log(jax.random.uniform(k_u, dtype=dtype))
                    < w_leaf - log_weight)
            z_prop = jnp.where(take, z, s["z_prop"])
            lp_prop = jnp.where(take, lp, s["lp_prop"])
            grad_prop = jnp.where(take, grad, s["grad_prop"])

            r_sum = s["r_sum"] + r

            # checkpoint bookkeeping for sub-U-turn checks
            idx_max = _popcount(n >> 1)
            even = (n % 2) == 0
            r_ckpts = jnp.where(
                even, s["r_ckpts"].at[idx_max].set(r), s["r_ckpts"])
            rsum_ckpts = jnp.where(
                even, s["rsum_ckpts"].at[idx_max].set(r_sum),
                s["rsum_ckpts"])

            # at odd leaves, check every aligned subtree that closes here
            idx_min = idx_max - _trailing_ones(n) + 1

            def check_turn(i, turning):
                in_range = jnp.logical_and(i >= idx_min, i <= idx_max)
                r_l = s["r_ckpts"][i]
                subtree_sum = r_sum - s["rsum_ckpts"][i] + r_l
                t = _is_turning(r_l, r, subtree_sum, inv_mass)
                return jnp.logical_or(turning,
                                      jnp.logical_and(in_range, t))

            turning_now = jax.lax.cond(
                even,
                lambda: jnp.zeros((), bool),
                lambda: jax.lax.fori_loop(0, max_depth, check_turn,
                                          jnp.zeros((), bool)))

            return dict(
                leaf=n + 1, z=z, r=r, grad=grad,
                z_first=jnp.where(n == 0, z, s["z_first"]),
                r_first=jnp.where(n == 0, r, s["r_first"]),
                grad_first=jnp.where(n == 0, grad, s["grad_first"]),
                z_prop=z_prop, lp_prop=lp_prop, grad_prop=grad_prop,
                log_weight=log_weight, r_sum=r_sum,
                sum_accept=s["sum_accept"] + accept,
                turning=jnp.logical_or(s["turning"], turning_now),
                diverging=jnp.logical_or(s["diverging"], diverging),
                r_ckpts=r_ckpts, rsum_ckpts=rsum_ckpts, key=key)

        out = jax.lax.while_loop(leaf_cond, leaf_body, init)

        # orient the subtree endpoints in trajectory time
        fwd = direction > 0
        pick = lambda a, b: jnp.where(fwd, a, b)  # noqa: E731
        return _TreeState(
            z_left=pick(out["z_first"], out["z"]),
            r_left=pick(out["r_first"], out["r"]),
            grad_left=pick(out["grad_first"], out["grad"]),
            z_right=pick(out["z"], out["z_first"]),
            r_right=pick(out["r"], out["r_first"]),
            grad_right=pick(out["grad"], out["grad_first"]),
            z_prop=out["z_prop"], lp_prop=out["lp_prop"],
            grad_prop=out["grad_prop"], log_weight=out["log_weight"],
            r_sum=out["r_sum"], depth=state.depth,
            turning=out["turning"], diverging=out["diverging"],
            sum_accept=out["sum_accept"],
            num_leaves=out["leaf"], key=out["key"])

    tree0 = _TreeState(
        z_left=z0, r_left=r0, grad_left=grad0,
        z_right=z0, r_right=r0, grad_right=grad0,
        z_prop=z0, lp_prop=lp0, grad_prop=grad0,
        log_weight=(-energy0).astype(dtype), r_sum=r0,
        depth=jnp.int32(0), turning=jnp.zeros((), bool),
        diverging=jnp.zeros((), bool),
        sum_accept=jnp.zeros((), dtype), num_leaves=jnp.int32(0),
        key=key)

    def doubling_cond(tree):
        ok = jnp.logical_not(jnp.logical_or(tree.turning, tree.diverging))
        return jnp.logical_and(tree.depth < max_depth, ok)

    def doubling_body(tree):
        key, k_dir, k_acc = jax.random.split(tree.key, 3)
        direction = jnp.where(
            jax.random.bernoulli(k_dir), jnp.int32(1), jnp.int32(-1))
        sub = build_subtree(tree._replace(key=key), direction)

        # biased progressive: move proposal to the new subtree
        sub_ok = jnp.logical_not(jnp.logical_or(sub.turning, sub.diverging))
        log_ratio = sub.log_weight - tree.log_weight
        take = jnp.logical_and(
            sub_ok,
            jnp.log(jax.random.uniform(k_acc, dtype=dtype)) < log_ratio)
        z_prop = jnp.where(take, sub.z_prop, tree.z_prop)
        lp_prop = jnp.where(take, sub.lp_prop, tree.lp_prop)
        grad_prop = jnp.where(take, sub.grad_prop, tree.grad_prop)

        fwd = direction > 0
        pick = lambda new, old: jnp.where(fwd, new, old)  # noqa: E731
        z_left = pick(tree.z_left, sub.z_left)
        r_left = pick(tree.r_left, sub.r_left)
        grad_left = pick(tree.grad_left, sub.grad_left)
        z_right = pick(sub.z_right, tree.z_right)
        r_right = pick(sub.r_right, tree.r_right)
        grad_right = pick(sub.grad_right, tree.grad_right)

        r_sum = tree.r_sum + sub.r_sum
        turning_whole = _is_turning(r_left, r_right, r_sum, inv_mass)
        turning = jnp.logical_or(
            sub.turning,
            jnp.logical_and(sub_ok, turning_whole))

        return _TreeState(
            z_left=z_left, r_left=r_left, grad_left=grad_left,
            z_right=z_right, r_right=r_right, grad_right=grad_right,
            z_prop=z_prop, lp_prop=lp_prop, grad_prop=grad_prop,
            log_weight=jnp.logaddexp(tree.log_weight, sub.log_weight),
            r_sum=r_sum, depth=tree.depth + 1, turning=turning,
            diverging=sub.diverging,
            sum_accept=tree.sum_accept + sub.sum_accept,
            num_leaves=tree.num_leaves + sub.num_leaves, key=sub.key)

    tree = jax.lax.while_loop(doubling_cond, doubling_body, tree0)

    grad_prop = tree.grad_prop
    accept_stat = tree.sum_accept / jnp.maximum(
        tree.num_leaves.astype(dtype), 1.0)
    return (tree.z_prop, tree.lp_prop, grad_prop, accept_stat,
            tree.depth, tree.diverging)


@partial(jax.jit,
         static_argnames=("log_prob_fn", "num_samples", "num_warmup",
                          "max_depth"))
def nuts_sample(log_prob_fn, init_theta, key, num_samples=1000,
                num_warmup=500, max_depth=10, init_step_size=0.1,
                target_accept=0.8, init_inv_mass=None):
    """Run NUTS. ``init_theta``: (chains, dim); ``log_prob_fn`` maps
    (dim,) -> scalar. Returns NUTSResult. Warmup adaptation (dual
    averaging + Welford diagonal mass) mirrors hmc.hmc_sample.

    ``init_step_size`` may be a scalar or per-chain (chains,) array and
    ``init_inv_mass`` a (chains, dim) diagonal inverse-mass: passing a
    saved ``NUTSResult.state()`` with ``num_warmup=0`` continues the
    chain (see :func:`resume_nuts`)."""
    chains, dim = init_theta.shape
    dtype = init_theta.dtype

    _vg = jax.value_and_grad(log_prob_fn)

    def vg_fn(z):
        # the target may compute (and return) in a different precision
        # than the sampler state (e.g. f32 likelihood under x64); keep the
        # scan carries in the state dtype
        v, g = _vg(z)
        return v.astype(dtype), g.astype(dtype)

    lp0, grad0 = jax.vmap(vg_fn)(init_theta)

    iss = jnp.broadcast_to(jnp.asarray(init_step_size, dtype), (chains,))
    mu = jnp.log(10.0 * iss)
    log_eps = jnp.log(iss)
    # log_eps_bar starts at log(init_step_size): warmup overwrites it on
    # the first dual-averaging step (eta_1 = 1), and with num_warmup = 0
    # it IS the fixed post-warmup step size — the resume contract (the
    # old zero init silently reset resumed runs to eps = 1)
    log_eps_bar = jnp.log(iss)
    h_bar = jnp.zeros(chains, dtype)
    gamma, t0, kappa = 0.05, 10.0, 0.75

    w_mean = jnp.zeros((chains, dim), dtype)
    w_m2 = jnp.zeros((chains, dim), dtype)
    if init_inv_mass is None:
        inv_mass0 = jnp.ones((chains, dim), dtype)
    else:
        inv_mass0 = jnp.broadcast_to(
            jnp.asarray(init_inv_mass, dtype), (chains, dim))

    total = num_warmup + num_samples

    transition = jax.vmap(
        lambda z, lp, g, k, e, im: _nuts_transition(
            vg_fn, z, lp, g, k, e, im, max_depth))

    def step(carry, it):
        (theta, lp, grad, key, log_eps, log_eps_bar, h_bar, w_mean, w_m2,
         inv_mass, sum_accept, sum_depth, n_div) = carry
        key, k_tr = jax.random.split(key)
        keys = jax.random.split(k_tr, chains)
        eps = jnp.exp(log_eps)

        theta, lp, grad, accept_stat, depth, diverged = transition(
            theta, lp, grad, keys, eps, inv_mass)

        in_warmup = it < num_warmup
        # --- dual averaging on the mean-acceptance statistic -------------
        t = it.astype(dtype) + 1.0
        h_bar_n = ((1.0 - 1.0 / (t + t0)) * h_bar
                   + (target_accept - accept_stat) / (t + t0))
        log_eps_n = mu - jnp.sqrt(t) / gamma * h_bar_n
        eta_t = t ** (-kappa)
        log_eps_bar_n = eta_t * log_eps_n + (1 - eta_t) * log_eps_bar
        log_eps = jnp.where(in_warmup, log_eps_n, log_eps_bar)
        log_eps_bar = jnp.where(in_warmup, log_eps_bar_n, log_eps_bar)
        h_bar = jnp.where(in_warmup, h_bar_n, h_bar)

        # --- Welford mass accumulation over the 2nd warmup half ----------
        in_window = jnp.logical_and(it >= num_warmup // 2, in_warmup)
        cnt = jnp.maximum(it - num_warmup // 2 + 1, 1).astype(dtype)
        delta = theta - w_mean
        w_mean_n = w_mean + delta / cnt
        w_m2_n = w_m2 + delta * (theta - w_mean_n)
        w_mean = jnp.where(in_window, w_mean_n, w_mean)
        w_m2 = jnp.where(in_window, w_m2_n, w_m2)
        var = w_m2 / jnp.maximum(cnt - 1.0, 1.0)
        var = jnp.where(var > 1e-10, var, 1.0)
        inv_mass = jnp.where(it == num_warmup - 1, var, inv_mass)

        post = it >= num_warmup
        sum_accept = sum_accept + jnp.where(post, accept_stat, 0.0)
        sum_depth = sum_depth + jnp.where(post, depth.astype(dtype), 0.0)
        n_div = n_div + jnp.where(post, diverged.astype(dtype), 0.0)

        carry = (theta, lp, grad, key, log_eps, log_eps_bar, h_bar,
                 w_mean, w_m2, inv_mass, sum_accept, sum_depth, n_div)
        return carry, (theta, lp)

    carry0 = (init_theta, lp0, grad0, key, log_eps, log_eps_bar, h_bar,
              w_mean, w_m2, inv_mass0, jnp.zeros(chains, dtype),
              jnp.zeros(chains, dtype), jnp.zeros(chains, dtype))
    carry, (thetas, lps) = jax.lax.scan(step, carry0, jnp.arange(total))
    (theta, lp, grad, key, log_eps, log_eps_bar, h_bar, w_mean, w_m2,
     inv_mass, sum_accept, sum_depth, n_div) = carry
    return NUTSResult(samples=thetas[num_warmup:],
                      log_probs=lps[num_warmup:],
                      accept_rate=sum_accept / num_samples,
                      step_size=jnp.exp(log_eps),
                      inv_mass=inv_mass,
                      mean_tree_depth=sum_depth / num_samples,
                      divergences=n_div,
                      final_theta=theta,
                      final_key=key)


def resume_nuts(log_prob_fn, state, num_samples, max_depth=10):
    """Continue NUTS chains from a saved ``NUTSResult.state()`` dict —
    no warmup, adaptation frozen at the saved step size / inverse mass
    (the parity counterpart of hmc.resume_hmc; utils.checkpoint
    save_hmc_state/load_hmc_state round-trip this state too)."""
    return nuts_sample(log_prob_fn, jnp.asarray(state["theta"]),
                       jnp.asarray(state["key"]),
                       num_samples=num_samples, num_warmup=0,
                       max_depth=max_depth,
                       init_step_size=jnp.asarray(state["step_size"]),
                       init_inv_mass=jnp.asarray(state["inv_mass"]))


def sample_posterior(points, z, X, nu=0.5, num_chains=8, num_samples=500,
                     num_warmup=300, max_depth=8, key=0, init=None,
                     log_prior=None, mesh=None, support_log10=None,
                     resume_state=None):
    """NUTS over the (log10 eta, log10 rho) posterior of a GP dataset —
    the adaptive-trajectory counterpart of hmc.sample_posterior.

    ``support_log10``: optional ((lo, hi), (lo, hi)) log10 box; when given,
    sampling runs in unconstrained sigmoid-transformed coordinates (no
    boundary divergences) and the returned samples are mapped back to
    (log10 eta, log10 rho). ``init`` is then in the unconstrained space.
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
        res = resume_nuts(log_post, resume_state, num_samples,
                          max_depth=max_depth)
        if u_to_theta is not None:
            res = res._replace(samples=u_to_theta(res.samples))
        return res

    rng = jax.random.PRNGKey(key)
    k_init, k_run = jax.random.split(rng)
    if init is None:
        if support_log10 is not None:
            init = 0.5 * jax.random.normal(k_init, (num_chains, 2))
        else:
            base = jnp.asarray([1.0, -1.0])
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

    res = nuts_sample(log_post, init, k_run, num_samples=num_samples,
                      num_warmup=num_warmup, max_depth=max_depth)
    if u_to_theta is not None:
        res = res._replace(samples=u_to_theta(res.samples))
    return res


def sample_posterior_large(points, z, X, nu=0.5, num_chains=64,
                           num_samples=500, num_warmup=300, max_depth=8,
                           key=0, log_prior=None, mesh=None,
                           log10_eta_bounds=(-3.0, 3.0),
                           log10_rho_bounds=(-1.5, -0.5),
                           surface=None, surface_kwargs=None,
                           resume_state=None, verbose=False):
    """NUTS posterior over (log10 eta, log10 rho) at LARGE N — BASELINE
    config 5 verbatim ("NUTS, hundreds of chains, N ~ 10^5-2*10^5";
    reference outer-loop counterpart:
    examples/FindOptimalCovarianceParameters.py:632-702).

    The target is the amortized matrix-free Krylov surface
    (models.krylov_posterior.KrylovPosteriorSurface): all O(n) work runs
    once at construction; every tree leaf afterwards is tiny Ritz math,
    so the adaptive trajectories cost the same as at n = 400. Returns
    ``(NUTSResult, surface)`` — reuse the surface to draw more samples
    without paying the setup again. Sampling runs in unconstrained
    sigmoid coordinates over the (log10_eta_bounds x log10_rho_bounds)
    box (rho cannot leave the surface's interpolated node range)."""
    from .krylov_posterior import KrylovPosteriorSurface

    if surface is None:
        surface = KrylovPosteriorSurface(
            points, z, X, nu=nu, log10_rho_bounds=log10_rho_bounds,
            verbose=verbose, **(surface_kwargs or {}))
    log_post, u_to_theta = surface.make_bounded_log_posterior(
        log10_eta_bounds=log10_eta_bounds, log_prior=log_prior)

    if resume_state is not None:
        res = resume_nuts(log_post, resume_state, num_samples,
                          max_depth=max_depth)
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

    res = nuts_sample(log_post, init, k_run, num_samples=num_samples,
                      num_warmup=num_warmup, max_depth=max_depth)
    return res._replace(samples=u_to_theta(res.samples)), surface


def sample_posterior_rho_nu_large(points, z, X, num_chains=64,
                                  num_samples=500, num_warmup=300,
                                  max_depth=8, key=0,
                                  log_prior="reference", mesh=None,
                                  log10_eta_bounds=(0.5, 4.0),
                                  log10_rho_bounds=(-1.2, -0.3),
                                  nu_bounds=(1.0, 25.0),
                                  surface=None, surface_kwargs=None,
                                  resume_state=None, verbose=False):
    """NUTS over the FULL (log10 eta, log10 rho, nu) posterior at LARGE
    n — the adaptive-trajectory counterpart of
    hmc.sample_posterior_rho_nu_large, on the same tensor-node FFT
    surface (models.krylov_posterior.KrylovPosteriorSurfaceRhoNu;
    regular-grid points). All O(n log n) work amortizes into the
    surface; every tree leaf afterwards is n-independent Ritz math.
    See the surface class docstring for the eta-box trust region.
    Returns ``(NUTSResult, surface)`` with samples (S, C, 3)."""
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
        res = resume_nuts(log_post, resume_state, num_samples,
                          max_depth=max_depth)
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

    res = nuts_sample(log_post, init, k_run, num_samples=num_samples,
                      num_warmup=num_warmup, max_depth=max_depth)
    return res._replace(samples=u_to_theta(res.samples)), surface
