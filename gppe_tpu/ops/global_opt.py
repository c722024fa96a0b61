"""Global optimization over kernel hyperparameters.

The reference drives scipy's ``differential_evolution(workers=-1)`` (a
process pool) plus a callback-exception early-stopping shim
(reference: examples/FindOptimalCovarianceParameters.py:207-272
MinimizeTerminator/MinimizeTerminated, :347-366 optimizer menu). Here:

* differential evolution runs fully on-device — each generation's
  population is ONE vmapped batch of objective evaluations (batched
  assembly+Cholesky), the whole evolution a ``lax.scan``;
* convergence-based early termination is a mask inside the scan (no
  exceptions needed — the reference used them only because scipy's tol
  semantics were unreliable, :219-230).
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class DEResult(NamedTuple):
    x: jnp.ndarray
    fun: jnp.ndarray
    num_generations: jnp.ndarray
    converged: jnp.ndarray


def differential_evolution(objective, bounds, key, popsize=50,
                           max_generations=200, mutation=0.7,
                           recombination=0.9, tol=1e-6,
                           terminate_atol=0.0):
    if isinstance(key, int):
        key = jax.random.PRNGKey(key)
    return _de_jit(objective, jnp.asarray(bounds), key, popsize,
                   max_generations, mutation, recombination, tol,
                   terminate_atol)


@partial(jax.jit, static_argnames=("objective", "popsize", "max_generations"))
def _de_jit(objective, bounds, key, popsize=50,
            max_generations=200, mutation=0.7,
            recombination=0.9, tol=1e-6,
            terminate_atol=0.0):
    """Minimize ``objective`` (vector -> scalar, jittable) over box
    ``bounds`` (D, 2). best/1/bin scheme; the population evaluates as one
    vmapped batch per generation (the on-device replacement for
    ``workers=-1``, reference :347-349).

    ``terminate_atol``: stop as soon as the best value improves by less
    than this across a generation — the MinimizeTerminator role
    (reference :207-272).
    """
    bounds = jnp.asarray(bounds, dtype=jnp.result_type(0.0))
    dim = bounds.shape[0]
    lo, hi = bounds[:, 0], bounds[:, 1]

    k_init, k_run = jax.random.split(key)
    pop = lo + (hi - lo) * jax.random.uniform(k_init, (popsize, dim))
    fitness = jax.vmap(objective)(pop)

    def gen(carry, _):
        pop, fitness, key, best_prev, done = carry
        key, k1, k2, k3, k4 = jax.random.split(key, 5)
        best_idx = jnp.argmin(fitness)
        best = pop[best_idx]

        # best/1/bin mutation
        r1 = jax.random.randint(k1, (popsize,), 0, popsize)
        r2 = jax.random.randint(k2, (popsize,), 0, popsize)
        mutant = best[None, :] + mutation * (pop[r1] - pop[r2])
        cross = jax.random.uniform(k3, (popsize, dim)) < recombination
        # ensure at least one crossed dimension
        force = jax.nn.one_hot(
            jax.random.randint(k4, (popsize,), 0, dim), dim, dtype=bool)
        cross = jnp.logical_or(cross, force)
        trial = jnp.where(cross, mutant, pop)
        trial = jnp.clip(trial, lo, hi)

        f_trial = jax.vmap(objective)(trial)
        f_trial = jnp.where(jnp.isfinite(f_trial), f_trial, jnp.inf)
        better = f_trial < fitness
        pop = jnp.where(better[:, None], trial, pop)
        fitness = jnp.where(better, f_trial, fitness)

        best_now = jnp.min(fitness)
        improved = best_prev - best_now
        spread = jnp.max(fitness) - best_now
        done_now = jnp.logical_or(spread < tol,
                                  jnp.logical_and(terminate_atol > 0,
                                                  improved < terminate_atol))
        done = jnp.logical_or(done, done_now)
        return (pop, fitness, key, best_now, done), done

    carry0 = (pop, fitness, k_run, jnp.min(fitness), jnp.asarray(False))
    (pop, fitness, key, best_val, done), done_hist = jax.lax.scan(
        gen, carry0, jnp.arange(max_generations))
    # number of generations until first convergence
    gens = jnp.where(jnp.any(done_hist),
                     jnp.argmax(done_hist) + 1, max_generations)
    best_idx = jnp.argmin(fitness)
    return DEResult(x=pop[best_idx], fun=fitness[best_idx],
                    num_generations=gens, converged=done)


class MinimizeTerminator:
    """Host-side convergence watchdog for scipy-style optimizers — the
    reference's callback-exception pattern (:207-272) for code paths that
    do run a host optimizer loop."""

    class Terminated(Exception):
        pass

    def __init__(self, atol=1e-6, patience=2):
        self.atol = atol
        self.patience = patience
        self._last = None
        self._hits = 0
        self.num_calls = 0

    def __call__(self, xk, *args, **kwargs):
        import numpy as np
        self.num_calls += 1
        xk = np.asarray(xk, dtype=float)
        if self._last is not None:
            if np.all(np.abs(xk - self._last) < self.atol):
                self._hits += 1
                if self._hits >= self.patience:
                    raise MinimizeTerminator.Terminated(
                        f"converged after {self.num_calls} callbacks")
            else:
                self._hits = 0
        self._last = xk
        return False
