"""Dtype, precision and compile-cache policy.

The reference stack runs float64 everywhere (numpy/scipy defaults). On
the GPU the heavy O(n^2) device math (matvecs, FFTs, Lanczos vectors)
runs in float32 while the precision-critical O(n) reductions and the
likelihood scalars run in float64 (jax x64 mode); on the CPU test backend
everything is float64. Float32 products are pinned to full f32: a GPU may
otherwise run them in TF32, which keeps ~3 decimal digits.
"""

import os

import jax
import jax.numpy as jnp

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_dtype():
    """float64 under jax x64 mode, else float32."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def compute_dtype():
    """Dtype for the heavy device math (assembly, matvecs, Lanczos).

    float32 on the GPU (f32 device math with f64 Lanczos coefficient sums
    and f64 likelihood scalars, see ops.stochastic.lanczos); the x64
    policy elsewhere (float64 on the CPU test backend)."""
    return jnp.float32 if jax.default_backend() == "gpu" else default_dtype()


def inference_dtype():
    """Dtype for the O(n m) likelihood scalars and optimizer loops.

    The profile-likelihood derivative resolves ~1e-6 relative differences
    of O(n) sums; float32 visibly distorts the optimum (eta* 637 vs 87 on
    an f32-only run). Requires jax x64 mode for float64.
    """
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def compile_cache_dir():
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``
    (a fixed path: the directory is part of the cache key)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_REPO_ROOT, ".jax_cache"))


def _enable_cache():
    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def ensure_inference_precision():
    """Enable jax x64 mode and full-f32 products if they are off.

    The inference scalars REQUIRE float64 (see inference_dtype); where the
    user skipped setup(), f32 scalars silently push the profile-likelihood
    root to a spurious boundary optimum (eta* = inf instead of 16.2 at
    n = 400). Called from the likelihood entry points so the public API is
    correct without any setup. Heavy device math is unaffected
    (compute_dtype() stays f32 on the GPU).
    """
    if not jax.config.jax_enable_x64:
        jax.config.update("jax_enable_x64", True)
    if jax.config.jax_default_matmul_precision is None:
        jax.config.update("jax_default_matmul_precision", "highest")
    if not jax.config.jax_compilation_cache_dir:
        _enable_cache()


def setup():
    """Production entrypoint setup: x64 (heavy math stays f32 via
    compute_dtype()), full-f32 products and the persistent compilation
    cache (see compile_cache_dir)."""
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_default_matmul_precision", "highest")
    _enable_cache()


# Backwards-compatible alias
setup_x64 = setup
