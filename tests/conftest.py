"""Test configuration: run on a virtual 8-device CPU mesh with x64.

The multi-device tests emulate a multi-accelerator mesh on CPU
(xla_force_host_platform_device_count), the standard JAX substitute for
testing sharding without real devices.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # unit tests always run on the CPU mesh
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

from gppe_tpu.utils.config import compile_cache_dir  # noqa: E402

jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
