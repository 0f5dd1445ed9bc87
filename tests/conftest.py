"""Test configuration: run JAX on a virtual 8-device CPU mesh with x64 enabled.

The platform is set through jax.config before any backend is touched, so
the suite runs on the CPU even where a GPU is visible; tests that need the
card carry the `gpu` marker and decide inside a fixture (see
tests/test_gpu.py).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if os.environ.get("DYNAMONT_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# persistent compile cache: XLA compiles of the scan-heavy programs dominate
# test runtime; cache them across runs
from dynamont_jax.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
