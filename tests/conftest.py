"""Test configuration: run on a virtual 8-device CPU mesh with float64.

The suite runs without a GPU, so sharding tests use
`xla_force_host_platform_device_count=8` to get a multi-device mesh. Parity
tests (1e-6 relative chi2 vs the float64 NumPy oracle) run in x64 on the
CPU. The GPU path (float32, one card or four) is driven by chip_smoke.py and
bench.py, not by this suite.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

# Also pin the platform through jax.config, in case jax was imported before
# this file set the environment variable.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
