"""Test configuration: run on a virtual 8-device CPU mesh with float64.

Multi-device sharding paths are validated without accelerators via
``xla_force_host_platform_device_count`` (the standard JAX fake-mesh recipe);
float64 is enabled so convergence-order tests for the 5th-order WENO scheme
aren't limited by the f32 rounding floor.
"""
import os

# The tests run on the CPU: a GPU on the machine is left alone, and the
# virtual 8-device mesh below is a CPU feature.  The config knob is set too
# in case JAX was imported before this file.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

try:
    jax.config.update("jax_platforms", "cpu")
except Exception:  # config name drift across jax versions
    pass
jax.config.update("jax_enable_x64", True)
