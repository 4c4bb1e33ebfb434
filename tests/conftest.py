"""Test configuration: CPU backend with 8 virtual devices, float64.

Tests run on an 8-device virtual CPU mesh (the cheap analog of a
multi-card host — sharding tests exercise the same shard_map code path
that runs on real hardware) in float64, matching the reference's PETSc
double-precision tolerances.

`python -m pytest -m gpu tests/` on a machine with a GPU runs the
card-only tests instead, on the GPU in float32 (the production
precision); each of them skips itself where JAX finds no GPU.
"""
import os


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; run with `python -m pytest -m gpu`")
    if config.getoption("markexpr") == "gpu":
        return
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
