"""Test environment: the CPU with 8 virtual devices, so sharding tests run
on a virtual mesh without accelerator hardware.

Must run before the first `import jax` anywhere in the test session.
Code that only the GPU can run is checked on the card by
``python chip_smoke.py`` (README "Testing"); a test of such code carries
the ``gpu`` marker (pyproject.toml).
"""

import os

# Force-set (not setdefault): a machine with a GPU would otherwise pick it,
# and the bit-exactness pins are CPU pins.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

assert jax.default_backend() == "cpu", (
    "tests must run on CPU; got " + jax.default_backend())

