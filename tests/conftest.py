"""Test configuration: an 8-device virtual CPU platform.

Multi-device sharding is tested without accelerators the standard way:
`--xla_force_host_platform_device_count=8`.  Must run before jax
initializes, hence the env mutation at import time.  ``VT_TEST_GPU=1``
leaves JAX's platform alone, so the `gpu`-marked tests run on a card:

    VT_TEST_GPU=1 python -m pytest tests -m gpu
"""

import os

ON_GPU = os.environ.get("VT_TEST_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
# Persistent compile cache in the checkout (utils/compile_cache.py).
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.RandomState(42)
