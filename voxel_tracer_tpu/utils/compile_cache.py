"""JAX's persistent compilation cache, shared by every entry point.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and this
sets no other directory.  Otherwise the cache lives in ``<checkout>/.jax_cache``,
resolved from this package's own path, so every process of one checkout
finds the same cache.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable() -> str:
    """Point JAX's persistent compilation cache at `cache_dir()`."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
