"""Where JAX keeps its persistent compilation cache.

Called by the entry points (`run_case.main`, `bench.py`, `chip_smoke.py`),
never at package import. The cache key includes the directory, so the
directory is fixed: `<checkout>/.jax_cache`, unless the environment names
one in `JAX_COMPILATION_CACHE_DIR`, which JAX reads by itself.
"""
from __future__ import annotations

import os

#: the checkout's own cache directory (listed in .gitignore)
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str | None:
    """Point JAX's persistent compilation cache at CACHE_DIR, unless
    JAX_COMPILATION_CACHE_DIR is set. Returns the directory set here, or
    None when the environment decides."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    import jax
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
