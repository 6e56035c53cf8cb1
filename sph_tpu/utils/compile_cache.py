"""Persistent XLA compilation cache location.

A process that compiles the pipeline's ~180 programs pays for them once per
machine when the executables land in a persistent cache.  The cache key
includes the directory, so the directory must not move between runs.

`enable_compile_cache()` is the one place that picks it:

* `JAX_COMPILATION_CACHE_DIR` set: JAX already reads it; nothing else is set.
* otherwise: `<checkout>/.jax_cache` (listed in `.gitignore`), with every
  compiled program eligible for caching.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

# <checkout>/sph_tpu/utils/compile_cache.py -> <checkout>/.jax_cache
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def compile_cache_dir() -> str:
    """The directory the persistent compilation cache lives in."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `compile_cache_dir()`
    and return that directory.  Call before the first compile."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
    return DEFAULT_DIR
