"""Persistent XLA compilation cache.

Compiling the jitted paths takes seconds to minutes; the persistent cache
makes a restarted process reuse them.  The reference has no analog (nvcc
compiles ahead of time) — this restores that experience.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and this
module sets no other directory.  Otherwise the cache lives at a fixed path
inside the checkout, ``<repo>/.jax_cache`` (listed in ``.gitignore``):
the path is part of what makes a cached entry found again.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compilation_cache() -> str:
    """Idempotent; call before heavy jit use. Returns the cache dir."""
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
