"""Persistent XLA compilation cache.

The 1M-particle rollout costs tens of seconds of XLA compilation on first
run (every compile is a fresh trace of a large scan body). The reference has
no equivalent concern (HLSL compiles in milliseconds at load,
SphFluidSimulation.cs:126-133); ours is recovered by JAX's persistent
compilation cache, enabled here for every CLI/bench entry point so only the
first run of a given (shape, backend) combination pays the compile.

Placement: where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself
and this module sets no other directory. Otherwise the cache lives at a
fixed path inside the checkout (``<repo>/.jax_cache``, git-ignored): the
path is part of the cache key, so it never depends on ``$HOME``, a
temporary name, a process id or the time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get(ENV_VAR) or REPO_CACHE_DIR


def enable_compilation_cache() -> str:
    """Enable the persistent compilation cache (idempotent). Returns the
    cache directory used."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # Cache everything that takes noticeable time; entries are content-hashed.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
