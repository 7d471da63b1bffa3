"""Persistent XLA compilation cache location, shared by every entry point.

The solver and analysis programs take seconds to compile at reference
scale, so the CLI, the benchmark, the GPU smoke run and the tests all keep
compiled executables on disk. The cache key includes the directory, so the
location is fixed: `JAX_COMPILATION_CACHE_DIR` when the environment sets it
(JAX reads that variable itself and this module then sets nothing), else
`<checkout>/.jax_cache`, which `.gitignore` lists.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its one location and
    return that directory."""
    import jax

    env_dir = os.environ.get(ENV_VAR)
    if env_dir:
        cache_dir = env_dir
    else:
        cache_dir = str(CHECKOUT_CACHE_DIR)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir
