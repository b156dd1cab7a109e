"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (the CLI, bench.py, chip_smoke.py): when
``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and nothing here
overrides it; otherwise the cache lives at ``<checkout>/.jax_cache`` (listed
in ``.gitignore``). A fixed path matters because the path is part of what a
cache entry is found by: a directory that moves never hits.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
