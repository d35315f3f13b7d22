"""Persistent XLA compile cache for every entry point (CLI, benchmarks,
chip_smoke.py).

When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here overrides it. Otherwise compiled programs are kept in ``.jax_cache`` at
the root of the checkout, so a second run of the same frame shape loads its
programs instead of recompiling them.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at the checkout (unless the
    environment names a directory) and return the directory in use."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
