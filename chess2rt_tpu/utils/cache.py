"""Persistent XLA compile cache for the entry points (CLI, bench.py,
chip_smoke.py).

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing.  Otherwise the cache lives at a fixed ``.jax_cache/``
inside the checkout (git-ignored): a fixed path, because the directory is
part of what makes a later run find the entries again.
"""

from __future__ import annotations

import os
import pathlib

CHECKOUT_CACHE = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir() -> str:
    """The directory the compile cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(CHECKOUT_CACHE)


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on (call it before the first
    compile); returns the directory it uses."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
