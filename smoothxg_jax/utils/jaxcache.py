"""Where JAX keeps its persistent compilation cache.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
set here.  Otherwise the cache goes to `.jax_cache/` at the root of the
checkout (listed in .gitignore): a fixed path, so a later run of the same
checkout finds what an earlier one compiled.
"""
from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at its directory; returns the path."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
