"""Where JAX keeps its persistent compilation cache.

The RD pre-pass and the own-format codec compile one XLA program per
frame shape, so a cache that hits across processes saves most of a cold
start. `JAX_COMPILATION_CACHE_DIR` wins when it is set (JAX reads it
itself); otherwise the cache lives at one fixed, git-ignored directory
of the checkout, since the path is part of what makes a later run hit.
"""

from __future__ import annotations

import os
import pathlib

DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_DIR)


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at cache_dir(); returns the directory.
    Call before the first compilation of the process."""
    import jax

    d = cache_dir()
    jax.config.update("jax_compilation_cache_dir", d)
    return d
