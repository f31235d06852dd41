"""Where the persistent compilation cache lives.

``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads it
itself).  Otherwise the cache goes to one fixed directory inside the
checkout, so a later run of the same checkout finds what an earlier one
compiled.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def cache_dir() -> str:
    return os.environ.get(ENV_VAR) or str(DEFAULT_DIR)


def enable() -> str:
    """Turn the persistent cache on; returns its directory."""
    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
