"""Persistent XLA compilation cache for the entry points that run on the
GPU (chip_smoke.py, bench.py and the example drivers).

Called by those entry points, never at package import: tests and library
users keep JAX's own default.
"""

from __future__ import annotations

import os
import pathlib

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Returns the cache directory in use.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
    other directory is set here.  Otherwise the cache goes to the fixed
    path ``<repo>/.jax_cache`` (git-ignored): the path is part of what a
    later run looks up, so it never moves.
    """
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
