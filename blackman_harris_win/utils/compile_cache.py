"""Persistent compilation cache location, shared by every entry point.

The cache is keyed partly by its own path, so it lives at one fixed place:
``JAX_COMPILATION_CACHE_DIR`` when the environment sets it (JAX reads that
variable itself, and nothing here overrides it), else ``<repo>/.jax_cache``.
"""

from __future__ import annotations

import os
import pathlib

import jax

REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_CACHE_DIR = REPO_ROOT / ".jax_cache"


def use_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its fixed directory and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
