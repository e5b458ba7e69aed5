"""Placement of JAX's persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
nothing here overrides it.  Otherwise the cache lives at a fixed
``<checkout>/.jax_cache`` (listed in ``.gitignore``), so every script run
from one checkout shares it; the path is part of the cache key, so it
must not move between runs.
"""

from __future__ import annotations

import os
import pathlib

import jax

__all__ = ["CHECKOUT_CACHE_DIR", "enable_compile_cache"]

CHECKOUT_CACHE_DIR = str(pathlib.Path(__file__).resolve().parents[2]
                         / ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
