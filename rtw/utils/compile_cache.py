"""Persistent XLA compile cache location.

`JAX_COMPILATION_CACHE_DIR`, when set, is honoured as JAX reads it and no
other cache is configured.  Otherwise the cache lives at the fixed path
`<checkout>/.jax_cache` (listed in .gitignore), a path with no temp name,
pid or time in it, so a later run finds what an earlier one compiled.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENV = "JAX_COMPILATION_CACHE_DIR"


def cache_dir() -> str:
    return os.environ.get(ENV) or os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at `cache_dir()`; returns it."""
    path = cache_dir()
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
