"""Persistent XLA compile cache for the scripts (chip_smoke.py, bench.py,
benchmarks/*.py). The library import never calls this: where a program
keeps its cache is the program's choice."""

from __future__ import annotations

import os

import jax

__all__ = ["enable_compile_cache", "CACHE_ENV"]

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache(root: str | None = None) -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is the directory (JAX reads
    it itself; nothing else is set). Otherwise the cache lives at the
    fixed path ``<root>/.jax_cache`` — ``root`` defaults to the checkout
    that holds this package — never a temporary, pid- or time-derived
    path, since the path is part of the cache key."""
    path = os.environ.get(CACHE_ENV)
    if not path:
        if root is None:
            here = os.path.dirname(os.path.abspath(__file__))
            root = os.path.dirname(os.path.dirname(here))
        path = os.path.join(root, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path
