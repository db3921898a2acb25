"""Persistent XLA compilation cache for the entry points.

A cold start compiles every rollout program, which on the GPU takes tens
of seconds per program.  JAX can keep compiled programs on disk and find
them again in the next process.  The entry points (the CLI, bench.py,
chip_smoke.py) call :func:`enable_compile_cache` once before they compile
anything; importing the package never touches it.

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX already reads it, and that
  directory is the only one used.
* Otherwise: ``<checkout>/.jax_cache`` -- one fixed path (listed in
  .gitignore), so the next process in the same checkout hits the cache.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    """``<checkout>/.jax_cache``: the directory above the package."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), ".jax_cache")


def compile_cache_dir() -> str:
    """The cache directory the entry points use (env var first)."""
    return os.environ.get(ENV_VAR) or default_cache_dir()


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at
    :func:`compile_cache_dir` and return it."""
    import jax
    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
