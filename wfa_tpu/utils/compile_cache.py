"""Persistent XLA compilation cache shared by the CLI, bench.py and
chip_smoke.py, so engine compiles survive across processes (the analog of
the reference building its cubins once).

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here overrides it.  Otherwise the cache lives at a fixed ``.jax_cache``
directory in the checkout: the path is part of the cache key, so a
directory that moves between runs would never hit.
"""
from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns the directory in
    use."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
