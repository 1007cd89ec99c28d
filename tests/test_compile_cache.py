"""The shared compile-cache helper: JAX_COMPILATION_CACHE_DIR wins and no
directory is set in code; without it the cache is <checkout>/.jax_cache."""
from pathlib import Path

import jax

from wfa_tpu.utils import compile_cache


def test_env_var_is_left_to_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_checkout_jax_cache(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = compile_cache.enable_compile_cache()
        expect = Path(__file__).resolve().parent.parent / ".jax_cache"
        assert got == str(expect)
        assert jax.config.jax_compilation_cache_dir == str(expect)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
