"""utils.compile_cache: JAX_COMPILATION_CACHE_DIR wins; otherwise the cache
lives at <checkout>/.cache/jax."""

import jax

from lbaudiodetective.utils import compile_cache


def test_env_var_set_changes_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_env_var_unset_uses_checkout_cache(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = compile_cache.enable_compile_cache()
        want = str(compile_cache.CHECKOUT / ".cache" / "jax")
        assert got == want and jax.config.jax_compilation_cache_dir == want
        assert (compile_cache.CHECKOUT / "lbaudiodetective").is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
