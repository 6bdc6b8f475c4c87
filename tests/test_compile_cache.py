"""The compile-cache helper: JAX's own env setting wins, else one fixed
directory in the checkout; source paths are kept out of the cache key."""

import jax
import jax.numpy as jnp
import pytest

from lbzip2_tpu import compile_cache

_NAMES = ("jax_compilation_cache_dir", *compile_cache.KEY_SETTINGS)


@pytest.fixture
def keep_config():
    """Restore the settings enable() may change."""
    saved = {n: getattr(jax.config, n) for n in _NAMES}
    yield
    for n, v in saved.items():
        jax.config.update(n, v)


def test_env_setting_wins(monkeypatch, keep_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable() == "/some/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_checkout_default(monkeypatch, keep_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable()
    assert path == str(compile_cache.CHECKOUT_CACHE)
    assert compile_cache.CHECKOUT_CACHE.parent.joinpath(
        "lbzip2_tpu", "compile_cache.py").is_file()
    assert jax.config.jax_compilation_cache_dir == path


def test_cpu_keeps_no_cache(monkeypatch, keep_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_for_device() is None
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.parametrize("user_env", [False, True])
def test_key_settings_unless_env_sets_them(monkeypatch, keep_config,
                                           user_env):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    before = {n: getattr(jax.config, n) for n in compile_cache.KEY_SETTINGS}
    for name in compile_cache.KEY_SETTINGS:
        if user_env:
            monkeypatch.setenv(name.upper(), "x")
        else:
            monkeypatch.delenv(name.upper(), raising=False)
    compile_cache.enable()
    after = {n: getattr(jax.config, n) for n in compile_cache.KEY_SETTINGS}
    assert after == (before if user_env else compile_cache.KEY_SETTINGS)


def _triton_ir():
    """A fresh trace (no cached jaxpr) lowered for the GPU."""
    from lbzip2_tpu.ops.mtf_triton import mtf_ranks_rows_triton
    jax.clear_caches()
    return mtf_ranks_rows_triton.trace(
        jax.ShapeDtypeStruct((2, 64), jnp.int32),
        jax.ShapeDtypeStruct((2,), jnp.int32),
    ).lower(lowering_platforms=("cuda",)).as_text()


def _triton_ir_via_caller():
    return _triton_ir()


def test_triton_ir_key_independent_of_checkout_and_caller(monkeypatch,
                                                          keep_config):
    """The GPU lowering of the Triton MTF embeds source locations in the
    kernel IR (part of the cache key).  By default they hold the
    checkout's path and the caller's frames; after enable() neither."""
    checkout = str(compile_cache.CHECKOUT_CACHE.parent / "lbzip2_tpu")
    jax.config.update("jax_hlo_source_file_canonicalization_regex", None)
    jax.config.update("jax_include_full_tracebacks_in_locations", True)
    text = _triton_ir()
    assert checkout in text and text != _triton_ir_via_caller()
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    for name in compile_cache.KEY_SETTINGS:
        monkeypatch.delenv(name.upper(), raising=False)
    compile_cache.enable()
    text = _triton_ir()
    assert checkout not in text and "mtf_triton.py" in text
    assert text == _triton_ir_via_caller()
