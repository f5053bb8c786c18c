"""Persistent compile cache location (pbrjax/utils/cache.py)."""

import os

import pytest

import jax

from pbrjax.utils import cache


@pytest.fixture
def restore_cache_config():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_default_dir_is_fixed_and_ignored():
    """Unset env: a fixed directory inside the checkout, listed in
    .gitignore (the path is part of what makes an entry hit)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.DEFAULT_DIR == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_enable_uses_env_dir_or_default(env_dir, tmp_path, monkeypatch,
                                        restore_cache_config):
    """With JAX_COMPILATION_CACHE_DIR set the cache lands there (JAX reads
    it; nothing overrides it); unset, it lands in DEFAULT_DIR."""
    monkeypatch.delenv("PBRJAX_NO_CACHE", raising=False)
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = cache.DEFAULT_DIR
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
        jax.config.update("jax_compilation_cache_dir", want)  # as at startup
    assert cache.enable_persistent_cache()
    assert jax.config.jax_compilation_cache_dir == want


def test_no_cache_env_disables(monkeypatch, restore_cache_config):
    monkeypatch.setenv("PBRJAX_NO_CACHE", "1")
    before = jax.config.jax_compilation_cache_dir
    assert not cache.enable_persistent_cache()
    assert jax.config.jax_compilation_cache_dir == before
