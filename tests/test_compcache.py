"""Where the persistent compilation cache lives (utils/compcache.py)."""

import os

import jax
import pytest

from slslam.utils import compcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_default_is_the_fixed_checkout_directory(monkeypatch,
                                                  restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compcache.cache_dir() == os.path.join(REPO, ".jax_cache")
    assert compcache.enable_persistent_cache() == compcache.DEFAULT_DIR
    assert jax.config.jax_compilation_cache_dir == compcache.DEFAULT_DIR


def test_environment_variable_wins(monkeypatch, tmp_path,
                                   restore_cache_dir):
    d = str(tmp_path / "cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", d)
    assert compcache.enable_persistent_cache() == d
    assert jax.config.jax_compilation_cache_dir == d
    assert os.path.isdir(d)


def test_directory_is_stable_across_calls(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compcache.cache_dir() == compcache.cache_dir()
    assert str(os.getpid()) not in compcache.cache_dir()


def test_the_suite_uses_the_same_rule():
    # conftest.py enables the cache through compcache, so the suite's
    # directory is the environment's when set, else the checkout's
    assert jax.config.jax_compilation_cache_dir in (
        os.environ.get("JAX_COMPILATION_CACHE_DIR"), compcache.DEFAULT_DIR)
