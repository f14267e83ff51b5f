"""Persistent compilation cache location (``utils/cache.py``)."""

import os

import jax
import pytest

from cuda_matrix_inversion_tpu.utils import cache

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", old[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old[1])


def test_env_var_wins(tmp_path, monkeypatch, restore_cache_config):
    target = str(tmp_path / "x")
    monkeypatch.setenv(cache.ENV_VAR, target)
    assert cache.enable_compilation_cache() == target
    assert jax.config.jax_compilation_cache_dir == target
    assert os.path.isdir(target)


def test_default_is_fixed_path_in_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    assert cache.cache_dir() == os.path.join(REPO_ROOT, ".jax_cache")
    assert cache.enable_compilation_cache() == cache.DEFAULT_DIR
    assert jax.config.jax_compilation_cache_dir == cache.DEFAULT_DIR
    # the same path on every call: a moving directory never hits
    assert cache.enable_compilation_cache() == cache.DEFAULT_DIR


def test_default_cache_dir_is_gitignored():
    with open(os.path.join(REPO_ROOT, ".gitignore")) as f:
        ignored = {line.strip().rstrip("/") for line in f}
    assert os.path.basename(cache.DEFAULT_DIR) in ignored
