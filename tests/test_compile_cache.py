"""The persistent compilation cache location (utils/compile_cache.py)."""

import os

import jax
import pytest

from sph_tpu.utils import compile_cache as cc


@pytest.fixture
def restore_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_entry_size_bytes",
            "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in before.items():
        jax.config.update(k, v)


def test_env_var_set_is_used_and_nothing_else_is_set(monkeypatch, tmp_path,
                                                     restore_config):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv(cc.ENV_VAR, str(tmp_path))
    assert cc.compile_cache_dir() == str(tmp_path)
    assert cc.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None


def test_env_var_unset_uses_fixed_checkout_dir(monkeypatch, restore_config):
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    assert cc.enable_compile_cache() == cc.DEFAULT_DIR
    assert jax.config.jax_compilation_cache_dir == cc.DEFAULT_DIR
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(cc.__file__))))
    assert cc.DEFAULT_DIR == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
