"""Process set-up helpers (desmo_tpu.runtime): compile cache, device check,
card identity."""

import os

import pytest

import jax

from desmo_tpu import runtime


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_var_wins(monkeypatch, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    jax.config.update("jax_compilation_cache_dir", "/already/set")
    assert runtime.enable_compile_cache() == "/elsewhere/cache"
    # with the variable set, nothing is overridden
    assert jax.config.jax_compilation_cache_dir == "/already/set"


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = runtime.enable_compile_cache()
    assert first == runtime.enable_compile_cache() == runtime.DEFAULT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == first


def test_compile_cache_default_path():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert runtime.REPO_ROOT == repo
    assert runtime.DEFAULT_CACHE_DIR == os.path.join(repo, ".jax_cache")


def test_require_gpu_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()


def test_card_query_fails_without_nvidia_smi(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvidia-smi"):
        runtime.gpu_name_and_power_limit()
