"""`bild_jax.config`: the persistent-compile-cache helper."""
import os

import jax
import pytest

from bild_jax import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    # enable_compilation_cache mutates PROCESS-GLOBAL jax config; restore it
    # afterwards or every later compile in the pytest process serializes
    # executables into this test's directory (besides polluting the suite,
    # cache writes under the COV=1 sys.monitoring tracer hit a CPython/XLA
    # abort — 'Fatal Python error: Aborted' in put_executable_and_time).
    old_dir = jax.config.jax_compilation_cache_dir
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs
    yield
    jax.config.update("jax_compilation_cache_dir", old_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old_min)


def test_enable_compilation_cache(monkeypatch, restore_cache_config):
    # without JAX_COMPILATION_CACHE_DIR: the fixed directory in the checkout
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(ROOT, ".jax_cache")
    got = config.enable_compilation_cache()
    assert got == want
    assert os.path.isdir(want)
    assert jax.config.jax_compilation_cache_dir == want
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.2


def test_enable_compilation_cache_env(tmp_path, monkeypatch,
                                      restore_cache_config):
    # JAX_COMPILATION_CACHE_DIR, when set, is the directory in effect
    want = str(tmp_path / "envdir")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    assert config.enable_compilation_cache() == want
    assert os.path.isdir(want)
    assert jax.config.jax_compilation_cache_dir == want
