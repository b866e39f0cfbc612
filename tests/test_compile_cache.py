"""The compile-cache helper: the environment variable wins, else the
checkout's own `.jax_cache`."""

from pathlib import Path

import jax

from opensearch_jvector_tpu.utils import compile_cache


def _record_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, val: calls.__setitem__(name, val))
    return calls


def test_env_dir_is_used_and_nothing_else_is_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "3")
    calls = _record_updates(monkeypatch)
    assert compile_cache.configure_compile_cache() == str(tmp_path)
    assert calls == {}


def test_default_is_the_checkout_cache(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS",
                       raising=False)
    calls = _record_updates(monkeypatch)
    got = compile_cache.configure_compile_cache()
    repo = Path(__file__).resolve().parents[1]
    assert got == str(repo / ".jax_cache")
    assert calls["jax_compilation_cache_dir"] == got
    assert calls["jax_persistent_cache_min_compile_time_secs"] == (
        compile_cache.MIN_COMPILE_TIME_SECS)
