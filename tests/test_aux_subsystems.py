"""Aux subsystems: circuit breaker, profiling phases, settings consumers."""

import os

import numpy as np
import pytest

from opensearch_jvector_tpu.api.settings import SettingsRegistry
from opensearch_jvector_tpu.api.stats import Counter, StatsRegistry
from opensearch_jvector_tpu.utils.circuit_breaker import (
    CircuitBreakerException,
    MemoryCircuitBreaker,
)
from opensearch_jvector_tpu.utils.profiling import phase


def test_breaker_estimate_and_disabled_path():
    est = MemoryCircuitBreaker.estimate_segment_bytes(
        1000, 128, 32, 1.2, pq_subspaces=64
    )
    assert est > 1000 * 128 * 4  # vectors plus graph plus codes
    settings = SettingsRegistry()
    settings.put("knn.memory.circuit_breaker.enabled", False)
    b = MemoryCircuitBreaker(settings)
    b.check(1 << 60)  # disabled -> never trips


def test_breaker_trips_with_fake_memory(monkeypatch):
    settings = SettingsRegistry()
    settings.put("knn.memory.circuit_breaker.limit", 50.0)
    b = MemoryCircuitBreaker(settings)
    monkeypatch.setattr(b, "device_memory_bytes", lambda device=None: 1000)
    monkeypatch.setattr(b, "device_memory_in_use", lambda device=None: 400)
    b.check(50)  # 450 <= 500
    assert not b.tripped
    with pytest.raises(CircuitBreakerException):
        b.check(200)  # 600 > 500
    assert b.tripped


def test_settings_consumers_and_validation():
    s = SettingsRegistry()
    seen = []
    s.on_change("knn.algo_param.index_thread_qty", seen.append)
    s.put("knn.algo_param.index_thread_qty", 4)
    assert seen == [4] and s.get("knn.algo_param.index_thread_qty") == 4
    with pytest.raises(ValueError):
        s.put("knn.algo_param.index_thread_qty", 0)
    with pytest.raises(KeyError):
        s.put("bogus.setting", 1)
    with pytest.raises(ValueError):
        s.put("index.knn", False) if "index.knn" in [] else None
        s.put("knn.memory.circuit_breaker.limit", 200.0)


def test_profiling_phase_counter_and_trace(tmp_path, monkeypatch):
    stats = StatsRegistry()
    with phase("unit-test-phase", Counter.KNN_GRAPH_BUILD_TIME, stats):
        x = np.ones(10).sum()
    assert x == 10
    assert stats.get(Counter.KNN_GRAPH_BUILD_TIME) >= 0
    # trace mode writes a profile directory
    monkeypatch.setenv("JVECTOR_TPU_TRACE_DIR", str(tmp_path))
    with phase("traced-phase", stats=stats):
        np.ones(10).sum()
    assert (tmp_path / "traced-phase").exists()


def test_breaker_guards_segment_load_and_merge(tmp_path, monkeypatch):
    """A too-large load or merge trips cleanly BEFORE uploading to the
    device (the reference's breaker also guards cache loads,
    KNNSettings.java:68-108)."""
    import numpy as np

    from opensearch_jvector_tpu.api.config import DiskAnnConfig, SearchConfig
    from opensearch_jvector_tpu.index.index import VectorIndex
    from opensearch_jvector_tpu.index.segment import read_segment
    from opensearch_jvector_tpu.utils import circuit_breaker as cb

    cfg = DiskAnnConfig(dim=16, m=8, ef_construction=32,
                        quantization_type="none")
    idx = VectorIndex(tmp_path, cfg)
    rng = np.random.default_rng(0)
    v = rng.standard_normal((100, 16)).astype(np.float32)
    for i in range(100):
        idx.add(i, v[i])
    name = idx.flush()

    # fake a tiny device: 1 KiB budget -> every load/merge trips
    monkeypatch.setattr(cb.BREAKER, "device_memory_bytes", lambda device=None: 2048)
    monkeypatch.setattr(cb.BREAKER, "device_memory_in_use", lambda device=None: 0)
    with pytest.raises(cb.CircuitBreakerException):
        read_segment(tmp_path / name)
    seg_ok = None
    with pytest.raises(cb.CircuitBreakerException):
        idx2 = VectorIndex(tmp_path)
        idx2.force_merge()
    assert cb.BREAKER.tripped
    monkeypatch.undo()
    assert read_segment(tmp_path / name) is not None  # loads fine again
