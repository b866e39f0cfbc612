"""Dynamic settings registry (cluster/index settings analog).

Mirrors the shape of `KNNSettings` (KNNSettings.java:62-229): typed,
validated, dynamic settings with defaults and change consumers. Only the
settings meaningful to this engine are registered; OpenSearch-core-only
settings (cache expiry minutes etc.) keep their names for API parity where
they have an equivalent here.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable


@dataclass(frozen=True)
class Setting:
    name: str
    default: Any
    validator: Callable[[Any], bool]
    dynamic: bool = True
    description: str = ""


def _pct(lo=0.0, hi=100.0):
    return lambda v: isinstance(v, (int, float)) and lo <= v <= hi


def _pos_int(lo=1, hi=None):
    return lambda v: isinstance(v, int) and v >= lo and (hi is None or v <= hi)


def _bool(v):
    return isinstance(v, bool)


SETTINGS: dict[str, Setting] = {
    s.name: s
    for s in [
        Setting("index.knn", True, _bool, dynamic=False,
                description="enable knn codec on an index"),
        Setting("knn.algo_param.index_thread_qty", 1, _pos_int(1, 32),
                description="host threads for background index work"),
        Setting("knn.memory.circuit_breaker.enabled", True, _bool),
        Setting("knn.memory.circuit_breaker.limit", 50.0, _pct(),
                description="% of device memory for graph storage "
                            "(reference default 50%, KNNSettings.java:108)"),
        Setting("knn.vector_streaming_memory.limit", 1.0, _pct(),
                description="% of memory for streaming transfers "
                            "(KNNSettings.java:109)"),
        Setting("index.knn.derived_source.enabled", True, _bool,
                description="store vectors once (derived source default-on "
                            "for knn indices, JVectorKNNPlugin.java:217-228)"),
        Setting("index.knn.advanced.filtered_exact_search_threshold", -1,
                lambda v: isinstance(v, int),
                description="filter cardinality at or below which exact "
                            "search replaces graph search (-1 = auto: k * "
                            "overquery; KNNSettings.java:229)"),
        Setting("index.knn.advanced.approximate_threshold", 0,
                lambda v: isinstance(v, int),
                description="min vectors before building a graph "
                            "(KNNSettings.java:165)"),
        Setting("index.knn.advanced.scan_tier_max_codes", -1,
                lambda v: isinstance(v, int),
                description="segment size at or below which queries take "
                            "the exhaustive scan tier instead of graph "
                            "traversal (-1 = engine default 262144). Raise "
                            "for corpora where distance concentration caps "
                            "graph recall: the scan is linear in N but "
                            "exhaustive, and degrades to codes-only LUT "
                            "scoring when the decoded cache trips the "
                            "memory breaker (no analog in the reference; "
                            "jVector graph-searches every segment)"),
        Setting("knn.quantization.cache.size.limit", 5.0, _pct(0.0, 10.0),
                description="% of heap for quantization state cache "
                            "(default 5%, cap 10%, KNNSettings.java:112-114)"),
        Setting("knn.quantization.cache.expiry.minutes", 60, _pos_int(1)),
        Setting("knn.feature.cache.force_evict.enabled", False, _bool,
                description="the single reference feature flag "
                            "(KNNFeatureFlags.java:26-34)"),
    ]
}


class SettingsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._values: dict[str, Any] = {}
        self._consumers: dict[str, list[Callable[[Any], None]]] = {}

    def get(self, name: str):
        if name not in SETTINGS:
            raise KeyError(f"unknown setting {name}")
        with self._lock:
            return self._values.get(name, SETTINGS[name].default)

    def put(self, name: str, value) -> None:
        s = SETTINGS.get(name)
        if s is None:
            raise KeyError(f"unknown setting {name}")
        if not s.dynamic and name in self._values:
            raise ValueError(f"setting {name} is not dynamic")
        if not s.validator(value):
            raise ValueError(f"invalid value for {name}: {value!r}")
        with self._lock:
            self._values[name] = value
            consumers = list(self._consumers.get(name, ()))
        for fn in consumers:
            fn(value)

    def on_change(self, name: str, fn: Callable[[Any], None]) -> None:
        if name not in SETTINGS:
            raise KeyError(f"unknown setting {name}")
        with self._lock:
            self._consumers.setdefault(name, []).append(fn)

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                name: self._values.get(name, s.default)
                for name, s in SETTINGS.items()
            }


GLOBAL_SETTINGS = SettingsRegistry()


def _resize_pools(_qty) -> None:
    # the host pools are a cached singleton sized at first use; a dynamic
    # thread-qty change rebuilds them so it takes effect immediately
    from opensearch_jvector_tpu.parallel.pools import ComputePools

    ComputePools.reset_for_settings()


GLOBAL_SETTINGS.on_change("knn.algo_param.index_thread_qty", _resize_pools)
