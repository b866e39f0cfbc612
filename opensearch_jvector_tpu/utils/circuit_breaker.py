"""Memory circuit breaker: refuse work that would blow device memory.

Mirrors the reference's knn memory circuit breaker
(KNNSettings.java:68-75, default limit 50% at :108, cluster "triggered"
flag): before building or loading a segment, estimate its device-memory
footprint and trip the breaker when the configured fraction of the
device's memory would be exceeded. Flushes and segment loads run on the
default device and are checked there; mesh state is checked on every
mesh device it is split over (parallel/sharded.stack_engine_state).
"""

from __future__ import annotations

import jax

from opensearch_jvector_tpu.api.settings import GLOBAL_SETTINGS, SettingsRegistry


class CircuitBreakerException(RuntimeError):
    pass


class MemoryCircuitBreaker:
    def __init__(self, settings: SettingsRegistry = GLOBAL_SETTINGS):
        self.settings = settings
        self.tripped = False  # the cluster-level "triggered" flag analog

    @staticmethod
    def _stats(device=None) -> dict:
        """memory_stats() of `device`, by default the device JAX places new
        arrays on (where flushes build and segments load); {} where the
        platform has no memory introspection (e.g. CPU)."""
        try:
            if device is None:
                device = (jax.config.jax_default_device
                          or jax.devices()[0])
            return device.memory_stats() or {}
        except Exception:  # noqa: BLE001 — platform-dependent API
            return {}

    def device_memory_bytes(self, device=None) -> int | None:
        stats = self._stats(device)
        return int(stats["bytes_limit"]) if "bytes_limit" in stats else None

    def device_memory_in_use(self, device=None) -> int:
        return int(self._stats(device).get("bytes_in_use", 0))

    @staticmethod
    def estimate_segment_bytes(n: int, dim: int, max_degree: int,
                               overflow: float = 1.2,
                               pq_subspaces: int | None = None,
                               keep_fp32: bool = True) -> int:
        """Device footprint of a segment: vectors + adjacency + codes."""
        total = 0
        if keep_fp32:
            total += n * dim * 4
        total += n * int(max_degree * overflow) * 4  # adjacency int32
        if pq_subspaces:
            total += n * pq_subspaces  # uint8 codes
            total += pq_subspaces * 256 * (dim // max(pq_subspaces, 1)) * 4
        return total

    def check(self, additional_bytes: int, device=None) -> None:
        """Raise CircuitBreakerException if the allocation would trip on
        `device` (default: the device new arrays land on)."""
        if not self.settings.get("knn.memory.circuit_breaker.enabled"):
            return
        limit_total = self.device_memory_bytes(device)
        if limit_total is None:
            return  # no memory introspection on this platform (e.g. CPU)
        frac = self.settings.get("knn.memory.circuit_breaker.limit") / 100.0
        budget = int(limit_total * frac)
        projected = self.device_memory_in_use(device) + additional_bytes
        if projected > budget:
            self.tripped = True
            raise CircuitBreakerException(
                f"knn memory circuit breaker: projected {projected>>20} MiB "
                f"exceeds budget {budget>>20} MiB "
                f"({self.settings.get('knn.memory.circuit_breaker.limit')}% "
                f"of {limit_total>>20} MiB)"
            )
        self.tripped = False


BREAKER = MemoryCircuitBreaker()
