"""Scalar (binary / multi-bit) quantization framework.

Device counterpart of the reference's `quantization/` package:
`OneBitScalarQuantizer` (per-dimension mean threshold trained on a
reservoir sample, default 25k — OneBitScalarQuantizer.java:25-40),
`MultiBitScalarQuantizer` (2/4-bit per dimension with per-dimension
thresholds), `BitPacker`, serializable `QuantizationState`, and the
node-level `QuantizationStateCache` (Guava cache with max-weight and
expiry, QuantizationStateCache.java:69-112).

Quantized codes are bit-packed uint8 rows scored by Hamming distance
(KNNScoringUtil.calculateHammingBit parity) — one XOR + popcount scan on
the VPU.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np

from opensearch_jvector_tpu.ops.distances import hamming_scores

DEFAULT_SAMPLE_SIZE = 25_000  # reservoir sample default (reference)


def reservoir_sample(n: int, sample_size: int, seed: int = 0) -> np.ndarray:
    """Deterministic sample of row indices (Sampler parity)."""
    if n <= sample_size:
        return np.arange(n)
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, sample_size, replace=False))


@dataclasses.dataclass
class QuantizationState:
    """Serializable trained thresholds: [bits_per_dim, d] f32.

    For 1-bit this is the per-dimension mean; for 2/4-bit, evenly spaced
    quantiles of the training sample per dimension.
    """

    bits: int  # 1, 2 or 4
    thresholds: np.ndarray  # [levels, d] with levels = 2^bits - 1

    def nbytes(self) -> int:
        return self.thresholds.nbytes + 8

    def to_arrays(self) -> dict:
        return {"thresholds": self.thresholds,
                "bits": np.asarray([self.bits], np.int32)}

    @staticmethod
    def from_arrays(arrays: dict) -> "QuantizationState":
        return QuantizationState(
            bits=int(arrays["bits"][0]), thresholds=arrays["thresholds"]
        )


def train_scalar_quantizer(
    vectors: np.ndarray, bits: int = 1,
    sample_size: int = DEFAULT_SAMPLE_SIZE, seed: int = 0,
) -> QuantizationState:
    """Train per-dimension thresholds on a reservoir sample."""
    if bits not in (1, 2, 4):
        raise ValueError(f"bits must be 1, 2 or 4: {bits}")
    v = np.asarray(vectors, np.float32)
    sample = v[reservoir_sample(v.shape[0], sample_size, seed)]
    if bits == 1:
        thr = sample.mean(axis=0, keepdims=True)  # mean threshold (parity)
    else:
        levels = 2**bits - 1
        qs = np.linspace(0, 100, levels + 2)[1:-1]
        thr = np.percentile(sample, qs, axis=0).astype(np.float32)
    return QuantizationState(bits=bits, thresholds=thr.astype(np.float32))


@jax.jit
def _pack_bits(bits: jax.Array) -> jax.Array:
    """Pack a [n, nb] 0/1 array into [n, ceil(nb/8)] uint8 (BitPacker)."""
    n, nb = bits.shape
    pad = (-nb) % 8
    b = jnp.pad(bits.astype(jnp.uint8), ((0, 0), (0, pad)))
    b = b.reshape(n, -1, 8)
    weights = (2 ** jnp.arange(7, -1, -1, dtype=jnp.uint8))[None, None, :]
    return jnp.sum(b * weights, axis=-1).astype(jnp.uint8)


def quantize_vectors(state: QuantizationState, vectors) -> np.ndarray:
    """Encode rows -> bit-packed uint8 codes [n, ceil(d*bits/8)].

    Multi-bit uses unary ("thermometer") coding across levels so Hamming
    distance approximates L2 rank order, as in the reference's
    MultiBitScalarQuantizer.
    """
    v = jnp.asarray(vectors, jnp.float32)
    thr = jnp.asarray(state.thresholds)  # [levels, d]
    above = (v[:, None, :] > thr[None, :, :]).astype(jnp.uint8)  # [n, L, d]
    n = v.shape[0]
    flat = jnp.transpose(above, (0, 2, 1)).reshape(n, -1)  # d-major bits
    return np.asarray(_pack_bits(flat))


def hamming_search(
    query_code: np.ndarray, codes: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Top-k by Hamming score over packed codes."""
    scores = hamming_scores(
        jnp.asarray(query_code, jnp.uint8), jnp.asarray(codes, jnp.uint8)
    )
    kk = min(k, scores.shape[0])
    top_s, top_i = jax.lax.top_k(scores, kk)
    return np.asarray(top_i), np.asarray(top_s)


class QuantizationStateCache:
    """Bounded, expiring cache of trained quantization states.

    Max weight in bytes + time-based expiry, mirroring the node-level
    QuantizationStateCache (Guava maximumWeight + expireAfterAccess).
    """

    def __init__(self, max_bytes: int = 64 << 20, ttl_seconds: float = 3600.0):
        self.max_bytes = max_bytes
        self.ttl = ttl_seconds
        self._lock = threading.Lock()
        self._entries: dict[str, tuple[QuantizationState, float]] = {}
        self._weight = 0

    def get(self, key: str) -> QuantizationState | None:
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                return None
            state, _ = hit
            self._entries[key] = (state, time.monotonic())
            return state

    def put(self, key: str, state: QuantizationState) -> None:
        with self._lock:
            if key in self._entries:
                self._weight -= self._entries[key][0].nbytes()
            self._entries[key] = (state, time.monotonic())
            self._weight += state.nbytes()
            self._evict_locked()

    def _evict_locked(self) -> None:
        now = time.monotonic()
        expired = [k for k, (_, t) in self._entries.items()
                   if now - t > self.ttl]
        for k in expired:
            self._weight -= self._entries.pop(k)[0].nbytes()
        while self._weight > self.max_bytes and self._entries:
            k = min(self._entries, key=lambda k: self._entries[k][1])
            self._weight -= self._entries.pop(k)[0].nbytes()

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "weight_bytes": self._weight}


# Node-level singleton (QuantizationStateCache parity): read_segment caches
# trained scalar states here so re-opens skip threshold deserialization.
SCALAR_STATE_CACHE = QuantizationStateCache()
