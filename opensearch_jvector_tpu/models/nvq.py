"""NVQ quantization model (per-vector nonlinear scalar quantization).

Device counterpart of jVector's `NVQuantization` / `NVQVectors`
(compute/encodeAll at JVectorIndexQuantization.java:95-108, 260-266).
NVQ replaces the fp32 inline vectors in the graph with ~1 byte/dim codes
plus 28B/subvector parameters; an auxiliary PQ is ALWAYS trained alongside
for graph traversal ("nvq+pq", KNNConstants.QUANTIZATION_TYPE_NVQ — there is
no NVQ-without-PQ mode in the reference), while NVQ-decoded vectors serve
the rerank phase.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from opensearch_jvector_tpu.ops import nvq as nvq_ops
from opensearch_jvector_tpu.ops.distances import SimilarityFunction

DEFAULT_NUM_SUBVECTORS = 2  # reference default (KNNConstants.java:114)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class NVQVectors:
    """NVQ-encoded corpus."""

    bytes_: jax.Array  # [n, d] u8
    params: jax.Array  # [n, M, 4] f32 (growthRate, midpoint, min, max)
    global_mean: jax.Array  # [d] f32

    @property
    def num_subvectors(self) -> int:
        return self.params.shape[1]

    def decode(self) -> jax.Array:
        """Dequantize the whole corpus -> [n, d] f32."""
        return nvq_ops.nvq_decode(
            self.bytes_, self.params, self.global_mean, self.num_subvectors
        )

    def decode_rows(self, ids: jax.Array) -> jax.Array:
        """Dequantize a gathered subset (rerank path), ids [...]."""
        b = self.bytes_[ids]
        p = self.params[ids]
        flat_b = b.reshape(-1, b.shape[-1])
        flat_p = p.reshape(-1, *p.shape[-2:])
        out = nvq_ops.nvq_decode(
            flat_b, flat_p, self.global_mean, self.num_subvectors
        )
        return out.reshape(*b.shape[:-1], b.shape[-1])


def train_nvq(
    vectors: jax.Array,  # [n, d]
    num_subvectors: int = DEFAULT_NUM_SUBVECTORS,
) -> NVQVectors:
    """Fit + encode the corpus (global-mean centering, per-subvector fit)."""
    d = vectors.shape[1]
    m = num_subvectors
    while d % m != 0:  # subvector split must tile the dim evenly
        m -= 1
    vectors = jnp.asarray(vectors, jnp.float32)
    mean = jnp.mean(vectors, axis=0)
    bytes_, params = nvq_ops.nvq_encode(vectors - mean[None, :], m)
    return NVQVectors(bytes_=bytes_, params=params, global_mean=mean)


def reconstruction_mse(nvq: NVQVectors, vectors: jax.Array) -> jax.Array:
    rec = nvq.decode()
    return jnp.mean((rec - jnp.asarray(vectors, jnp.float32)) ** 2)
