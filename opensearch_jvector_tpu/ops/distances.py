"""Batched distance / similarity kernels.

Device replacements for the reference's SIMD distance path
(jVector `VectorSimilarityFunction.compare`, used e.g. at
JVectorVectorScorer.java:42 and throughout graph build/search).

All kernels are batched matmuls so XLA hands them to its matrix units;
scalar one-pair comparison is deliberately not the primitive.

Precision: every float32 product here runs at `EXACT`
(`Precision.HIGHEST`). On a GPU the default precision lets XLA use TF32,
which keeps about three decimal digits and would make the exact rerank,
the exact fallback, script scores and the recall oracle inexact. bf16
operands (the decoded-PQ cache) are unaffected by the setting.

Score conventions follow jVector (scores are "higher is better", bounded):
  EUCLIDEAN:    score = 1 / (1 + ||a-b||^2)
  DOT_PRODUCT:  score = (1 + dot(a, b)) / 2
  COSINE:       score = (1 + cos(a, b)) / 2
(see reference score mapping at JVectorReader.java:385-433 and the MIP x2
Lucene fixup at JVectorVectorScorer.java:45-56 — the x2 fixup is a
Lucene-compat detail applied at the query API layer, not here.)
"""

from __future__ import annotations

import enum
import functools

import jax
import jax.numpy as jnp


class SimilarityFunction(enum.Enum):
    """Vector similarity functions supported by the graph engine.

    Mirrors jVector's `VectorSimilarityFunction.{EUCLIDEAN, DOT_PRODUCT,
    COSINE}` (mapping at JVectorWriter.java:667-675). L1/LINF/HAMMING exist
    only in the exact-scoring layer (see `exact_scores`), as in the reference
    (JVectorDiskANNMethod.java:26-33 vs JVectorWriter.java:667-675).
    """

    EUCLIDEAN = 0
    DOT_PRODUCT = 1
    COSINE = 2

    @property
    def is_euclidean(self) -> bool:
        return self is SimilarityFunction.EUCLIDEAN


# Stable on-disk / wire ordinals (mirrors VectorSimilarityMapper,
# JVectorReader.java:385-433).
SIMILARITY_ORDINALS = {
    SimilarityFunction.EUCLIDEAN: 0,
    SimilarityFunction.DOT_PRODUCT: 1,
    SimilarityFunction.COSINE: 2,
}
ORDINAL_TO_SIMILARITY = {v: k for k, v in SIMILARITY_ORDINALS.items()}


EXACT = jax.lax.Precision.HIGHEST


def _dot(a: jax.Array, b: jax.Array) -> jax.Array:
    """[m, d] x [n, d] -> [m, n], f32 accumulation at full precision."""
    return jax.lax.dot_general(
        a,
        b,
        dimension_numbers=(((a.ndim - 1,), (b.ndim - 1,)), ((), ())),
        precision=EXACT,
        preferred_element_type=jnp.float32,
    )


def pairwise_sqdist(a: jax.Array, b: jax.Array) -> jax.Array:
    """Squared L2 distances, [m, d] x [n, d] -> [m, n].

    ||a-b||^2 = ||a||^2 + ||b||^2 - 2 a.b as one matmul + rank-1 adds.
    Clamped at 0 to absorb catastrophic cancellation.
    """
    a2 = jnp.sum(a * a, axis=-1, keepdims=True)
    b2 = jnp.sum(b * b, axis=-1)
    return jnp.maximum(a2 + b2[None, :] - 2.0 * _dot(a, b), 0.0)


def pairwise_scores(
    a: jax.Array, b: jax.Array, simf: SimilarityFunction
) -> jax.Array:
    """Pairwise similarity scores, [m, d] x [n, d] -> [m, n] (higher=better)."""
    if simf is SimilarityFunction.EUCLIDEAN:
        return 1.0 / (1.0 + pairwise_sqdist(a, b))
    if simf is SimilarityFunction.DOT_PRODUCT:
        return (1.0 + _dot(a, b)) / 2.0
    if simf is SimilarityFunction.COSINE:
        an = a * jax.lax.rsqrt(jnp.sum(a * a, -1, keepdims=True) + 1e-30)
        bn = b * jax.lax.rsqrt(jnp.sum(b * b, -1, keepdims=True) + 1e-30)
        return (1.0 + _dot(an, bn)) / 2.0
    raise ValueError(f"unsupported similarity {simf}")


def batched_candidate_scores(
    queries: jax.Array,  # [Q, d]
    cand_vecs: jax.Array,  # [Q, C, d]
    simf: SimilarityFunction,
) -> jax.Array:
    """Per-query candidate scoring: [Q, d] x [Q, C, d] -> [Q, C].

    The hot scoring op inside beam search and the exact rerank: each query
    scores its own gathered candidate rows. One batched matvec (einsum).
    """
    if simf is SimilarityFunction.EUCLIDEAN:
        q2 = jnp.sum(queries * queries, -1)[:, None]
        c2 = jnp.sum(cand_vecs * cand_vecs, -1)
        dot = jnp.einsum(
            "qd,qcd->qc", queries, cand_vecs, precision=EXACT,
            preferred_element_type=jnp.float32,
        )
        d2 = jnp.maximum(q2 + c2 - 2.0 * dot, 0.0)
        return 1.0 / (1.0 + d2)
    if simf is SimilarityFunction.DOT_PRODUCT:
        dot = jnp.einsum(
            "qd,qcd->qc", queries, cand_vecs, precision=EXACT,
            preferred_element_type=jnp.float32,
        )
        return (1.0 + dot) / 2.0
    if simf is SimilarityFunction.COSINE:
        qn = queries * jax.lax.rsqrt(
            jnp.sum(queries * queries, -1, keepdims=True) + 1e-30
        )
        cn = cand_vecs * jax.lax.rsqrt(
            jnp.sum(cand_vecs * cand_vecs, -1, keepdims=True) + 1e-30
        )
        dot = jnp.einsum("qd,qcd->qc", qn, cn, precision=EXACT,
                         preferred_element_type=jnp.float32)
        return (1.0 + dot) / 2.0
    raise ValueError(f"unsupported similarity {simf}")


# ---------------------------------------------------------------------------
# Exact scoring space types — the painless-script surface
# (KNNScoringUtil.java:100-253): l2Squared, l1Norm, lInfNorm, innerProduct,
# cosinesimil, hamming. These are raw distances/sims, not graph scores.
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("space",))
def exact_scores(query: jax.Array, vectors: jax.Array, space: str) -> jax.Array:
    """Raw per-space values for exact (script-style) scoring, [n].

    `space` in {"l2", "l1", "linf", "innerproduct", "cosinesimil"}.
    Returns the reference's script-score value:
      l2 -> 1/(1+l2^2), l1 -> 1/(1+l1), linf -> 1/(1+linf),
      innerproduct -> jVector translation (d<=0 ? 1/(1-d) : d+1)
      cosinesimil -> 1 + cos
    (script score conventions from KNNScoringSpaceUtil / KNNScoringUtil).
    """
    q = query[None, :]
    if space == "l2":
        return (1.0 / (1.0 + pairwise_sqdist(q, vectors)))[0]
    if space == "l1":
        return 1.0 / (1.0 + jnp.sum(jnp.abs(vectors - q), axis=-1))
    if space == "linf":
        return 1.0 / (1.0 + jnp.max(jnp.abs(vectors - q), axis=-1))
    if space == "innerproduct":
        d = _dot(q, vectors)[0]
        return jnp.where(d <= 0, 1.0 / (1.0 - d), d + 1.0)
    if space == "cosinesimil":
        qn = q * jax.lax.rsqrt(jnp.sum(q * q, -1, keepdims=True) + 1e-30)
        vn = vectors * jax.lax.rsqrt(
            jnp.sum(vectors * vectors, -1, keepdims=True) + 1e-30
        )
        return 1.0 + _dot(qn, vn)[0]
    raise ValueError(f"unsupported space {space}")


def hamming_scores(query_bits: jax.Array, vector_bits: jax.Array) -> jax.Array:
    """Hamming distance score 1/(1+popcount(xor)) over packed uint8 codes.

    query_bits: [b] uint8; vector_bits: [n, b] uint8.
    (reference: KNNScoringUtil.calculateHammingBit, KNNScoringUtil.java:204+)
    """
    x = jnp.bitwise_xor(vector_bits, query_bits[None, :])
    pop = jnp.sum(jax.lax.population_count(x).astype(jnp.int32), axis=-1)
    return 1.0 / (1.0 + pop.astype(jnp.float32))


def host_candidate_scores(
    queries: "np.ndarray",  # [Q, d] f32 (host)
    cand_vecs: "np.ndarray",  # [Q, C, d] f32 (host)
    simf: SimilarityFunction,
) -> "np.ndarray":
    """NumPy mirror of `batched_candidate_scores` for the on_disk rerank.

    The on_disk tier's exact rerank reads candidate rows from the HOST
    row store (native mmap gather); scoring r candidates per query is a
    few MFLOP, while shipping the rows to the device costs orders of
    magnitude more than the arithmetic (the reference reranks host-side
    for the same reason: the DiskANN rerank walks disk-resident fp32,
    JVectorReader.java:166-208). Same score formulas as the device path;
    fp32 accumulation order differs by backend (last-ulp differences
    only, identical ordering semantics).
    """
    import numpy as _np

    q = _np.asarray(queries, _np.float32)
    c = _np.asarray(cand_vecs, _np.float32)
    if simf is SimilarityFunction.EUCLIDEAN:
        q2 = _np.sum(q * q, -1)[:, None]
        c2 = _np.sum(c * c, -1)
        dot = _np.einsum("qd,qcd->qc", q, c, optimize=True)
        d2 = _np.maximum(q2 + c2 - 2.0 * dot, 0.0)
        return 1.0 / (1.0 + d2)
    if simf is SimilarityFunction.DOT_PRODUCT:
        return (1.0 + _np.einsum("qd,qcd->qc", q, c, optimize=True)) / 2.0
    if simf is SimilarityFunction.COSINE:
        qn = q / _np.sqrt(_np.sum(q * q, -1, keepdims=True) + 1e-30)
        cn = c / _np.sqrt(_np.sum(c * c, -1, keepdims=True) + 1e-30)
        return (1.0 + _np.einsum("qd,qcd->qc", qn, cn, optimize=True)) / 2.0
    raise ValueError(f"unsupported similarity {simf}")
