"""Brute-force ground truth + recall (test/bench harness utility).

Mirrors the reference's `TestUtils.computeGroundTruthValues` used by the
recall gate (RecallTestsIT.java:72-79). Scores come from
`pairwise_scores`, whose float32 products run at `Precision.HIGHEST`, and
the top-k is exact (`exact_topk_wide`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from opensearch_jvector_tpu.ops.distances import SimilarityFunction, pairwise_scores
from opensearch_jvector_tpu.ops.topk import exact_topk_wide as _exact_topk_wide


def ground_truth_topk(
    queries: jax.Array, vectors: jax.Array, k: int, simf: SimilarityFunction,
    block: int = 1 << 20,  # [Q, block] f32 slab stays ~2GB at Q=512
) -> np.ndarray:
    """Exact top-k ids per query by full scan, [Q, k].

    Blocked over the corpus (running top-k merge) so the [Q, N] score
    matrix never materializes — a 10M-corpus ground truth would otherwise
    need 20GB for the scores alone.
    """
    queries = jnp.asarray(queries)
    n = vectors.shape[0]
    if n <= block:
        scores = pairwise_scores(queries, jnp.asarray(vectors), simf)
        _, ids = _exact_topk_wide(scores, min(k, n))
        return np.asarray(ids)
    return ground_truth_topk_stream(
        queries,
        ((s, np.asarray(vectors[s: s + block])) for s in range(0, n, block)),
        k, simf,
    )


def ground_truth_topk_stream(
    queries: jax.Array,
    blocks,  # iterable of (offset, [b, d] np.float32) corpus slices, in order
    k: int,
    simf: SimilarityFunction,
) -> np.ndarray:
    """Exact top-k over a corpus delivered as a stream of blocks, [Q, k].

    Running top-k merge per block; the producer can GENERATE or LOAD each
    block lazily, overlapping corpus synthesis with the device pass over
    the previous block."""
    queries = jnp.asarray(queries)
    best_s = None
    best_i = None
    pending = None
    for s, blk_np in blocks:
        blk = jnp.asarray(blk_np)
        scores = pairwise_scores(queries, blk, simf)
        top_s, top_i = _exact_topk_wide(scores, min(k, blk.shape[0]))
        top_i = top_i + s
        if best_s is None:
            best_s, best_i = top_s, top_i
        else:
            cat_s = jnp.concatenate([best_s, top_s], axis=1)
            cat_i = jnp.concatenate([best_i, top_i], axis=1)
            best_s, sel = jax.lax.top_k(cat_s, k)
            best_i = jnp.take_along_axis(cat_i, sel, axis=1)
        # Depth-1 backpressure: wait on the PREVIOUS block's merge, so
        # exactly one upload + [Q, block] score slab is in flight while the
        # producer builds the next block (unbounded async dispatch queues
        # every slab at once and runs out of device memory at 10M rows).
        if pending is not None:
            pending.block_until_ready()
        pending = best_s
    return np.asarray(best_i)


def recall_at_k(result_ids: np.ndarray, truth_ids: np.ndarray, k: int) -> float:
    """Mean |results ∩ truth| / k over the query batch."""
    hits = 0
    q = truth_ids.shape[0]
    for i in range(q):
        hits += len(set(result_ids[i, :k].tolist()) & set(truth_ids[i, :k].tolist()))
    return hits / (q * k)
