"""Exact (brute-force) scoring: the script-score surface + exact fallback.

Mirrors the painless `knn_score` engine's space functions
(KNNScoringUtil.java:100-253: l2Squared, l1Norm, lInfNorm, innerProduct,
cosinesimil, hamming) and the filtered-exact-search iterators
(index/query/iterators/) used when a filter is too selective for graph
search. Everything is one batched device scan (matmul) + top-k,
instead of the reference's per-doc scalar loops.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from opensearch_jvector_tpu.index.segment import Segment
from opensearch_jvector_tpu.ops.distances import (
    SimilarityFunction,
    exact_scores,
    hamming_scores,
    pairwise_scores,
)

# script-score space names (SpaceType strings of the reference)
SCRIPT_SPACES = ("l2", "l1", "linf", "innerproduct", "cosinesimil", "hamming")


def script_score(
    query: np.ndarray,
    vectors,  # [n, d] float (or [n, b] uint8 for hamming)
    space: str,
) -> np.ndarray:
    """Raw script scores for every row (KNNScoringUtil parity)."""
    if space == "hamming":
        return np.asarray(
            hamming_scores(jnp.asarray(query, jnp.uint8),
                           jnp.asarray(vectors, jnp.uint8))
        )
    if space not in SCRIPT_SPACES:
        raise ValueError(f"unknown space {space}; one of {SCRIPT_SPACES}")
    return np.asarray(
        exact_scores(jnp.asarray(query, jnp.float32),
                     jnp.asarray(vectors, jnp.float32), space)
    )


def _segment_fp32(seg: Segment) -> jnp.ndarray:
    if seg.vectors is not None:
        return seg.vectors
    if seg.row_store is not None:  # on_disk mode: page the full row file
        import numpy as _np

        return jnp.asarray(
            seg.row_store.gather(_np.arange(seg.row_store.num_rows))
        )
    assert seg.nvq is not None
    return seg.nvq.decode()


def exact_search_segment(
    seg: Segment,
    queries: np.ndarray,  # [Q, d]
    k: int,
    simf: SimilarityFunction | None = None,
    accept_ords: np.ndarray | None = None,  # bool [capacity]
):
    """Brute-force top-k over one segment -> (doc_ids [Q,k], scores [Q,k]).

    The exact-search fallback path for restrictive filters (parity with
    Lucene's exactSearch fallback via JVectorVectorScorer).
    """
    simf = simf or seg.config.similarity
    v = _segment_fp32(seg)
    queries = jnp.asarray(np.atleast_2d(queries), jnp.float32)
    scores = pairwise_scores(queries, v, simf)  # [Q, n]

    live = np.asarray(seg.graph.live)
    cap = v.shape[0]
    # docmap covers used ordinals; rows beyond are capacity-bucket padding
    docs = seg.docmap.ord_to_doc
    if docs.shape[0] < cap:
        docs = np.pad(docs, (0, cap - docs.shape[0]), constant_values=-1)
    valid = live[:cap] & (docs >= 0)
    if accept_ords is not None:
        acc = np.asarray(accept_ords)
        n_acc = min(acc.shape[0], cap)
        valid[:n_acc] &= acc[:n_acc]
        valid[n_acc:] = False  # filtered search: unmapped tail not accepted
    scores = jnp.where(jnp.asarray(valid)[None, :], scores, -jnp.inf)

    kk = min(k, scores.shape[1])
    top_s, top_i = jax.lax.top_k(scores, kk)
    top_s, top_i = np.asarray(top_s), np.asarray(top_i)
    doc_ids = np.where(top_s > -np.inf, docs[top_i], -1)
    if kk < k:
        doc_ids = np.pad(doc_ids, ((0, 0), (0, k - kk)), constant_values=-1)
        top_s = np.pad(top_s, ((0, 0), (0, k - kk)), constant_values=-np.inf)
    return doc_ids, top_s


def radial_search_segment(
    seg: Segment,
    queries: np.ndarray,
    score_floor: float,
    max_results: int = 10_000,
    accept_ords: np.ndarray | None = None,
):
    """Radial (range) search: all docs with score >= floor, best-first.

    Counterpart of the reference's radial queries (RNNQueryFactory;
    Lucene-engine only there — native here).
    """
    doc_ids, scores = exact_search_segment(
        seg, queries, min(max_results, seg.capacity() or 1),
        accept_ords=accept_ords,
    )
    keep = scores >= score_floor
    return np.where(keep, doc_ids, -1), np.where(keep, scores, -np.inf)
