"""MMR (maximal marginal relevance) reranking.

Mirrors the reference's MMR search-pipeline pair
(search/processor/mmr/): `MMROverSampleProcessor` bumps the fetch size to
`candidates` (default 3x size, MMRSearchExtBuilder.java:127-143), then
`MMRRerankProcessor` greedily selects
    argmax (1 - diversity) * relevance - diversity * maxSimToSelected
(MMRRerankProcessor.java:201-237). The vector similarity used for the
diversity term is the index's similarity function over the hit vectors.

Here both halves are one call: `mmr_search` oversamples, then a vectorized
greedy loop reranks on device-gathered vectors.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax.numpy as jnp

from opensearch_jvector_tpu.api.config import SearchConfig, ValidationError
from opensearch_jvector_tpu.index.index import VectorIndex
from opensearch_jvector_tpu.index.reader import QueryResult
from opensearch_jvector_tpu.ops.distances import pairwise_scores

DEFAULT_DIVERSITY = 0.5  # MMRSearchExtBuilder default
DEFAULT_CANDIDATE_MULTIPLIER = 3  # candidates default 3x size


@dataclasses.dataclass
class MMRParams:
    diversity: float = DEFAULT_DIVERSITY
    candidates: int | None = None  # None -> 3 * size

    def __post_init__(self):
        if not 0.0 <= self.diversity <= 1.0:
            raise ValidationError(
                f"mmr.diversity must be in [0, 1]: {self.diversity}"
            )


def mmr_rerank(
    candidate_vectors: np.ndarray,  # [C, d] vectors of the hits
    relevance: np.ndarray,  # [C] relevance scores (higher better)
    size: int,
    diversity: float,
    simf,
) -> np.ndarray:
    """Greedy MMR selection -> indices into the candidate list, [size]."""
    c = relevance.shape[0]
    size = min(size, c)
    sims = np.asarray(
        pairwise_scores(
            jnp.asarray(candidate_vectors, jnp.float32),
            jnp.asarray(candidate_vectors, jnp.float32),
            simf,
        )
    )
    lam = diversity
    selected: list[int] = []
    max_sim = np.full((c,), -np.inf)
    avail = relevance > -np.inf
    for _ in range(size):
        penal = np.where(np.isfinite(max_sim), max_sim, 0.0)
        mmr = (1.0 - lam) * relevance - lam * penal
        mmr = np.where(avail, mmr, -np.inf)
        i = int(np.argmax(mmr))
        if not avail[i] or mmr[i] == -np.inf:
            break
        selected.append(i)
        avail[i] = False
        max_sim = np.maximum(max_sim, sims[i])
    return np.asarray(selected, np.int64)


def mmr_search(
    index: VectorIndex,
    query_vector: np.ndarray,
    size: int,
    params: MMRParams | None = None,
    sc: SearchConfig | None = None,
    vector_source: VectorIndex | None = None,
) -> QueryResult:
    """Oversampled search + MMR rerank (the full pipeline in one call).

    Batched: `query_vector` may be [d] or [Q, d]. The oversampled ANN
    search runs as ONE device dispatch for the whole batch (batch
    amortization), and the candidate vectors
    come back in ONE bulk `get_vectors`; only the tiny greedy selection
    loops per query on the host.

    `vector_source` (the reference's `vector_field_path`,
    MMRSearchExtBuilder): diversity vectors may come from a DIFFERENT
    knn_vector field's index than the one searched; hits missing in the
    source field are excluded from the selection (they carry no vector
    to diversify against).
    """
    params = params or MMRParams()
    candidates = params.candidates or DEFAULT_CANDIDATE_MULTIPLIER * size
    sc = sc or SearchConfig(k=candidates)
    if sc.k < candidates:
        sc = dataclasses.replace(sc, k=candidates)
    res = index.search(query_vector, sc)

    qn, c = res.doc_ids.shape
    flat_ids = res.doc_ids.reshape(-1)
    if not (flat_ids >= 0).any():
        return res

    # pull candidate vectors from the segments (derived-source analog:
    # vectors are fetched from the index storage, not duplicated in _source)
    # via the per-segment doc->ordinal inverse — O(hits), not O(N)
    src = vector_source if vector_source is not None else index
    vecs, found = src.get_vectors(flat_ids)
    vecs = vecs.reshape(qn, c, -1)
    found = found.reshape(qn, c)

    out_ids = np.full((qn, size), -1, np.int64)
    out_scores = np.full((qn, size), -np.inf, np.float32)
    for qi in range(qn):
        ids = res.doc_ids[qi]
        valid = ids >= 0
        if not valid.any():
            continue
        rel = np.where(valid & found[qi], res.scores[qi], -np.inf)
        order = mmr_rerank(vecs[qi], rel, size, params.diversity,
                           src.config.similarity)
        out_ids[qi, : order.size] = ids[order]
        out_scores[qi, : order.size] = res.scores[qi][order]
    return dataclasses.replace(res, doc_ids=out_ids, scores=out_scores)
