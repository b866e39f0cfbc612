"""Segment reader: load + two-phase search + doc-id mapping + counters.

Device counterpart of `JVectorReader` (JVectorReader.java:130-211):
builds the score-function provider per quantization type (PQ approx +
rerank / NVQ rerank / exact — buildScoreFunctionProvider, :353-366), adapts
accepted-doc filters through the ordinal map (:156-164), searches with
(k, k*overquery_factor, threshold, rerankFloor, bits), maps node->docId on
collect, and records the query counters (:184-208).
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from opensearch_jvector_tpu.api.config import SearchConfig
from opensearch_jvector_tpu.api.stats import STATS, Counter, StatsRegistry
from opensearch_jvector_tpu.index import segment as segment_mod
from opensearch_jvector_tpu.index.segment import Segment
from opensearch_jvector_tpu.models import searcher as searcher_mod
from opensearch_jvector_tpu.models.searcher import SearchParams


@dataclasses.dataclass
class QueryResult:
    doc_ids: np.ndarray  # [Q, k] int64, -1 pad
    scores: np.ndarray  # [Q, k] f32, -inf pad
    visited: int
    expanded: int
    reranked: int


def _topk_scan(scores: jax.Array, r: int):
    """Exact top-(r) over a [Q, N] scan block (`ops/topk.exact_topk_wide`:
    top-r per 1024-wide block, then top-r of the survivors)."""
    from opensearch_jvector_tpu.ops.topk import exact_topk_wide

    return exact_topk_wide(scores, min(r, scores.shape[1]))


SCAN_BLOCK = 1 << 20  # bounds the [Q, block] score slab (~2GB at Q=512)


import functools as _functools


@_functools.partial(jax.jit, static_argnames=("simf_id", "r"))
def _decoded_block_topr(queries, dec, sq, valid, simf_id: int, r: int):
    """One scan block, fully fused under jit: bf16 matmul -> score -> mask
    -> top-r. Fusion keeps ONE [Q, block] slab live (eager evaluation
    would materialize every elementwise intermediate — 4x the slab)."""
    from opensearch_jvector_tpu.ops.distances import SimilarityFunction

    scores = _decoded_scan_scores(queries, dec, sq,
                                  SimilarityFunction(simf_id))
    scores = jnp.where(valid[None, :], scores, -jnp.inf)
    return _topk_scan(scores, r)


@_functools.partial(jax.jit, static_argnames=("simf_id", "r"))
def _exact_block_topr(queries, vec, valid, simf_id: int, r: int):
    from opensearch_jvector_tpu.ops.distances import (
        SimilarityFunction,
        pairwise_scores,
    )

    scores = pairwise_scores(queries, vec, SimilarityFunction(simf_id))
    scores = jnp.where(valid[None, :], scores, -jnp.inf)
    return _topk_scan(scores, r)


@_functools.partial(jax.jit, static_argnames=("simf_id", "r"))
def _adc_block_topr(luts, codes, valid, simf_id: int, r: int):
    from opensearch_jvector_tpu.ops import adc as adc_ops
    from opensearch_jvector_tpu.ops.distances import SimilarityFunction

    vals = adc_ops.lookup_scan(luts, codes)
    scores = adc_ops.adc_value_to_score(vals, SimilarityFunction(simf_id))
    scores = jnp.where(valid[None, :], scores, -jnp.inf)
    return _topk_scan(scores, r)


def _blocked_scan_topr(block_topr, n: int, r: int):
    """Running top-r over a blocked corpus scan.

    `block_topr(lo, hi) -> (top_s [Q, r'], top_i [Q, r'])` scores one
    corpus slice under ONE jit; blocks of SCAN_BLOCK keep the score slab
    bounded (a one-shot [Q, 16M] f32 matrix is 34GB). Returns (top_s,
    top_i) with global ids. Capacities are pow2, so every block shares one
    compiled shape.
    """
    best_s = best_i = None
    for lo in range(0, n, SCAN_BLOCK):
        hi = min(lo + SCAN_BLOCK, n)
        top_s, top_i = block_topr(lo, hi)
        top_i = top_i + lo
        if best_s is None:
            best_s, best_i = top_s, top_i
        else:
            cat_s = jnp.concatenate([best_s, top_s], axis=1)
            cat_i = jnp.concatenate([best_i, top_i], axis=1)
            best_s, sel = jax.lax.top_k(cat_s, min(r, cat_s.shape[1]))
            best_i = jnp.take_along_axis(cat_i, sel, axis=1)
    return best_s, best_i


def _decoded_scan_scores(queries: jax.Array, decoded: jax.Array,
                         dec_sq: jax.Array, simf) -> jax.Array:
    """[Q, N] approximate scores from the decoded-bf16 cache: one bf16
    matmul (f32 accumulation). Same score space as the ADC scan — the
    decoded cache IS the PQ reconstruction, so d(q, decode(c)) matches the
    LUT decomposition; bf16 rounding is absorbed by the exact rerank."""
    from opensearch_jvector_tpu.ops.distances import SimilarityFunction

    if simf is SimilarityFunction.COSINE:
        queries = queries * jax.lax.rsqrt(
            jnp.sum(queries * queries, -1, keepdims=True) + 1e-30
        )
    dot = jax.lax.dot_general(
        queries.astype(decoded.dtype), decoded,
        (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32,
    )
    if simf is SimilarityFunction.EUCLIDEAN:
        q2 = jnp.sum(queries * queries, -1)[:, None]
        d2 = jnp.maximum(q2 + dec_sq[None, :] - 2.0 * dot, 0.0)
        return 1.0 / (1.0 + d2)
    return (1.0 + dot) / 2.0  # DOT_PRODUCT / COSINE (pre-normalized)


def ordinal_accept_mask(seg: Segment, accept_docs,
                        deleted_docs=None) -> np.ndarray | None:
    """Accepted docs -> graph-ordinal bitmap (Bits adapter parity).

    `deleted_docs` (index-level tombstones not yet folded by a merge) are
    intersected INTO the mask, matching the reference where deletions reach
    the searcher as liveDocs accept bits — post-search masking would let
    dead docs consume the k result slots. Returns None when unfiltered.
    """
    if accept_docs is None and not deleted_docs:
        return None
    o2d = seg.docmap.ord_to_doc
    if accept_docs is None:
        mask = o2d >= 0
    else:
        accept_docs = np.asarray(accept_docs)
        if accept_docs.dtype == bool:
            ok = (o2d >= 0) & (o2d < accept_docs.shape[0])
            mask = np.zeros(o2d.shape[0], bool)
            mask[ok] = accept_docs[o2d[ok]]
        else:  # a set/array of accepted doc ids
            mask = np.isin(o2d, accept_docs) & (o2d >= 0)
    if deleted_docs:
        dead = np.fromiter(deleted_docs, np.int64)
        mask = mask & ~np.isin(o2d, dead)
    cap = seg.graph.capacity
    if mask.shape[0] < cap:
        mask = np.pad(mask, (0, cap - mask.shape[0]))
    return mask[:cap]


class SegmentReader:
    def __init__(self, seg: Segment, stats: StatsRegistry = STATS):
        self.seg = seg
        self.stats = stats
        self._pq_decoded: jax.Array | None = None  # lazy bf16 ADC cache
        self._pq_decoded_sq: jax.Array | None = None  # row norms (f32)

    def _decoded_cache(self) -> jax.Array:
        """Decoded-bf16 candidate cache for the in-graph ADC tier (built
        once per open segment; 2*d bytes/vector of device memory,
        breaker-accounted)."""
        if self._pq_decoded is None:
            from opensearch_jvector_tpu.utils.circuit_breaker import BREAKER

            n, d = self.seg.capacity(), self.seg.config.dim
            if self.seg.nvq is not None:  # NVQ scan tier: decode inline codes
                # account the TRANSIENT f32 decode (4B/dim) on top of the
                # 2B/dim cache it is cast down to
                BREAKER.check(n * d * 6)
                self._pq_decoded = self.seg.nvq.decode().astype(jnp.bfloat16)
            else:
                BREAKER.check(n * d * 2)
                self._pq_decoded = self.seg.pqv.decode_bf16()
            self._pq_decoded_sq = jnp.einsum(
                "nd,nd->n", self._pq_decoded, self._pq_decoded,
                preferred_element_type=jnp.float32,
            )
        return self._pq_decoded

    @classmethod
    def open(cls, path: str | Path, verify: bool = True,
             stats: StatsRegistry = STATS) -> "SegmentReader":
        return cls(segment_mod.read_segment(path, verify=verify), stats)

    def check_integrity(self, path: str | Path) -> bool:
        return segment_mod.check_integrity(path)

    def _accept_mask(self, accept_docs, deleted_docs=None) -> jax.Array | None:
        mask = ordinal_accept_mask(self.seg, accept_docs, deleted_docs)
        return None if mask is None else jnp.asarray(mask)

    def search(
        self,
        queries,  # [Q, d]
        sc: SearchConfig,
        accept_docs=None,  # bool array over doc ids, or array of doc ids
        deleted_docs=None,  # set of tombstoned doc ids (liveDocs analog)
    ) -> QueryResult:
        seg = self.seg
        queries = jnp.asarray(queries, jnp.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        if seg.capacity() == 0:  # fully-empty segment (e.g. all-deleted merge)
            qn0 = queries.shape[0]
            return QueryResult(
                doc_ids=np.full((qn0, sc.k), -1, np.int64),
                scores=np.full((qn0, sc.k), -np.inf, np.float32),
                visited=0, expanded=0, reranked=0,
            )
        # Bucket the batch size to a power of two (min 8): each distinct
        # shape is a separate XLA compile, and callers send arbitrary counts.
        from opensearch_jvector_tpu.models.graph import bucket_capacity

        real_q = queries.shape[0]
        bucket = bucket_capacity(real_q, minimum=8)
        if bucket != real_q:
            queries = jnp.concatenate(
                [queries,
                 jnp.broadcast_to(queries[:1],
                                  (bucket - real_q, queries.shape[1]))]
            )

        params = SearchParams(
            k=sc.k,
            ef_search=sc.resolved_ef(),
            overquery_factor=sc.overquery_factor,
            threshold=sc.threshold,
            rerank_floor=sc.rerank_floor,
        )
        accept = self._accept_mask(accept_docs, deleted_docs)

        flat = seg.config.index_type == "flat"
        if seg.row_store is not None:  # on_disk mode: host-tier rerank
            return self._tiered_search(
                queries, real_q, params, accept, accept_docs is not None,
                force_scan=flat,
            )
        if flat and seg.pqv is None:
            # flat + no quantization: exact brute-force scan
            return self._scan_search(
                queries, real_q, params, accept, accept_docs is not None
            )
        if (
            seg.pqv is not None
            and seg.nvq is None
            and seg.scalar_state is None
            and seg.vectors is not None
            and (flat or seg.capacity() <= self._scan_bound())
        ):
            # in-memory PQ segments below the tier bound take the ADC full
            # scan + exact rerank (exhaustive approximate phase); which tier
            # is faster on the H100 is not measured yet
            return self._scan_search(
                queries, real_q, params, accept, accept_docs is not None
            )
        if (
            seg.nvq is not None
            and seg.capacity() <= self._scan_bound()
        ):
            # NVQ segments below the tier bound: exhaustive scan over the
            # NVQ-decoded bf16 cache (same scan-beats-graph policy as PQ;
            # the decode is once per segment load, rerank reads the same
            # reconstruction the graph tier's NVQ rerank would)
            return self._scan_search(
                queries, real_q, params, accept, accept_docs is not None
            )

        kwargs: dict = {}
        if seg.graph.upper_adjacency is not None:  # hierarchy layer
            kwargs["upper_adjacency"] = seg.graph.upper_adjacency
        vectors, nvq = seg.rerank_source()
        # Provider choice: when fp32 rows are device-resident (in_memory
        # PQ segments keep them for rerank anyway), beam candidates are
        # scored exactly from them, so the PQ codes serve build scoring /
        # merges / the on_disk tier instead of the in-memory query path.
        # NVQ segments have no resident fp32 -> the aux PQ drives the
        # approximate phase, NVQ decode drives rerank (reference behavior).
        if vectors is not None:
            kwargs["vectors"] = vectors
        elif seg.pqv is not None:
            kwargs["pq_codes"] = seg.pqv.codes
            kwargs["pq_codebooks"] = seg.pqv.pq.codebooks
            kwargs["pq_center"] = seg.pqv.pq.center
        if seg.scalar_state is not None:
            # scalar (1/2/4-bit) mode: Hamming approximate phase over
            # bit-packed codes, exact fp32 rerank (vectors stay resident)
            kwargs["scalar_codes"] = seg.scalar_codes
            kwargs["scalar_thresholds"] = jnp.asarray(
                seg.scalar_state.thresholds
            )
        if nvq is not None:
            kwargs["nvq"] = nvq
            # approximate phase rides the aux PQ; exact phase decodes NVQ
            assert seg.pqv is not None, (
                "NVQ segments always carry an aux PQ (nvq+pq)"
            )

        from opensearch_jvector_tpu.utils.profiling import phase

        t0 = time.monotonic()
        with phase("query", stats=self.stats):
            res = searcher_mod.search(
                seg.graph.adjacency,
                seg.graph.live,
                seg.graph.entry,
                queries,
                params,
                seg.config.similarity,
                accept=accept,
                **kwargs,
            )
            # ONE host transfer for results + every counter
            res = dataclasses.replace(
                res, **dict(zip(
                    ("ids", "scores", "visited_count", "expanded_count",
                     "reranked_count", "expanded_base_count"),
                    jax.device_get((
                        res.ids, res.scores, res.visited_count,
                        res.expanded_count, res.reranked_count,
                        res.expanded_base_count,
                    )),
                ))
            )
        self.stats.increment(
            Counter.KNN_GRAPH_SEARCH_TIME, int((time.monotonic() - t0) * 1000)
        )
        if real_q != queries.shape[0]:  # drop bucket padding
            res = dataclasses.replace(
                res,
                ids=res.ids[:real_q],
                scores=res.scores[:real_q],
                visited_count=res.visited_count[:real_q],
                expanded_count=res.expanded_count[:real_q],
                reranked_count=res.reranked_count[:real_q],
                expanded_base_count=(
                    res.expanded_base_count[:real_q]
                    if res.expanded_base_count is not None else None
                ),
            )

        qn = real_q
        self.stats.increment(Counter.KNN_QUERY_COUNT, qn)
        if accept_docs is not None:
            self.stats.increment(Counter.KNN_QUERY_WITH_FILTER_COUNT, qn)
        visited = int(np.asarray(res.visited_count).sum())
        expanded = int(np.asarray(res.expanded_count).sum())
        reranked = int(np.asarray(res.reranked_count).sum())
        base_expanded = (
            int(np.asarray(res.expanded_base_count).sum())
            if res.expanded_base_count is not None else expanded
        )
        self.stats.increment(Counter.KNN_QUERY_VISITED_NODES, visited)
        self.stats.increment(Counter.KNN_QUERY_EXPANDED_NODES, expanded)
        self.stats.increment(
            Counter.KNN_QUERY_EXPANDED_BASE_LAYER_NODES, base_expanded
        )
        self.stats.increment(Counter.KNN_QUERY_RERANKED_COUNT, reranked)

        ords = np.asarray(res.ids)
        doc_ids = self.seg.docmap.lookup_docs(ords)
        scores = np.asarray(res.scores)
        # a live ordinal whose doc was deleted maps to -1; mask its score
        scores = np.where(doc_ids >= 0, scores, -np.inf)
        return QueryResult(
            doc_ids=doc_ids,
            scores=scores,
            visited=visited,
            expanded=expanded,
            reranked=reranked,
        )

    # Segments of at most this many codes serve queries through an
    # exhaustive ADC scan + exact rerank instead of graph traversal. The
    # bound is inherited, not derived on the H100 (ROADMAP D4).
    SCAN_TIER_MAX_CODES = 1 << 18

    def _scan_bound(self) -> int:
        """Effective scan-tier bound: the dynamic cluster setting
        `index.knn.advanced.scan_tier_max_codes` when set (>= 0), else the
        class default. Operators raise it for adversarial corpora (e.g.
        i.i.d. high-dim data) where distance concentration caps graph-tier
        recall and an exhaustive scan is the only way to the recall
        target."""
        from opensearch_jvector_tpu.api.settings import GLOBAL_SETTINGS

        v = GLOBAL_SETTINGS.get("index.knn.advanced.scan_tier_max_codes")
        return self.SCAN_TIER_MAX_CODES if v < 0 else v

    def _scan_search(self, queries, real_q, params: SearchParams, accept,
                     filtered: bool) -> QueryResult:
        """ADC full scan + DEVICE-side exact rerank for in-memory PQ
        segments below the scan-tier bound (the default PQ config at
        <=256k codes)."""
        from opensearch_jvector_tpu.ops.distances import (
            batched_candidate_scores,
        )

        seg = self.seg
        r = max(params.k * params.overquery_factor, params.k)
        t0 = time.monotonic()
        if accept is None:
            o2d = seg.docmap.ord_to_doc
            m = np.asarray(seg.graph.live).copy()
            m[: o2d.shape[0]] &= o2d >= 0
            m[o2d.shape[0]:] = False
            valid = jnp.asarray(m)
        else:
            valid = accept
        from opensearch_jvector_tpu.ops.distances import SimilarityFunction

        simf_id = seg.config.similarity.value
        if seg.nvq is not None:
            # NVQ scan tier: exhaustive scan over the NVQ-decoded cache
            # (must come before the pqv branch — NVQ segments also carry
            # the aux PQ, whose codes are NOT the rerank source)
            decoded = self._decoded_cache()
            dec_sq = self._pq_decoded_sq

            def block_topr(lo, hi):
                return _decoded_block_topr(
                    queries, decoded[lo:hi], dec_sq[lo:hi], valid[lo:hi],
                    simf_id, r,
                )
        elif seg.pqv is not None:
            luts = seg.pqv.build_query_luts(queries, seg.config.similarity)

            def block_topr(lo, hi):
                return _adc_block_topr(
                    luts, seg.pqv.codes[lo:hi], valid[lo:hi], simf_id, r
                )
        else:  # flat + unquantized: exact scores
            def block_topr(lo, hi):
                return _exact_block_topr(
                    queries, seg.vectors[lo:hi], valid[lo:hi], simf_id, r
                )
        approx, cand_ids = _blocked_scan_topr(block_topr, seg.capacity(), r)
        rr = approx.shape[1]
        qualify = approx > -jnp.inf
        if params.rerank_floor > 0.0:
            qualify &= approx >= params.rerank_floor
        if (seg.nvq is not None
                and seg.config.similarity is not SimilarityFunction.COSINE):
            # NVQ rerank would re-score the SAME decoded rows the scan just
            # scored — for L2/dot the approx scores ARE the exact scores of
            # the reconstruction, so skip the redundant gather+matmul.
            # (Cosine still reranks: the NVQ reconstruction is not
            # normalized, so the scan's dot ordering needs the true cosine.)
            exact = jnp.where(qualify, approx, -jnp.inf)
        else:
            rerank_rows = (seg.vectors if seg.vectors is not None
                           else self._decoded_cache())  # NVQ reconstruction
            cand = rerank_rows[jnp.clip(cand_ids, 0)].astype(jnp.float32)
            exact = batched_candidate_scores(queries, cand,
                                             seg.config.similarity)
            exact = jnp.where(qualify, exact, -jnp.inf)
        kk = min(params.k, rr)
        top_s, idx = jax.lax.top_k(exact, kk)
        top_i = jnp.take_along_axis(cand_ids, idx, axis=1)
        keep = top_s > -jnp.inf
        if params.threshold > 0.0:
            keep &= top_s >= params.threshold
        top_i = jnp.where(keep, top_i, -1)
        top_s = jnp.where(keep, top_s, -jnp.inf)
        # ONE host transfer for results + counters
        top_i, top_s, scanned, rer_q = jax.device_get(
            (top_i, top_s, jnp.sum(valid), jnp.sum(qualify, axis=1))
        )
        self.stats.increment(
            Counter.KNN_GRAPH_SEARCH_TIME, int((time.monotonic() - t0) * 1000)
        )

        top_i = top_i[:real_q]
        top_s = top_s[:real_q]
        if kk < params.k:
            padw = params.k - kk
            top_i = np.pad(top_i, ((0, 0), (0, padw)), constant_values=-1)
            top_s = np.pad(top_s, ((0, 0), (0, padw)),
                           constant_values=-np.inf)
        qn = real_q
        scanned = int(scanned)
        reranked = int(rer_q[:real_q].sum())
        self.stats.increment(Counter.KNN_QUERY_COUNT, qn)
        if filtered:
            self.stats.increment(Counter.KNN_QUERY_WITH_FILTER_COUNT, qn)
        self.stats.increment(Counter.KNN_QUERY_VISITED_NODES, scanned * qn)
        self.stats.increment(Counter.KNN_QUERY_EXPANDED_NODES, 0)
        self.stats.increment(Counter.KNN_QUERY_EXPANDED_BASE_LAYER_NODES, 0)
        self.stats.increment(Counter.KNN_QUERY_RERANKED_COUNT, reranked)

        doc_ids = seg.docmap.lookup_docs(top_i)
        scores = np.where(doc_ids >= 0, top_s, -np.inf)
        return QueryResult(
            doc_ids=doc_ids, scores=scores,
            visited=scanned * qn, expanded=0, reranked=reranked,
        )

    def _tiered_search(self, queries, real_q, params: SearchParams, accept,
                       filtered: bool, force_scan: bool = False
                       ) -> QueryResult:
        """on_disk mode: ADC approximate phase on device, fp32 rows paged
        from the native host store for the rerank — the BigANN-scale tier
        (BASELINE.json config 5).

        Device memory per vector: M bytes (codes) + max_degree*4
        (adjacency, beam tier only), PLUS — when the memory circuit
        breaker allows it — a 2*d-byte decoded-bf16 scoring cache that
        both tiers prefer (scan: one bf16 matmul; beam: row gathers +
        einsum). When the breaker refuses the cache, both tiers degrade
        to codes-only scoring at M bytes/vector: the scan tier via
        per-query lookup tables (`ops/adc.lookup_scan`), the beam tier
        via the decode-then-score "pq" provider (gathered codebook rows +
        einsum) during traversal.
        `force_scan` pins flat (graph-less) segments to the scan tier at
        any capacity.
        """
        from opensearch_jvector_tpu.ops.distances import (
            host_candidate_scores,
        )

        seg = self.seg
        assert seg.pqv is not None, "on_disk segments require PQ codes"
        r = max(params.k * params.overquery_factor, params.k)
        t0 = time.monotonic()
        if force_scan or seg.capacity() <= self._scan_bound():
            from opensearch_jvector_tpu.utils.circuit_breaker import (
                CircuitBreakerException,
            )

            if accept is None:
                o2d = seg.docmap.ord_to_doc
                m = np.asarray(seg.graph.live).copy()
                m[: o2d.shape[0]] &= o2d >= 0
                m[o2d.shape[0]:] = False
                valid = jnp.asarray(m)
            else:
                valid = accept
            simf_id = seg.config.similarity.value
            try:
                decoded = self._decoded_cache()
                dec_sq = self._pq_decoded_sq

                def block_topr(lo, hi):
                    return _decoded_block_topr(
                        queries, decoded[lo:hi], dec_sq[lo:hi],
                        valid[lo:hi], simf_id, r,
                    )
            except CircuitBreakerException:  # memory-tight: ADC over codes
                luts = seg.pqv.build_query_luts(queries,
                                                seg.config.similarity)

                def block_topr(lo, hi):
                    return _adc_block_topr(
                        luts, seg.pqv.codes[lo:hi], valid[lo:hi],
                        simf_id, r,
                    )
            top_s, top_i = _blocked_scan_topr(block_topr, seg.capacity(), r)
            # ONE device fetch for candidates + the visited counter.
            # Counter semantics at the tier boundary: the scan tier reports
            # visited = scanned codes per query (ef_search/use_pruning do
            # not apply to an exhaustive scan) — documented divergence from
            # the beam tier's visited-during-traversal count.
            top_i, top_s, scanned = jax.device_get(
                (top_i, top_s, jnp.sum(valid))
            )
            cand_ids = top_i[:real_q]
            approx = top_s[:real_q]
            cand_ids = np.where(approx > -np.inf, cand_ids, -1)
            if cand_ids.shape[1] < r:  # tiny segment: pad to r
                padw = r - cand_ids.shape[1]
                cand_ids = np.pad(cand_ids, ((0, 0), (0, padw)),
                                  constant_values=-1)
                approx = np.pad(approx, ((0, 0), (0, padw)),
                                constant_values=-np.inf)
            scanned = int(scanned)
            res = searcher_mod.SearchResult(
                ids=None, scores=None,
                visited_count=np.full(queries.shape[0], scanned, np.int64),
                expanded_count=np.zeros(queries.shape[0], np.int64),
                reranked_count=None,
            )
        else:
            # in-graph ADC tier (>SCAN_TIER_MAX_CODES): beam candidates are
            # scored from the decoded-bf16 cache (row gathers + einsum);
            # see PQVectors.decode_bf16. Memory-tight segments (breaker
            # refuses the 2*d-byte cache) degrade to codes-only traversal:
            # the "pq" provider gathers candidates' codebook rows and
            # scores them — device memory stays at M bytes/vector, the
            # designated larger-than-memory configuration.
            from opensearch_jvector_tpu.utils.circuit_breaker import (
                CircuitBreakerException,
            )

            kwargs: dict = {}
            if seg.graph.upper_adjacency is not None:
                kwargs["upper_adjacency"] = seg.graph.upper_adjacency
            try:
                kwargs["pq_decoded"] = self._decoded_cache()
            except CircuitBreakerException:
                kwargs["pq_codes"] = seg.pqv.codes
                kwargs["pq_codebooks"] = seg.pqv.pq.codebooks
                kwargs["pq_center"] = seg.pqv.pq.center
            res = searcher_mod.search(
                seg.graph.adjacency, seg.graph.live, seg.graph.entry, queries,
                dataclasses.replace(params, k=r),
                seg.config.similarity,
                accept=accept,
                **kwargs,
            )
            cand_ids = np.asarray(res.ids)[:real_q]
            approx = np.asarray(res.scores)[:real_q]
        qn = real_q
        qualify = cand_ids >= 0
        if params.rerank_floor > 0.0:
            qualify &= approx >= params.rerank_floor
        flat = cand_ids.reshape(-1)
        seg.row_store.prefetch(flat)
        rows = seg.row_store.gather(flat).reshape(qn, r, -1)
        # HOST-side exact rerank: the rows are already host-resident (the
        # native store gathered them from the raw row file), and scoring
        # qn*r candidates is a few MFLOP of numpy. The reference's DiskANN
        # rerank is host-side too (JVectorReader.java:166-208). Whether a
        # device rerank is faster over PCIe is not measured (ROADMAP S6).
        exact = host_candidate_scores(
            np.asarray(queries[:qn], np.float32), rows,
            seg.config.similarity,
        )
        exact = np.where(qualify, exact, -np.inf)
        if params.k < exact.shape[1]:
            idx = np.argpartition(-exact, params.k - 1, axis=1)[
                :, : params.k]
        else:
            idx = np.broadcast_to(
                np.arange(exact.shape[1])[None, :], exact.shape).copy()
        sel = np.take_along_axis(exact, idx, axis=1)
        order = np.argsort(-sel, axis=1, kind="stable")
        idx = np.take_along_axis(idx, order, axis=1)
        top_s = np.take_along_axis(exact, idx, axis=1)
        top_i = np.take_along_axis(cand_ids, idx, axis=1)
        if params.threshold > 0.0:
            keep = top_s >= params.threshold
            top_i = np.where(keep, top_i, -1)
            top_s = np.where(keep, top_s, -np.inf)
        top_i = np.where(top_s > -np.inf, top_i, -1)
        self.stats.increment(
            Counter.KNN_GRAPH_SEARCH_TIME, int((time.monotonic() - t0) * 1000)
        )
        self.stats.increment(Counter.KNN_QUERY_COUNT, qn)
        if filtered:
            self.stats.increment(Counter.KNN_QUERY_WITH_FILTER_COUNT, qn)
        visited = int(np.asarray(res.visited_count)[:real_q].sum())
        expanded = int(np.asarray(res.expanded_count)[:real_q].sum())
        reranked = int(qualify.sum())
        self.stats.increment(Counter.KNN_QUERY_VISITED_NODES, visited)
        self.stats.increment(Counter.KNN_QUERY_EXPANDED_NODES, expanded)
        self.stats.increment(
            Counter.KNN_QUERY_EXPANDED_BASE_LAYER_NODES, expanded
        )
        self.stats.increment(Counter.KNN_QUERY_RERANKED_COUNT, reranked)

        doc_ids = seg.docmap.lookup_docs(top_i)
        scores = np.where(doc_ids >= 0, top_s, -np.inf)
        return QueryResult(
            doc_ids=doc_ids, scores=scores,
            visited=visited, expanded=expanded, reranked=reranked,
        )
