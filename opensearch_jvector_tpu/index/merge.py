"""Segment merging: incremental leading-segment merge + codebook reuse.

Device counterpart of the reference's merge path
(JVectorWriter.mergeOneField -> RandomAccessMergedFloatVectorValues.merge,
JVectorWriter.java:192-213, 1010-1025):

  * leading-reader election = segment with the most live vectors
    (JVectorWriter.java:785-818)
  * incremental "leading segment merge" (tryLeadingSegmentMerge,
    :1166-1341): reload the leading graph from its checkpoint, append the
    other segments' vectors as delta inserts, fold deletes in at cleanup —
    skipped when disabled, on ordinal overflow, or when live density < 0.4
    (:1202-1222)
  * PQ codebook reuse on merge: reuse leading codebooks and re-encode all
    vectors (:1110-1125) — PLUS the refinement step the reference documents
    as TODO (issue #661, :1118-1123): a few Lloyd iterations adapt the
    codebooks to the merged distribution before re-encode
  * NVQ merge always recomputes (mergeNVQ, :1030-1066)

Design simplification vs the reference: the reference juggles four ordinal
spaces during merge (:728-735, ~700 LoC of bookkeeping); here every segment
has a single stable ordinal space with tombstones, and the merged segment's
ordinal space is [leading ordinals | appended ordinals], compacted only by
the density guard forcing a full rebuild.
"""

from __future__ import annotations

import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from opensearch_jvector_tpu.api.config import (
    QUANT_NONE,
    QUANT_NVQ,
    SCALAR_BITS,
    SCALAR_QUANTS,
    DiskAnnConfig,
)
from opensearch_jvector_tpu.api.stats import STATS, Counter, StatsRegistry
from opensearch_jvector_tpu.index.docmap import DocMap
from opensearch_jvector_tpu.index.segment import Segment, read_segment, write_segment
from opensearch_jvector_tpu.models import nvq as nvq_mod
from opensearch_jvector_tpu.models import pq as pq_mod
from opensearch_jvector_tpu.models.builder import GraphIndexBuilder
from opensearch_jvector_tpu.models.graph import VamanaGraph

MIN_LEADING_DENSITY = 0.4  # reference guard (JVectorWriter.java:1202-1222)
MAX_ORDINALS = 2**31 - 1


def _materialize_vectors(seg: Segment) -> jnp.ndarray:
    """fp32 rows for a segment's USED ordinals (decodes NVQ / pages the
    host tier). Rows beyond `docmap.num_ordinals` are capacity-bucket
    padding, never real vectors — sliced off here."""
    used = seg.docmap.num_ordinals
    if seg.vectors is not None:
        return seg.vectors[:used]
    if seg.row_store is not None:  # on_disk mode (stores exact rows)
        rows = seg.row_store.gather(np.arange(seg.row_store.num_rows))
        return jnp.asarray(rows)[:used]
    assert seg.nvq is not None
    return seg.nvq.decode()[:used]


def _elect_leading(segments: list[Segment]) -> int:
    """Index of the segment with the most live vectors."""
    return int(np.argmax([s.live_count() for s in segments]))


def merge_segments(
    root: str | Path,
    segments: list[Segment],
    out_name: str,
    stats: StatsRegistry = STATS,
    builder_batch_size: int | None = None,  # None -> builder auto-sizes by dim
) -> Path:
    """Merge segments into one; incremental when the guards allow."""
    from opensearch_jvector_tpu.utils.profiling import phase

    with phase("merge", stats=stats):
        return _merge_segments_timed(
            root, segments, out_name, stats, builder_batch_size
        )


def _merge_segments_timed(
    root: str | Path,
    segments: list[Segment],
    out_name: str,
    stats: StatsRegistry,
    builder_batch_size: int | None,
) -> Path:
    t0 = time.monotonic()
    assert segments, "nothing to merge"
    cfg = segments[0].config
    # breaker guards merges: the merged segment + the sources coexist in
    # device memory while the new graph builds
    from opensearch_jvector_tpu.utils.circuit_breaker import BREAKER

    total = sum(s.capacity() for s in segments)
    BREAKER.check(
        BREAKER.estimate_segment_bytes(
            total, cfg.dim, cfg.m, cfg.neighbor_overflow,
            cfg.num_pq_subspaces
            if cfg.quantization_type != QUANT_NONE else None,
        )
    )
    lead_idx = _elect_leading(segments)
    lead = segments[lead_idx]
    others = [s for i, s in enumerate(segments) if i != lead_idx]

    # density over USED ordinals (docmap length): capacity-bucket padding is
    # free tail space, not fragmentation — only real delete holes count
    lead_used = lead.docmap.num_ordinals
    lead_density = (
        lead.live_count() / max(lead_used, 1) if lead_used else 0.0
    )
    use_incremental = (
        not cfg.leading_segment_merge_disabled
        and cfg.quantization_type != QUANT_NVQ  # NVQ always rebuilds (parity)
        and cfg.index_type != "flat"  # flat merges are concat-only rebuilds
        and lead_used + sum(s.live_count() for s in others) < MAX_ORDINALS
        and lead_density >= MIN_LEADING_DENSITY
        and lead.live_count() > 0
    )

    if use_incremental:
        seg = _incremental_merge(cfg, lead, others, out_name, builder_batch_size)
    else:
        seg = _full_rebuild_merge(cfg, segments, out_name, builder_batch_size)

    path = write_segment(root, seg)
    stats.increment(Counter.KNN_GRAPH_MERGE_TIME,
                    int((time.monotonic() - t0) * 1000))
    stats.increment(Counter.KNN_MERGE_COUNT)
    return path


def _merged_scalar(cfg: DiskAnnConfig, all_vectors):
    """Scalar (1/2/4-bit) merge recomputes thresholds + codes from scratch
    over the merged rows (same policy as NVQ: cheap retrain, exact codes)."""
    if cfg.quantization_type not in SCALAR_QUANTS:
        return None
    from opensearch_jvector_tpu.models import scalar as scalar_mod

    import jax.numpy as _jnp

    state = scalar_mod.train_scalar_quantizer(
        np.asarray(all_vectors), bits=SCALAR_BITS[cfg.quantization_type]
    )
    codes = scalar_mod.quantize_vectors(state, all_vectors)
    return state, _jnp.asarray(codes)


def _merged_pq(cfg: DiskAnnConfig, lead: Segment, all_vectors, n_live):
    """PQ policy on merge: reuse leading codebooks + refine + re-encode;
    train fresh when the leading segment has none and n >= min batch."""
    if cfg.quantization_type == QUANT_NONE or (
        cfg.quantization_type in SCALAR_QUANTS
    ):
        return None
    if lead.pqv is not None:
        refined = pq_mod.refine_pq(lead.pqv.pq, all_vectors, cfg.similarity)
        codes = pq_mod.encode(refined, all_vectors, cfg.similarity)
        return pq_mod.PQVectors(pq=refined, codes=codes)
    if n_live >= cfg.min_batch_size_for_quantization:
        pq = pq_mod.train_pq(
            all_vectors, cfg.similarity, num_subspaces=cfg.num_pq_subspaces,
            anisotropic_eta=pq_mod.eta_from_config(cfg, all_vectors),
        )
        codes = pq_mod.encode(pq, all_vectors, cfg.similarity)
        return pq_mod.PQVectors(pq=pq, codes=codes)
    return None


def _incremental_merge(
    cfg: DiskAnnConfig,
    lead: Segment,
    others: list[Segment],
    out_name: str,
    batch_size: int,
) -> Segment:
    """Append the other segments' live vectors into the leading graph.

    New ordinals start at the lead's USED count (docmap length) — the lead
    graph's capacity bucket may be larger, and that padded tail is free
    slot space the delta inserts occupy first.
    """
    lead_used = lead.docmap.num_ordinals
    lead_vecs = _materialize_vectors(lead)  # [lead_used, d]

    new_vec_blocks, new_doc_blocks, new_parent_blocks = [], [], []
    for s in others:
        live = np.asarray(s.graph.live)
        docs = s.docmap.ord_to_doc
        keep = live[: docs.shape[0]] & (docs >= 0)
        ids = np.nonzero(keep)[0]
        if ids.size == 0:
            continue
        v = _materialize_vectors(s)
        new_vec_blocks.append(np.asarray(v)[ids])
        new_doc_blocks.append(docs[ids])
        new_parent_blocks.append(
            s.docmap.ord_to_parent[ids]
            if s.docmap.ord_to_parent is not None
            else np.full(ids.size, -1, np.int64)
        )
    n_new = sum(b.shape[0] for b in new_vec_blocks)

    used = lead_used + n_new
    from opensearch_jvector_tpu.models.graph import bucket_capacity, pad_rows

    capacity = max(bucket_capacity(used), lead.capacity())
    exact_vectors = jnp.concatenate(
        [jnp.asarray(lead_vecs)]
        + [jnp.asarray(b) for b in new_vec_blocks]
    ) if n_new else jnp.asarray(lead_vecs)  # [used, d] real rows only
    all_vectors = pad_rows(exact_vectors, capacity)

    graph = lead.graph.with_capacity(capacity)
    builder = GraphIndexBuilder(
        dim=cfg.dim,
        max_degree=cfg.m,
        beam_width=cfg.ef_construction,
        alpha=cfg.alpha,
        neighbor_overflow=cfg.neighbor_overflow,
        hierarchy_enabled=cfg.hierarchy_enabled,
        batch_size=batch_size,
    )

    pqv = _merged_pq(
        cfg, lead, exact_vectors,
        int(np.asarray(graph.live).sum()) + n_new,
    )
    if pqv is not None:  # codes cover the padded capacity (zeros tail)
        pqv = pq_mod.PQVectors(pq=pqv.pq, codes=pad_rows(pqv.codes, capacity))
    build_pq = None
    if pqv is not None and cfg.mode == "on_disk":
        # PQ build scoring only for the memory-constrained tier (fp32 is
        # resident during in-memory merges and is scored exactly).
        # Decoded-bf16 formulation: same scores as ADC LUTs.
        build_pq = {"decoded": pqv.decode_bf16()}

    if n_new:
        new_ids = np.arange(lead_used, used)
        graph = builder.add_nodes(
            graph, all_vectors, new_ids, cfg.similarity, pq=build_pq
        )
    # deletes in the leading segment (doc -1) are already tombstoned in
    # `live`; fold them into the adjacency now
    graph = builder.cleanup(graph, all_vectors, cfg.similarity)

    lead_parents = (
        lead.docmap.ord_to_parent
        if lead.docmap.ord_to_parent is not None
        else np.full(lead.docmap.num_ordinals, -1, np.int64)
    )
    parents = (
        np.concatenate([lead_parents] + new_parent_blocks)
        if n_new else lead_parents
    )
    docmap = DocMap(
        np.concatenate(
            [lead.docmap.ord_to_doc]
            + new_doc_blocks
        ) if n_new else lead.docmap.ord_to_doc,
        parents if (parents >= 0).any() else None,
    )
    scalar = _merged_scalar(cfg, exact_vectors)
    return Segment(
        name=out_name, config=cfg, graph=graph, docmap=docmap,
        vectors=all_vectors, nvq=None, pqv=pqv,
        scalar_state=scalar[0] if scalar else None,
        scalar_codes=pad_rows(scalar[1], capacity) if scalar else None,
    )


def _full_rebuild_merge(
    cfg: DiskAnnConfig,
    segments: list[Segment],
    out_name: str,
    batch_size: int,
) -> Segment:
    """Rebuild from scratch over all live vectors (compacts ordinals)."""
    vec_blocks, doc_blocks, parent_blocks = [], [], []
    lead_idx = _elect_leading(segments)
    for s in segments:
        live = np.asarray(s.graph.live)
        docs = s.docmap.ord_to_doc
        keep = live[: docs.shape[0]] & (docs >= 0)
        ids = np.nonzero(keep)[0]
        if ids.size == 0:
            continue
        v = np.asarray(_materialize_vectors(s))
        vec_blocks.append(v[ids])
        doc_blocks.append(docs[ids])
        parent_blocks.append(
            s.docmap.ord_to_parent[ids]
            if s.docmap.ord_to_parent is not None
            else np.full(ids.size, -1, np.int64)
        )

    if not vec_blocks:
        return Segment(
            name=out_name, config=cfg,
            graph=VamanaGraph.empty(0, max(cfg.m, 1)),
            docmap=DocMap(np.empty(0, np.int64)),
            vectors=jnp.zeros((0, cfg.dim), jnp.float32),
        )

    all_vectors = jnp.asarray(np.concatenate(vec_blocks))
    parents = np.concatenate(parent_blocks)
    docmap = DocMap(np.concatenate(doc_blocks),
                    parents if (parents >= 0).any() else None)
    n = all_vectors.shape[0]

    pqv = _merged_pq(cfg, segments[lead_idx], all_vectors, n)
    build_pq = None
    if pqv is not None and cfg.mode == "on_disk":
        # PQ build scoring only for the memory-constrained tier (fp32 is
        # resident during in-memory merges and is scored exactly).
        # Decoded-bf16 formulation: same scores as ADC LUTs.
        build_pq = {"decoded": pqv.decode_bf16()}

    from opensearch_jvector_tpu.models.graph import bucket_capacity, pad_rows

    cap = bucket_capacity(n)
    if cfg.index_type == "flat":
        graph = VamanaGraph.flat(cap, n)  # concat-only merge (no graph)
    else:
        builder = GraphIndexBuilder(
            dim=cfg.dim,
            max_degree=cfg.m,
            beam_width=cfg.ef_construction,
            alpha=cfg.alpha,
            neighbor_overflow=cfg.neighbor_overflow,
            hierarchy_enabled=cfg.hierarchy_enabled,
            batch_size=batch_size,
        )
        if build_pq is not None:
            build_pq = {
                k: (pad_rows(v, cap) if k == "codes" else v)
                for k, v in build_pq.items()
            }
        graph = builder.build(all_vectors, cfg.similarity, pq=build_pq,
                              capacity=cap)
    cap = graph.capacity
    if pqv is not None:
        pqv = pq_mod.PQVectors(pq=pqv.pq, codes=pad_rows(pqv.codes, cap))

    nvq = None
    vectors = pad_rows(all_vectors, cap)
    if cfg.quantization_type == QUANT_NVQ and (
        n >= cfg.min_batch_size_for_quantization
    ):
        # NVQ merge recomputes quantization from scratch (mergeNVQ parity)
        nvq = nvq_mod.train_nvq(all_vectors, cfg.nvq_num_subvectors)
        nvq = nvq_mod.NVQVectors(
            bytes_=pad_rows(nvq.bytes_, cap),
            params=pad_rows(nvq.params, cap),
            global_mean=nvq.global_mean,
        )
        vectors = None
    scalar = _merged_scalar(cfg, all_vectors)
    return Segment(
        name=out_name, config=cfg, graph=graph, docmap=docmap,
        vectors=vectors, nvq=nvq, pqv=pqv,
        scalar_state=scalar[0] if scalar else None,
        scalar_codes=pad_rows(scalar[1], cap) if scalar else None,
    )
