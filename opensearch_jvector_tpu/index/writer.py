"""Index writer: buffer -> quantize policy -> graph build -> segment flush.

Device counterpart of `JVectorWriter` flush (JVectorWriter.java:216-261):
  * buffers (docId, float vector) pairs per field — byte vectors rejected
    (reference rejects byte[] at JVectorWriter.java:178-184)
  * quantize-then-build policy (quantizeForFlush, :263-283): below
    `min_batch_size_for_quantization` (default 1024) build fp32; otherwise
    train PQ (and NVQ when configured) FIRST and build the graph with the
    PQ build-score provider (quantized index construction)
  * writes the segment with versioned, checksummed containers
"""

from __future__ import annotations

import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from opensearch_jvector_tpu.api.config import (
    SCALAR_BITS,
    SCALAR_QUANTS,
    QUANT_NONE,
    QUANT_NVQ,
    QUANT_PQ,
    DiskAnnConfig,
    ValidationError,
)
from opensearch_jvector_tpu.api.stats import STATS, Counter, StatsRegistry
from opensearch_jvector_tpu.index.docmap import DocMap
from opensearch_jvector_tpu.index.segment import Segment, write_segment
from opensearch_jvector_tpu.models import nvq as nvq_mod
from opensearch_jvector_tpu.models import pq as pq_mod
from opensearch_jvector_tpu.models.builder import GraphIndexBuilder
from opensearch_jvector_tpu.models.graph import bucket_capacity, pad_rows

# Stride at which a flush(device_rows=...) provider is consumed — BOTH the
# PQ-encode loop and the graph-build materialization request [lo, lo+BLOCK)
# windows, so a provider may serve each request from a single generated
# block of this size. Kept equal to pq.ENCODE_CHUNK * 16.
DEVICE_ROWS_BLOCK = 1 << 20


class IndexWriter:
    def __init__(
        self,
        root: str | Path,
        config: DiskAnnConfig,
        stats: StatsRegistry = STATS,
        build_batch_size: int | None = None,  # None -> builder auto-sizes by dim
    ):
        self.root = Path(root)
        self.config = config
        self.stats = stats
        self.build_batch_size = build_batch_size
        # on_disk PQ segments at/above this pow2 capacity build the graph
        # from the decoded-PQ bf16 cache INSTEAD of a device-resident fp32
        # corpus (the reference's pure PQ BuildScoreProvider semantics,
        # BuildScoreProvider.pqBuildScoreProvider): beam scoring reads the
        # cache natively, prune sites upcast their gathered blocks to f32.
        # fp32 residency (4 d bytes/vec) is what capped single-chip builds
        # at 2^22 (docs/design.md, build memory); the decoded cache is
        # 2 d bytes/vec and is resident for serving anyway.
        self.quantized_build_min_capacity = 1 << 22
        # The ingest buffer holds BLOCKS of (doc_ids, parent_ids, vectors)
        # arrays: single adds are 1-row blocks; `add_batch` appends whole
        # arrays without per-row Python overhead (the reference's _bulk
        # surface; a 10M-row ingest is one block, not 10M list appends).
        self._blocks: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._buffered = 0
        # guards the buffer blocks: add/delete_buffered may race a flush's
        # buffer snapshot from another thread (misaligned doc_ids/vectors
        # written to disk otherwise)
        self._buf_lock = __import__("threading").Lock()
        # set by delete_buffered: buffered positions no longer match the
        # ingest order a flush(device_rows=...) provider was built against,
        # so the provider must be dropped for the next flush (silently
        # misaligned PQ codes otherwise)
        self._buffer_positions_dirty = False
        # resume the counter past any existing segments: a reopened index
        # must never reuse a segment name (same-name flush silently
        # OVERWRITES the old segment directory)
        counter = -1
        for p in self.root.glob("seg_*"):
            parts = p.name.split("_")
            if len(parts) >= 2 and parts[1].isdigit():
                counter = max(counter, int(parts[1]))
        self._flush_counter = counter + 1

    def add_document(self, doc_id: int, vector, parent_id: int | None = None
                     ) -> None:
        """Buffer one document's vector (float32 only, dim-checked).

        `parent_id` marks a nested child vector (nested-field parity).
        """
        v = np.asarray(vector)
        if v.dtype.kind not in "f":
            raise TypeError(
                "only float vectors are supported by the disk_ann engine "
                f"(got dtype {v.dtype})"
            )
        if v.shape != (self.config.dim,):
            raise ValueError(
                f"vector shape {v.shape} != (dim={self.config.dim},)"
            )
        with self._buf_lock:
            self._blocks.append((
                np.asarray([int(doc_id)], np.int64),
                np.asarray(
                    [-1 if parent_id is None else int(parent_id)], np.int64
                ),
                v.astype(np.float32)[None, :],
            ))
            self._buffered += 1

    def add_batch(self, doc_ids, vectors, parent_ids=None) -> int:
        """Bulk-buffer a block of documents (one array append — the fast
        ingest path for big corpora; _bulk surface parity). Returns the
        number of docs buffered.

        Aliasing contract: a float32 `vectors` array is buffered WITHOUT
        copying (a 10M-row ingest must not duplicate the 5GB corpus), so
        the buffer snapshots at flush time, not add time — the caller must
        not mutate the array between add_batch and flush.
        """
        ids = np.asarray(doc_ids, np.int64).reshape(-1)
        v = np.asarray(vectors)
        if v.dtype.kind not in "f":
            raise TypeError(
                "only float vectors are supported by the disk_ann engine "
                f"(got dtype {v.dtype})"
            )
        if v.ndim != 2 or v.shape != (ids.shape[0], self.config.dim):
            raise ValueError(
                f"vectors shape {v.shape} != ({ids.shape[0]}, "
                f"{self.config.dim})"
            )
        parents = (
            np.full(ids.shape[0], -1, np.int64) if parent_ids is None
            else np.asarray(parent_ids, np.int64).reshape(-1)
        )
        if parents.shape != ids.shape:
            raise ValueError("parent_ids must align with doc_ids")
        with self._buf_lock:
            # copy=False: a 10M-row bulk ingest must not duplicate the 5GB
            # corpus when the caller already hands float32
            self._blocks.append(
                (ids, parents, v.astype(np.float32, copy=False))
            )
            self._buffered += ids.shape[0]
        return ids.shape[0]

    def num_buffered(self) -> int:
        return self._buffered

    def delete_buffered(self, doc_ids) -> int:
        """Drop buffered (un-flushed) docs matching `doc_ids` — the part of
        Lucene deleteDocuments that hits the in-memory buffer. Returns the
        number of buffered entries removed. Docs already snapshotted by an
        in-flight flush are NOT here anymore; VectorIndex.delete covers
        those via its in-flight pending set."""
        dead = np.atleast_1d(np.asarray(doc_ids, np.int64))
        removed = 0
        with self._buf_lock:
            new_blocks = []
            for ids, parents, vecs in self._blocks:
                keep = ~np.isin(ids, dead)
                n_drop = int((~keep).sum())
                if n_drop:
                    removed += n_drop
                    if keep.any():
                        new_blocks.append(
                            (ids[keep], parents[keep], vecs[keep])
                        )
                else:
                    new_blocks.append((ids, parents, vecs))
            if removed:
                self._blocks = new_blocks
                self._buffered -= removed
                # block compaction shifted ingest-order positions: any
                # device_rows provider built against the pre-delete order
                # would now encode misaligned rows
                self._buffer_positions_dirty = True
        return removed

    def _quantize_for_flush(self, vectors: jnp.ndarray, device_rows=None):
        """Train quantizers when n >= min batch.

        Returns (pqv, nvq, scalar, build_pq); `scalar` is a
        (QuantizationState, packed_codes) pair for 1/2/4-bit modes.
        build_pq is the dict handed to the builder as the PQ build-score
        provider (BuildScoreProvider.pqBuildScoreProvider parity).

        `device_rows(lo, hi) -> [hi-lo, d] jax.Array` is an optional
        device-resident source for the SAME rows (ingest-order positions):
        when given, PQ encoding reads blocks from it instead of uploading
        the host buffer — the ingest path for vectors that
        already live on device (e.g. straight out of an embedding model)
        or can be regenerated there. Training still samples the host rows
        (a 131k sample, not a corpus pass).

        Scope: the provider feeds PQ ENCODING only. Scalar (1/2/4-bit) and
        NVQ modes still train/encode from the host buffer — their encode
        passes are one cheap elementwise sweep, not the PQ path's blocked
        argmin, so the provider plumbing hasn't been extended to them.
        (The non-flat graph build separately materializes provider rows in
        _build_and_write, which covers every mode's build upload.)
        """
        cfg = self.config
        n = vectors.shape[0]
        if cfg.quantization_type == QUANT_NONE:
            return None, None, None, None
        if n < cfg.min_batch_size_for_quantization:
            return None, None, None, None
        t0 = time.monotonic()
        if cfg.quantization_type in SCALAR_QUANTS:
            from opensearch_jvector_tpu.models import scalar as scalar_mod

            bits = SCALAR_BITS[cfg.quantization_type]
            state = scalar_mod.train_scalar_quantizer(
                np.asarray(vectors), bits=bits
            )
            codes = scalar_mod.quantize_vectors(state, vectors)
            self.stats.increment(
                Counter.KNN_QUANTIZATION_TRAINING_TIME,
                int((time.monotonic() - t0) * 1000),
            )
            return None, None, (state, jnp.asarray(codes)), None
        pq = pq_mod.train_pq(
            vectors, cfg.similarity, num_subspaces=cfg.num_pq_subspaces,
            anisotropic_eta=pq_mod.eta_from_config(cfg, vectors),
        )
        if device_rows is not None:
            blk = DEVICE_ROWS_BLOCK  # 1M-row provider blocks
            assert blk == pq_mod.ENCODE_CHUNK * 16
            codes = jnp.concatenate([
                pq_mod.encode(
                    pq, device_rows(lo, min(lo + blk, n)), cfg.similarity
                )
                for lo in range(0, n, blk)
            ])
        else:
            codes = pq_mod.encode(pq, vectors, cfg.similarity)
        pqv = pq_mod.PQVectors(pq=pq, codes=codes)
        nvq = None
        if cfg.quantization_type == QUANT_NVQ:
            nvq = nvq_mod.train_nvq(vectors, cfg.nvq_num_subvectors)
        self.stats.increment(
            Counter.KNN_QUANTIZATION_TRAINING_TIME,
            int((time.monotonic() - t0) * 1000),
        )
        # Quantized construction (PQ build-score provider) only for
        # on_disk mode (memory-constrained tier, reference behavior): the
        # fp32 array is device-resident during an in_memory flush and is
        # scored exactly. on_disk builds score from the decoded-bf16 cache
        # (row gathers + einsum — the same in-graph ADC formulation the
        # query tier uses).
        build_pq = None
        if cfg.mode == "on_disk" and cfg.index_type != "flat":
            # flat segments build no graph — don't pay the decode here
            build_pq = {"decoded": pqv.decode_bf16()}
        return pqv, nvq, None, build_pq

    def flush(self, name: str | None = None, sort_map=None,
              device_rows=None) -> Path | None:
        """Build + persist a segment from the buffered docs; clears buffer.

        `sort_map` (old_doc -> new_doc) applies index sorting to the doc map
        at flush, as the reference does (JVectorWriter.java:233-236).

        `device_rows(lo, hi)` optionally provides the buffered rows as
        device-resident blocks (ingest-order positions), letting quantize/
        encode skip the host->device corpus upload — see
        `_quantize_for_flush`. The provider MUST return the same values as
        the buffered host rows (they remain the durable copy in the row
        store); it is ignored when the buffer was deduplicated (update
        semantics reorder positions) or when a buffered delete compacted
        blocks since the rows were added (both shift ingest-order
        positions, which would misalign the provider). It skips the upload
        for PQ encoding and the graph build; scalar/NVQ encoding still
        reads host rows (see `_quantize_for_flush`).
        """
        if not self._buffered:
            return None
        from opensearch_jvector_tpu.utils.profiling import phase

        with phase("flush", stats=self.stats):
            return self._flush_locked(name, sort_map, device_rows)

    def _flush_locked(self, name: str | None, sort_map,
                      device_rows=None) -> Path | None:
        # atomic buffer snapshot: adds/deletes racing the (long) build below
        # see a clean empty buffer instead of a half-consumed one
        with self._buf_lock:
            blocks = self._blocks
            count = self._buffered
            positions_dirty = self._buffer_positions_dirty
            self._blocks = []
            self._buffered = 0
            self._buffer_positions_dirty = False
        if not count:
            return None
        if positions_dirty and device_rows is not None:
            # a buffered delete compacted blocks since the rows were added:
            # provider positions no longer align with the snapshot — fall
            # back to the (correct) host rows
            device_rows = None
        try:
            return self._build_and_write(blocks, count, name, sort_map,
                                         device_rows)
        except BaseException:
            # a refused build (CircuitBreakerException) or any build/write
            # failure must NOT drop the buffered docs: restore the snapshot
            # (prepended, preserving ingest order) so the flush can be
            # retried after the condition clears
            with self._buf_lock:
                self._blocks = blocks + self._blocks
                self._buffered += count
                self._buffer_positions_dirty |= positions_dirty
            raise

    def _build_and_write(self, blocks, count: int,
                         name: str | None, sort_map,
                         device_rows=None) -> Path:
        # counter read+increment under the buffer lock: two racing flushes
        # must never pick the same segment name (in-place overwrite)
        with self._buf_lock:
            counter = self._flush_counter
            self._flush_counter += 1
        name = name or f"seg_{counter:06d}_{count}"

        # memory circuit breaker: refuse a build that would exhaust
        # device memory.
        # flat ingest keeps fp32 host-side and builds no adjacency — only
        # the PQ codes ever reach the device during the flush.
        from opensearch_jvector_tpu.utils.circuit_breaker import BREAKER

        is_flat = self.config.index_type == "flat"
        # quantized construction (decoded-PQ build source, no device fp32):
        # on_disk PQ graph segments at/above the capacity where fp32
        # residency OOMs the chip
        quantized_build = (
            not is_flat
            and self.config.mode == "on_disk"
            and self.config.quantization_type == "pq"
            and count >= self.config.min_batch_size_for_quantization
            and bucket_capacity(count) >= self.quantized_build_min_capacity
        )
        est = BREAKER.estimate_segment_bytes(
            count, self.config.dim,
            0 if is_flat else self.config.m,
            self.config.neighbor_overflow,
            self.config.num_pq_subspaces
            if self.config.quantization_type != QUANT_NONE else None,
            keep_fp32=not (
                quantized_build
                or (is_flat and self.config.mode == "on_disk")
            ),
        )
        if quantized_build:
            est += count * self.config.dim * 2  # decoded-bf16 build source
        BREAKER.check(est)

        flat = self.config.index_type == "flat"
        vectors = (
            blocks[0][2] if len(blocks) == 1
            else np.concatenate([b[2] for b in blocks])
        )
        doc_ids = np.concatenate([b[0] for b in blocks])
        parent_ids = np.concatenate([b[1] for b in blocks])
        if np.unique(doc_ids).size != doc_ids.size:
            # update semantics WITHIN the buffer (Lucene updateDocument:
            # indexing an _id again replaces the earlier copy): keep the
            # LAST occurrence of each doc id, preserving ingest order
            _, last_rev = np.unique(doc_ids[::-1], return_index=True)
            keep = np.sort(doc_ids.size - 1 - last_rev)
            doc_ids, parent_ids = doc_ids[keep], parent_ids[keep]
            vectors = vectors[keep]
            count = int(doc_ids.size)
            name = f"seg_{counter:06d}_{count}" if name.startswith(
                "seg_") else name
            device_rows = None  # positions shifted; provider no longer aligns
        if not flat and not quantized_build:
            # graph build needs device-resident rows; flat ingest keeps the
            # corpus HOST-side (train samples on host, encode streams
            # chunks, rows go straight to the native store). A device-rows
            # provider replaces the upload wholesale. Quantized builds keep
            # the corpus host-side too: PQ trains on a host sample, encode
            # streams (provider blocks or host chunks), and the graph
            # builds from the decoded cache — fp32 rows never reside.
            if device_rows is not None:
                n_rows = vectors.shape[0]
                blk = DEVICE_ROWS_BLOCK
                parts = [device_rows(lo, min(lo + blk, n_rows))
                         for lo in range(0, n_rows, blk)]
                vectors = parts[0] if len(parts) == 1 else jnp.concatenate(
                    parts)
                # drop the block references NOW: holding them through
                # quantize+build keeps a full second corpus copy in device
                # memory (4.3GB at 8M x 128d)
                del parts
                device_rows = None  # rows are device-resident now
            else:
                vectors = jnp.asarray(vectors)
        has_nested = bool((parent_ids >= 0).any())

        cfg = self.config
        pqv, nvq, scalar, build_pq = self._quantize_for_flush(
            vectors, device_rows
        )

        t0 = time.monotonic()
        # device arrays are padded to the graph's pow2 capacity bucket so
        # every segment size shares XLA program families (disk files store
        # only the used prefix — see write_segment)
        cap = bucket_capacity(vectors.shape[0])
        if cfg.index_type == "flat":
            # flat index_type (FlatVectorFieldMapper parity): no graph —
            # every query serves through the scan tier, and ingest is
            # quantize + store only (the big-N fast-ingest path)
            from opensearch_jvector_tpu.models.graph import VamanaGraph

            graph = VamanaGraph.flat(cap, vectors.shape[0])
        else:
            builder = GraphIndexBuilder(
                dim=cfg.dim,
                max_degree=cfg.m,
                beam_width=cfg.ef_construction,
                alpha=cfg.alpha,
                neighbor_overflow=cfg.neighbor_overflow,
                hierarchy_enabled=cfg.hierarchy_enabled,
                batch_size=self.build_batch_size,
            )
            if build_pq is not None:
                build_pq = {k: pad_rows(v, cap)
                            for k, v in build_pq.items()}
            if quantized_build:
                # pure quantized construction: the decoded-PQ cache is the
                # ONLY device-resident corpus — beam score source AND
                # prune/bootstrap/cleanup row source (prune sites upcast
                # their gathered blocks to f32)
                assert build_pq is not None and "decoded" in build_pq
                build_src = build_pq["decoded"]
            else:
                build_src = vectors
            graph = builder.build(build_src, cfg.similarity, pq=build_pq,
                                  capacity=cap)
        self.stats.increment(
            Counter.KNN_GRAPH_BUILD_TIME, int((time.monotonic() - t0) * 1000)
        )

        docmap = DocMap(doc_ids, parent_ids if has_nested else None)
        if sort_map is not None:
            smap = np.asarray(sort_map)
            if smap.ndim != 1 or not np.issubdtype(smap.dtype, np.integer):
                raise ValidationError(
                    "sort_map must be a 1-D integer array (old doc id -> "
                    f"new doc id); got shape {smap.shape} dtype {smap.dtype}"
                )
            hi = int(doc_ids.max(initial=-1))
            if hi >= smap.shape[0]:
                raise ValidationError(
                    f"sort_map (len {smap.shape[0]}) does not cover "
                    f"buffered doc id {hi}"
                )
            if np.unique(smap).size != smap.size:
                raise ValidationError(
                    "sort_map must be injective (no duplicate new doc ids)"
                )
            docmap = docmap.apply_sort(smap)

        cap = graph.capacity
        if pqv is not None and cfg.index_type != "flat":
            pqv = pq_mod.PQVectors(pq=pqv.pq, codes=pad_rows(pqv.codes, cap))
        if nvq is not None:
            nvq = nvq_mod.NVQVectors(
                bytes_=pad_rows(nvq.bytes_, cap),
                params=pad_rows(nvq.params, cap),
                global_mean=nvq.global_mean,
            )
        seg = Segment(
            name=name,
            config=cfg,
            graph=graph,
            docmap=docmap,
            # NVQ replaces inline fp32 storage (the reference's NVQ feature
            # replaces InlineVectors); PQ keeps fp32 inline for rerank.
            # Flat and quantized-build segments keep the HOST array
            # (write_segment slices the used prefix straight into the row
            # file; pad_rows would upload the full fp32 corpus).
            vectors=(
                None if nvq is not None
                else vectors if (cfg.index_type == "flat" or quantized_build)
                else pad_rows(vectors, cap)
            ),
            nvq=nvq,
            pqv=pqv,
            scalar_state=scalar[0] if scalar else None,
            scalar_codes=pad_rows(scalar[1], cap) if scalar else None,
        )
        path = write_segment(self.root, seg)
        self.stats.increment(Counter.KNN_FLUSH_COUNT)
        return path
