"""Segment model + on-disk layout.

A segment is the immutable unit of the index (the Lucene-segment analog).
On disk it is a directory of checksummed containers:

  meta.jvtpu     config + counts + quantization type byte
                 (VectorIndexFieldMetadata parity: field config, simFunc
                 ordinal, dim, quantizationType byte, ordinal->doc map
                 presence — JVectorWriter.java:512-563)
  graph.jvtpu    adjacency/degrees/live/entry. This doubles as the
                 *mutable-graph checkpoint*: unlike the reference — which
                 persists a separate neighbors-score-cache file so a merge
                 can reload+mutate the graph without recomputing neighbor
                 scores (JVectorWriter.java:339-363, 1174-1188) — neighbor
                 scores here are recomputed on the device instead, so
                 persisting adjacency alone suffices for incremental merge.
  vectors.jvtpu  fp32 rows, or NVQ (bytes/params/global_mean) when the
                 config uses nvq+pq (inline-feature parity: InlineVectors
                 vs NVQ features of the on-disk graph)
  pq.jvtpu       PQ codebooks + center + codes (PQ blob parity)
  docmap.jvtpu   ordinal->doc map

Quantization type bytes mirror the reference exactly:
NONE=0 / PQ=1 / NVQ_INLINE=2 (JVectorIndexQuantization.java:51-53).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from opensearch_jvector_tpu.api.config import (
    QUANT_NONE,
    QUANT_NVQ,
    QUANT_PQ,
    DiskAnnConfig,
)
from opensearch_jvector_tpu.index import store
from opensearch_jvector_tpu.index.docmap import DocMap
from opensearch_jvector_tpu.models.graph import VamanaGraph, bucket_capacity
from opensearch_jvector_tpu.models.nvq import NVQVectors
from opensearch_jvector_tpu.models.pq import ProductQuantization, PQVectors

# NONE/PQ/NVQ bytes mirror the reference (JVectorIndexQuantization.java:
# 51-53); 3-5 extend the scheme for native scalar quantization (the
# reference stores scalar state in separate .osknnqstate files instead)
QUANT_TYPE_BYTE = {QUANT_NONE: 0, QUANT_PQ: 1, QUANT_NVQ: 2,
                   "1bit": 3, "2bit": 4, "4bit": 5}
BYTE_TO_QUANT = {v: k for k, v in QUANT_TYPE_BYTE.items()}


@dataclasses.dataclass
class Segment:
    """In-memory (device-resident) segment.

    `row_store` (on_disk mode) replaces `vectors`: fp32 rows stay in the
    native host-tier store and only rerank candidates are paged on chip.
    """

    name: str
    config: DiskAnnConfig
    graph: VamanaGraph
    docmap: DocMap
    vectors: jnp.ndarray | None = None  # fp32 [capacity, d]
    nvq: NVQVectors | None = None
    pqv: PQVectors | None = None
    row_store: object | None = None  # utils.native_store.PagedVectorStore
    scalar_state: object | None = None  # models.scalar.QuantizationState
    scalar_codes: jnp.ndarray | None = None  # [capacity, B] uint8 packed
    # lazily-built doc->ordinal inverse (sorted docs + ordinal permutation);
    # makes vector read-back / MMR / rescore O(hits log N), not O(N) scans
    _doc_sort: tuple | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def ords_for_docs(self, doc_ids) -> np.ndarray:
        """Vectorized doc id -> graph ordinal (-1 where absent).

        Derived-source read-back index (DerivedSourceVectorTransformer
        intent, derivedsource/DerivedSourceVectorTransformer.java:31-61):
        built once per segment, then every lookup is a binary search.
        """
        if self._doc_sort is None:
            docs = self.docmap.ord_to_doc
            order = np.argsort(docs, kind="stable")
            object.__setattr__(self, "_doc_sort",
                               (docs[order], order.astype(np.int64)))
        sdocs, sords = self._doc_sort
        flat = np.asarray(doc_ids, np.int64).reshape(-1)
        pos = np.searchsorted(sdocs, flat)
        pos_c = np.clip(pos, 0, max(len(sdocs) - 1, 0))
        ok = (
            (len(sdocs) > 0)
            & (pos < len(sdocs))
            & (sdocs[pos_c] == flat)
            & (flat >= 0)
        )
        out = np.where(ok, sords[pos_c] if len(sdocs) else -1, -1)
        return out.reshape(np.asarray(doc_ids).shape)

    @property
    def quantization_type(self) -> str:
        if self.nvq is not None:
            return QUANT_NVQ
        if self.scalar_state is not None:
            return {1: "1bit", 2: "2bit", 4: "4bit"}[self.scalar_state.bits]
        if self.pqv is not None:
            return QUANT_PQ
        return QUANT_NONE

    def live_count(self) -> int:
        return int(np.asarray(self.graph.live).sum())

    def capacity(self) -> int:
        return self.graph.capacity

    def rerank_source(self):
        """(vectors, nvq) pair for the searcher's rerank phase."""
        if self.vectors is not None:
            return self.vectors, None
        assert self.nvq is not None
        return None, self.nvq


def write_segment(root: str | Path, seg: Segment) -> Path:
    root = Path(root)
    d = root / seg.name
    d.mkdir(parents=True, exist_ok=True)

    # Device arrays are padded to a pow2 capacity bucket (shared XLA program
    # families); files store only the used-ordinal prefix. read_segment
    # re-pads on load, so old exact-capacity files and new sliced files read
    # identically.
    used = seg.docmap.num_ordinals

    meta = {
        "config": seg.config.to_meta(),
        "quantization_type_byte": QUANT_TYPE_BYTE[seg.quantization_type],
        "capacity": seg.capacity(),
        "live_count": seg.live_count(),
    }
    store.write_container(d / "meta.jvtpu", meta, {})

    graph_arrays = {
        "adjacency": np.asarray(seg.graph.adjacency)[:used],
        "degrees": np.asarray(seg.graph.degrees)[:used],
        "live": np.asarray(seg.graph.live)[:used],
    }
    if seg.graph.upper_adjacency is not None:  # hierarchy layer
        graph_arrays["upper_adjacency"] = np.asarray(
            seg.graph.upper_adjacency
        )[:used]
    store.write_container(
        d / "graph.jvtpu", {"entry": int(seg.graph.entry)}, graph_arrays
    )
    on_disk = (
        seg.config.mode == "on_disk" and seg.pqv is not None
        and seg.nvq is None
    )
    if seg.row_store is not None or (on_disk and seg.vectors is not None):
        # on_disk mode: raw row file read back through the native store
        # (HBM keeps only graph + PQ codes; rerank pages rows on demand)
        if seg.vectors is not None:
            from opensearch_jvector_tpu.utils.native_store import (
                write_row_file,
            )

            write_row_file(d / "rows.f32", np.asarray(seg.vectors)[:used])
        store.write_container(d / "vectors.jvtpu", {"kind": "fp32_ondisk"}, {})
    elif seg.vectors is not None:
        store.write_container(
            d / "vectors.jvtpu",
            {"kind": "fp32"},
            {"vectors": np.asarray(seg.vectors, np.float32)[:used]},
        )
    if seg.nvq is not None:
        store.write_container(
            d / "vectors.jvtpu",
            {"kind": "nvq"},
            {
                "bytes": np.asarray(seg.nvq.bytes_)[:used],
                "params": np.asarray(seg.nvq.params)[:used],
                "global_mean": np.asarray(seg.nvq.global_mean),
            },
        )
    if seg.pqv is not None:
        arrays = {
            "codebooks": np.asarray(seg.pqv.pq.codebooks),
            "center": np.asarray(seg.pqv.pq.center),
            "codes": np.asarray(seg.pqv.codes)[:used],
        }
        if seg.pqv.pq.aniso_eta is not None:
            # anisotropically-trained codebooks: the assignment metric is
            # part of the state (merge re-encode must use the same loss)
            arrays["aniso_eta"] = np.asarray(
                seg.pqv.pq.aniso_eta, np.float32
            ).reshape(1)
        store.write_container(d / "pq.jvtpu", {}, arrays)
    if seg.scalar_state is not None:
        store.write_container(
            d / "scalar.jvtpu",
            {"bits": seg.scalar_state.bits},
            {
                "thresholds": np.asarray(seg.scalar_state.thresholds),
                "codes": np.asarray(seg.scalar_codes)[:used],
            },
        )
    docmap_arrays = {"ord_to_doc": seg.docmap.ord_to_doc}
    if seg.docmap.ord_to_parent is not None:
        docmap_arrays["ord_to_parent"] = seg.docmap.ord_to_parent
    store.write_container(d / "docmap.jvtpu", {}, docmap_arrays)
    return d


def read_segment(path: str | Path, verify: bool = True) -> Segment:
    """Load a segment directory onto the device (checksums verified)."""
    d = Path(path)
    meta, _ = store.read_container(d / "meta.jvtpu", verify=verify)
    config = DiskAnnConfig.from_meta(meta["config"])
    # memory circuit breaker guards loads too (the reference's breaker
    # also guards cache loads, KNNSettings.java:68-108): estimate the
    # device footprint from the meta before uploading any array
    from opensearch_jvector_tpu.api.config import QUANT_NONE as _QN
    from opensearch_jvector_tpu.utils.circuit_breaker import BREAKER

    BREAKER.check(
        BREAKER.estimate_segment_bytes(
            int(meta.get("capacity", 0)), config.dim, config.m,
            config.neighbor_overflow,
            config.num_pq_subspaces
            if config.quantization_type != _QN else None,
            keep_fp32=config.mode != "on_disk",
        )
    )
    gmeta, garr = store.read_container(d / "graph.jvtpu", verify=verify)
    # Files store the used-ordinal prefix; pad device arrays to the pow2
    # capacity bucket so all segment sizes share XLA program families.
    # (Pre-bucketing files stored full exact-capacity arrays — same path.)
    used = garr["live"].shape[0]
    cap = bucket_capacity(used) if used else 0

    def _pad2d(a, fill):
        if a.shape[0] >= cap:
            return a
        widths = [(0, cap - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, widths, constant_values=fill)

    graph = VamanaGraph(
        adjacency=jnp.asarray(_pad2d(garr["adjacency"], -1)),
        degrees=jnp.asarray(_pad2d(garr["degrees"], 0)),
        live=jnp.asarray(_pad2d(garr["live"], False)),
        entry=jnp.int32(gmeta["entry"]),
        upper_adjacency=(
            jnp.asarray(_pad2d(garr["upper_adjacency"], -1))
            if "upper_adjacency" in garr else None
        ),
    )
    dmeta, darr = store.read_container(d / "docmap.jvtpu", verify=verify)
    docmap = DocMap(darr["ord_to_doc"], darr.get("ord_to_parent"))

    vectors = None
    nvq = None
    row_store = None
    vpath = d / "vectors.jvtpu"
    if vpath.exists():
        vmeta, varr = store.read_container(vpath, verify=verify)
        if vmeta["kind"] == "fp32":
            vectors = jnp.asarray(_pad2d(varr["vectors"], 0))
        elif vmeta["kind"] == "fp32_ondisk":
            from opensearch_jvector_tpu.utils.native_store import (
                PagedVectorStore,
            )

            row_store = PagedVectorStore(d / "rows.f32", dim=config.dim)
        else:
            nvq = NVQVectors(
                bytes_=jnp.asarray(_pad2d(varr["bytes"], 0)),
                params=jnp.asarray(_pad2d(varr["params"], 0)),
                global_mean=jnp.asarray(varr["global_mean"]),
            )

    scalar_state = None
    scalar_codes = None
    spath = d / "scalar.jvtpu"
    if spath.exists():
        from opensearch_jvector_tpu.models.scalar import (
            SCALAR_STATE_CACHE,
            QuantizationState,
        )

        key = str(d.resolve())
        cached = SCALAR_STATE_CACHE.get(key)
        smeta, sarr = store.read_container(spath, verify=verify)
        if cached is not None:
            scalar_state = cached
        else:
            scalar_state = QuantizationState(
                bits=int(smeta["bits"]), thresholds=sarr["thresholds"]
            )
            SCALAR_STATE_CACHE.put(key, scalar_state)
        scalar_codes = jnp.asarray(_pad2d(sarr["codes"], 0))

    pqv = None
    ppath = d / "pq.jvtpu"
    if ppath.exists():
        _, parr = store.read_container(ppath, verify=verify)
        pqv = PQVectors(
            pq=ProductQuantization(
                codebooks=jnp.asarray(parr["codebooks"]),
                center=jnp.asarray(parr["center"]),
                aniso_eta=(jnp.float32(parr["aniso_eta"][0])
                           if "aniso_eta" in parr else None),
            ),
            codes=jnp.asarray(_pad2d(parr["codes"], 0)),
        )
    return Segment(
        name=d.name, config=config, graph=graph, docmap=docmap,
        vectors=vectors, nvq=nvq, pqv=pqv, row_store=row_store,
        scalar_state=scalar_state, scalar_codes=scalar_codes,
    )


def check_integrity(path: str | Path) -> bool:
    """Re-verify every container checksum (checkIntegrity parity) — the
    .jvtpu containers AND the raw on_disk row files (CRC sidecars)."""
    from opensearch_jvector_tpu.utils.native_store import verify_row_file

    d = Path(path)
    for f in sorted(d.glob("*.jvtpu")):
        store.read_container(f, verify=True)
    for f in sorted(d.glob("*.f32")):
        verify_row_file(f)
    return True
