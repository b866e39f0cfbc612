"""Distributed (multi-shard) index: scatter-gather across a device mesh.

The engine-level analog of OpenSearch's shard-level data parallelism
(SURVEY.md §2.4/§2.5): the corpus is split round-robin across S shards;
each shard is an independent VectorIndex whose segments live on one mesh
device; queries fan out to all shards and the per-shard top-k merge rides
one `all_gather` across the mesh (parallel/sharded.py) when the shards'
segments stack, else a host-side merge (the transport-layer analog).

Stats aggregate across shards like the reference's TransportNodesAction
broadcast (KNNStatsTransportAction.java:28,87-97).
"""

from __future__ import annotations

import json
import threading
from pathlib import Path

import numpy as np

from opensearch_jvector_tpu.api.config import DiskAnnConfig, SearchConfig
from opensearch_jvector_tpu.api.stats import Counter, StatsRegistry
from opensearch_jvector_tpu.index.index import VectorIndex
from opensearch_jvector_tpu.index.reader import QueryResult


class ShardedVectorIndex:
    """S independent shards + scatter-gather search.

    With a device mesh attached (`mesh=` or `attach_mesh`), searches run
    the FULL per-shard two-phase engine (PQ/ADC + rerank + filters +
    docmap) on the mesh in one program (parallel/sharded.py:
    sharded_engine_search) whenever each shard is a single in-memory
    segment; otherwise the host scatter-gather loop below runs, exactly
    like OpenSearch falls back to transport-level fan-out.
    """

    def __init__(self, root: str | Path, config: DiskAnnConfig | None = None,
                 n_shards: int = 2, mesh=None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        meta_path = self.root / "shards.json"
        if meta_path.exists():
            state = json.loads(meta_path.read_text())
            n_shards = state["n_shards"]
            config = None  # restored per shard
        else:
            if config is None:
                raise ValueError("new sharded index requires a config")
            meta_path.write_text(json.dumps({"n_shards": n_shards}))
        self.n_shards = n_shards
        # per-shard stats registries: the "node-level" stats of each shard
        self.shard_stats = [StatsRegistry() for _ in range(n_shards)]
        self.shards = [
            VectorIndex(self.root / f"shard_{s}", config,
                        stats=self.shard_stats[s])
            for s in range(n_shards)
        ]
        # coordinator-level registry (query-shape counters incremented by
        # the query layer when it drives this index directly)
        self.stats_registry = StatsRegistry()
        self.mesh = None
        if mesh is not None:
            self.attach_mesh(mesh)
        self._mesh_state = None  # cached stacked device arrays
        self._mesh_segments = None  # segment names the cache was built from
        # guards the (state, names) pair: two concurrent searches must not
        # interleave their restacks, or a later partial restack would diff
        # against mismatched names and slice-write the wrong shards
        self._mesh_lock = threading.Lock()
        # segment name -> synthetic donor-codebook PQVectors for fp32
        # segments below the quantization min batch (homogenize_pq);
        # segments are immutable so name-keyed entries never go stale
        self._synth_pq_cache: dict[str, object] = {}

    def attach_mesh(self, mesh) -> None:
        """Place shards on a device mesh (one shard per mesh device).

        Raises ValueError unless the mesh has exactly one device per
        shard: a mismatched mesh would otherwise never serve a search."""
        from opensearch_jvector_tpu.parallel.sharded import mesh_size

        if mesh_size(mesh) != self.n_shards:
            raise ValueError(
                f"mesh of {mesh_size(mesh)} devices cannot hold "
                f"{self.n_shards} shards (one shard per device)")
        self.mesh = mesh
        self._mesh_state = None

    def _route(self, doc_id: int) -> int:
        return int(doc_id) % self.n_shards  # deterministic routing

    @property
    def config(self) -> DiskAnnConfig:
        return self.shards[0].config

    def add(self, doc_id: int, vector, parent_id: int | None = None) -> None:
        # nested children co-locate with their parent (OpenSearch keeps a
        # doc block on one shard), so parent collapse stays shard-local
        route = parent_id if parent_id is not None else doc_id
        self.shards[self._route(route)].add(doc_id, vector,
                                            parent_id=parent_id)

    def close(self) -> None:
        """Quiesce every shard (see VectorIndex.close): required before
        storage removal so an in-flight flush/merge can't resurrect it."""
        for shard in self.shards:
            shard.close()

    def delete(self, doc_ids) -> None:
        # broadcast: a doc lives in exactly one shard, but parent-routed
        # children are not findable from their own id; absent-doc deletes
        # are no-ops (tombstones are per-segment presence-scoped)
        arr = np.atleast_1d(np.asarray(doc_ids, np.int64))
        for shard in self.shards:
            shard.delete(arr)

    def add_batch(self, doc_ids, vectors, parent_ids=None) -> int:
        """Bulk ingest: route a block of docs to shards in one pass."""
        doc_ids = np.asarray(doc_ids, np.int64).reshape(-1)
        vectors = np.asarray(vectors)
        if parent_ids is not None:
            parent_ids = np.asarray(parent_ids, np.int64).reshape(-1)
        route = doc_ids if parent_ids is None else np.where(
            parent_ids >= 0, parent_ids, doc_ids
        )
        total = 0
        for s in range(self.n_shards):
            sel = (route % self.n_shards) == s
            if sel.any():
                total += self.shards[s].add_batch(
                    doc_ids[sel], vectors[sel],
                    parent_ids=None if parent_ids is None
                    else parent_ids[sel],
                )
        return total

    def flush(self) -> list[str | None]:
        """Flush every shard; the flushes overlap on the search pool. With
        a mesh attached, shard s builds on mesh device s (JAX's default
        device is thread-local), so the builds run concurrently, one per
        device; otherwise every shard builds on the default device."""
        import jax

        from opensearch_jvector_tpu.parallel.pools import ComputePools

        devices = (list(self.mesh.devices.flat) if self.mesh is not None
                   else [None] * self.n_shards)

        def one(shard, device):
            if device is None:
                return shard.flush()
            with jax.default_device(device):
                return shard.flush()

        pool = ComputePools.instance()
        return list(pool.search_pool.map(one, self.shards, devices))

    def force_merge(self) -> list[str]:
        from opensearch_jvector_tpu.parallel.pools import ComputePools

        pool = ComputePools.instance()
        return list(pool.search_pool.map(
            lambda s: s.force_merge(), self.shards
        ))

    def doc_count(self) -> int:
        return sum(s.doc_count() for s in self.shards)

    def live_doc_ids(self) -> np.ndarray:
        out = [s.live_doc_ids() for s in self.shards]
        return np.unique(np.concatenate(out)) if out else np.empty(
            0, np.int64)

    # -- segment-level surface --------------------------------------------
    # The query layer's host paths (script_score, radial, exact fallback,
    # rescore, nested) iterate (segment_names, _reader, deleted_docs_for).
    # A sharded index exposes the same surface with shard-prefixed segment
    # names, so every query path that drives a VectorIndex drives a
    # ShardedVectorIndex unchanged (shards are whole indexes, SURVEY §2.5).

    SEG_SEP = "::"

    @property
    def segment_names(self) -> list[str]:
        return [
            f"{s}{self.SEG_SEP}{n}"
            for s, shard in enumerate(self.shards)
            for n in shard.segment_names
        ]

    def _split(self, combined: str):
        s, name = combined.split(self.SEG_SEP, 1)
        return self.shards[int(s)], name

    def _reader(self, combined: str):
        shard, name = self._split(combined)
        return shard._reader(name)

    def deleted_docs_for(self, combined: str):
        shard, name = self._split(combined)
        return shard.deleted_docs_for(name)

    def has_nested(self) -> bool:
        return any(s.has_nested() for s in self.shards)

    def parents_of(self, doc_ids: np.ndarray) -> np.ndarray:
        out = np.full_like(np.asarray(doc_ids, np.int64), -1)
        for s in self.shards:
            p = s.parents_of(doc_ids)
            out = np.where(out < 0, p, out)
        return out

    def get_vectors(self, doc_ids):
        """Bulk vector read-back across shards (derived source).

        Broadcast like delete(): nested children live on their PARENT's
        shard, so id-routing would miss them (rescore/MMR would silently
        drop those hits). Shards fill only the ids they actually hold."""
        ids = np.asarray(doc_ids, np.int64).reshape(-1)
        vecs = np.zeros((ids.size, self.config.dim), np.float32)
        found = np.zeros(ids.size, bool)
        for shard in self.shards:
            missing = ~found
            if not missing.any():
                break
            v, f = shard.get_vectors(ids[missing])
            idx = np.flatnonzero(missing)[f]
            vecs[idx] = v[f]
            found[idx] = True
        return vecs, found

    # -- mesh fast path -------------------------------------------------------

    # Cap on segments-per-shard for the mesh path: the [D, G, n] state pads
    # every shard to the largest segment count and capacity, so a shard with
    # many small un-merged flushes would inflate every other shard's upload.
    MESH_MAX_SEGMENTS = 4

    def _mesh_ready_segments(self):
        """`(per-shard segment lists, None)` for the mesh path, or
        `(None, reject-reason Counter)` naming why the host loop runs.

        Snapshotted UNDER each shard's lock (a concurrent flush/merge on
        another thread must not interleave with the segment-list read).
        Shards may hold multiple in-memory segments (steady-state ingest);
        buffered-but-unflushed docs still force the host path (they are not
        searchable as device arrays yet). A shard over the segment cap also
        schedules a background compaction (VectorIndex.compact_to) so the
        index RETURNS to the mesh path instead of drifting off it for good.
        """
        shard_lists = []
        reject = None
        for shard in self.shards:
            with shard._lock:
                names = list(shard._segments)
            if not names:
                reject = reject or Counter.KNN_MESH_REJECT_EMPTY_SHARD
                continue
            if len(names) > self.MESH_MAX_SEGMENTS:
                # keep scanning so EVERY over-cap shard gets its compaction
                # scheduled on this pass, not one per rejected search
                shard.compact_to(self.MESH_MAX_SEGMENTS)
                reject = reject or Counter.KNN_MESH_REJECT_SEGMENT_COUNT
                continue
            if shard.writer.num_buffered():
                reject = reject or Counter.KNN_MESH_REJECT_BUFFERED_DOCS
                continue
            # readers open lazily from immutable on-disk segments; a merge
            # racing this keeps the input segment files on disk, so the
            # snapshot stays readable even if the commit set moves on
            shard_lists.append([shard._reader(n).seg for n in names])
        if reject is not None:
            return None, reject
        return shard_lists, None

    def _search_on_mesh(self, queries: np.ndarray, sc: SearchConfig,
                        accept_docs) -> QueryResult | None:
        """Full-engine mesh search; None when preconditions don't hold."""
        from opensearch_jvector_tpu.index.reader import ordinal_accept_mask
        from opensearch_jvector_tpu.models.searcher import SearchParams
        from opensearch_jvector_tpu.parallel import sharded

        if self.mesh is None:
            return None
        shard_lists, reject = self._mesh_ready_segments()
        if shard_lists is None:
            self.stats_registry.increment(reject)
            return None
        # min-batch steady state: small fresh fp32 flushes next to PQ
        # segments get synthetic donor-codebook codes so the mesh keeps
        # serving (rerank stays exact fp32); cache keyed by segment name
        shard_lists = sharded.homogenize_pq(
            shard_lists, self.config.similarity, cache=self._synth_pq_cache,
        )
        names = [[s.name for s in lst] for lst in shard_lists]
        live_keys = {(i, n) for i, lst in enumerate(names) for n in lst}
        for stale in set(self._synth_pq_cache) - live_keys:
            del self._synth_pq_cache[stale]  # merged-away segments
        with self._mesh_lock:  # (state, names) must stay a matched pair
            if self._mesh_state is None or self._mesh_segments != names:
                import time as _t

                t0 = _t.monotonic()
                try:
                    # incremental when the stacked shapes allow it: only
                    # shards whose segment set changed are rebuilt +
                    # slice-written on device; unchanged shards are never
                    # re-uploaded
                    self._mesh_state, rebuilt = sharded.restack_engine_state(
                        self._mesh_state, self._mesh_segments, shard_lists,
                        names, mesh=self.mesh,
                    )
                except ValueError:  # mixed-quantization / flat-disk shards
                    self.stats_registry.increment(
                        Counter.KNN_MESH_REJECT_STACK_SHAPE)
                    return None
                self._mesh_segments = names
                # churn visibility: segment-set changes re-stack mesh state
                partial = rebuilt < self.n_shards
                for reg in self.shard_stats:
                    reg.increment(Counter.KNN_MESH_RESTACK_COUNT)
                    if partial:
                        reg.increment(
                            Counter.KNN_MESH_RESTACK_PARTIAL_COUNT)
                    reg.increment(Counter.KNN_MESH_RESTACK_TIME,
                                  int((_t.monotonic() - t0) * 1000))
            state = self._mesh_state

        # per-(shard, segment) ordinal accept masks (filter ∧ ¬tombstones)
        accept = None
        if accept_docs is not None or any(
            shard.has_deletes for shard in self.shards
        ):
            shard_rows = []
            for lst, shard in zip(shard_lists, self.shards):
                rows = []
                for seg in lst:
                    m = ordinal_accept_mask(
                        seg, accept_docs, shard.deleted_docs_for(seg.name)
                    )
                    if m is None:
                        used = seg.docmap.num_ordinals
                        m = np.asarray(seg.graph.live).copy()
                        m[:used] &= seg.docmap.ord_to_doc >= 0
                        m[used:] = False  # capacity-bucket padding
                    pad = state.n_local - m.shape[0]
                    rows.append(np.pad(m, (0, pad)) if pad else m)
                while len(rows) < state.n_segments:  # empty pad slots
                    rows.append(np.zeros((state.n_local,), bool))
                shard_rows.append(np.stack(rows))
            import jax.numpy as jnp

            accept = jnp.asarray(np.stack(shard_rows))

        from opensearch_jvector_tpu.models.graph import bucket_capacity

        qn = queries.shape[0]
        bucket = bucket_capacity(qn, minimum=8)
        padded = queries
        if bucket != qn:
            padded = np.concatenate(
                [queries, np.broadcast_to(queries[:1],
                                          (bucket - qn, queries.shape[1]))]
            )
        params = SearchParams(
            k=sc.k, ef_search=sc.resolved_ef(),
            overquery_factor=sc.overquery_factor,
            threshold=sc.threshold, rerank_floor=sc.rerank_floor,
        )
        import time as _time

        import jax as _jax
        import jax.numpy as jnp

        if state.approx_only:
            # on_disk shards: mesh beam over HBM codes, then host row
            # paging + one batched device rerank (BASELINE config 5 shape)
            return self._mesh_approx_search(
                state, shard_lists, padded, qn, params, accept, accept_docs,
            )

        t0 = _time.monotonic()
        docs, scores, counters = sharded.sharded_engine_search(
            self.mesh, state, jnp.asarray(padded, jnp.float32), params,
            self.config.similarity, accept=accept,
        )
        _jax.block_until_ready(docs)
        elapsed_ms = int((_time.monotonic() - t0) * 1000)

        counters = np.asarray(counters)  # [S, 3] visited/expanded/reranked
        for s in range(self.n_shards):
            reg = self.shard_stats[s]
            reg.increment(Counter.KNN_QUERY_COUNT, qn)
            if accept_docs is not None:
                reg.increment(Counter.KNN_QUERY_WITH_FILTER_COUNT, qn)
            reg.increment(Counter.KNN_QUERY_VISITED_NODES, int(counters[s, 0]))
            reg.increment(Counter.KNN_QUERY_EXPANDED_NODES, int(counters[s, 1]))
            reg.increment(
                Counter.KNN_QUERY_EXPANDED_BASE_LAYER_NODES,
                int(counters[s, 1]),
            )
            reg.increment(Counter.KNN_QUERY_RERANKED_COUNT,
                          int(counters[s, 2]))
            reg.increment(Counter.KNN_GRAPH_SEARCH_TIME, elapsed_ms)
        return QueryResult(
            doc_ids=np.asarray(docs)[:qn].astype(np.int64),
            scores=np.asarray(scores)[:qn],
            visited=int(counters[:, 0].sum()),
            expanded=int(counters[:, 1].sum()),
            reranked=int(counters[:, 2].sum()),
        )

    def _mesh_approx_search(self, state, shard_lists, padded, qn,
                            params, accept, accept_docs) -> QueryResult:
        """on_disk mesh search: approximate phase on the mesh (PQ beam over
        HBM-resident codes), fp32 rows paged from each segment's host
        store, ONE batched device rerank. The two-phase split of the
        reference (JVectorReader.java:353-366) crossing the mesh boundary."""
        import time as _time

        import jax as _jax
        import jax.numpy as jnp

        from opensearch_jvector_tpu.parallel import sharded

        t0 = _time.monotonic()
        docs, locs, _, counters = sharded.sharded_engine_search_approx(
            self.mesh, state, jnp.asarray(padded, jnp.float32), params,
            self.config.similarity, accept=accept,
        )
        docs_np = np.asarray(docs)[:qn]
        locs_np = np.asarray(locs)[:qn]
        g_seg, n_loc = state.n_segments, state.n_local
        dim = self.config.dim
        r = docs_np.shape[1]

        # page candidate rows grouped by (shard, segment): one gather per
        # source store, scattered into the [Q, r, d] rerank operand
        cand = np.zeros((qn, r, dim), np.float32)
        valid = locs_np >= 0
        shard_reranked = np.zeros(self.n_shards, np.int64)
        if valid.any():
            flat = locs_np[valid]
            seg_ids = flat // n_loc  # shard * G + g
            ords = flat % n_loc
            uniq = np.unique(seg_ids)
            for sid in uniq:  # kick off threaded readahead for every store
                d_idx, gi = divmod(int(sid), g_seg)
                store = shard_lists[d_idx][gi].row_store
                prefetch = getattr(store, "prefetch", None)
                if store is not None and prefetch is not None:
                    prefetch(ords[seg_ids == sid])
            rows_out = np.zeros((flat.shape[0], dim), np.float32)
            for sid in uniq:
                d_idx, gi = divmod(int(sid), g_seg)
                m = seg_ids == sid
                seg = shard_lists[d_idx][gi]
                if seg.row_store is not None:
                    rows_out[m] = seg.row_store.gather(ords[m])
                else:  # small below-min-batch flush: fp32 stayed resident
                    rows_out[m] = np.asarray(seg.vectors)[ords[m]]
                shard_reranked[d_idx] += int(m.sum())
            cand[valid] = rows_out

        bucket = padded.shape[0]
        docs_in, cand_in = docs_np, cand
        if bucket != qn:  # rerank at the same query bucket (pad rows inert)
            docs_in = np.full((bucket, r), -1, docs_np.dtype)
            docs_in[:qn] = docs_np
            cand_in = np.zeros((bucket, r, dim), np.float32)
            cand_in[:qn] = cand
        rerank = sharded._make_paged_rerank_fn(
            params.k, params.threshold, self.config.similarity
        )
        top_d, top_s, _ = rerank(
            jnp.asarray(padded, jnp.float32), jnp.asarray(cand_in),
            jnp.asarray(docs_in),
        )
        _jax.block_until_ready(top_d)
        elapsed_ms = int((_time.monotonic() - t0) * 1000)

        counters = np.asarray(counters)  # [S, 3] visited/expanded/0
        for s in range(self.n_shards):
            reg = self.shard_stats[s]
            reg.increment(Counter.KNN_QUERY_COUNT, qn)
            if accept_docs is not None:
                reg.increment(Counter.KNN_QUERY_WITH_FILTER_COUNT, qn)
            reg.increment(Counter.KNN_QUERY_VISITED_NODES,
                          int(counters[s, 0]))
            reg.increment(Counter.KNN_QUERY_EXPANDED_NODES,
                          int(counters[s, 1]))
            reg.increment(
                Counter.KNN_QUERY_EXPANDED_BASE_LAYER_NODES,
                int(counters[s, 1]),
            )
            reg.increment(Counter.KNN_QUERY_RERANKED_COUNT,
                          int(shard_reranked[s]))
            reg.increment(Counter.KNN_GRAPH_SEARCH_TIME, elapsed_ms)
        return QueryResult(
            doc_ids=np.asarray(top_d)[:qn].astype(np.int64),
            scores=np.asarray(top_s)[:qn],
            visited=int(counters[:, 0].sum()),
            expanded=int(counters[:, 1].sum()),
            reranked=int(shard_reranked.sum()),
        )

    def search(self, queries, sc: SearchConfig,
               accept_docs=None) -> QueryResult:
        """Scatter to every shard, merge top-k.

        Mesh path: one compiled program fans the batch out to every
        shard's device, runs the full two-phase search per shard, and
        merges doc-id results across the mesh. Host path (fallback): each
        shard's search is itself one device program; the merge over
        S * k results is negligible host work.
        """
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        qn = queries.shape[0]
        mesh_res = self._search_on_mesh(queries, sc, accept_docs)
        if mesh_res is not None:
            return mesh_res
        all_ids = np.full((qn, 0), -1, np.int64)
        all_scores = np.zeros((qn, 0), np.float32)
        visited = expanded = reranked = 0
        # host fallback fans shards out on the dedicated search pool (the
        # per-shard device programs serialize on the device stream, but
        # host-side prep/fetch overlaps — wall-clock ~flat in shard count
        # instead of a strictly sequential loop). A separate pool from the
        # per-segment fan-out inside VectorIndex.search (flush pool): a
        # shared pool would deadlock when outer tasks wait on inner ones.
        from opensearch_jvector_tpu.parallel.pools import ComputePools

        pool = ComputePools.instance()
        results = list(pool.search_pool.map(
            lambda shard: shard.search(queries, sc, accept_docs=accept_docs),
            self.shards,
        ))
        for res in results:
            all_ids = np.concatenate([all_ids, res.doc_ids], axis=1)
            all_scores = np.concatenate([all_scores, res.scores], axis=1)
            visited += res.visited
            expanded += res.expanded
            reranked += res.reranked
        order = np.argsort(-all_scores, axis=1, kind="stable")[:, : sc.k]
        return QueryResult(
            doc_ids=np.take_along_axis(all_ids, order, axis=1),
            scores=np.take_along_axis(all_scores, order, axis=1),
            visited=visited, expanded=expanded, reranked=reranked,
        )

    def stats(self) -> dict:
        """Cluster-level stats = sum over shard registries (broadcast analog)."""
        return StatsRegistry.aggregate(
            self.shard_stats + [self.stats_registry]
        )
