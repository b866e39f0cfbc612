"""HTTP service: the REST surface of the engine (L6 parity).

Routes mirror the reference's user-facing API shape:
  GET  /_plugins/_knn/stats[/{stat}]      node stats
  GET/PUT /_cluster/settings              dynamic settings registry
       (typed + validated; change consumers fire, KNNSettings parity)
       (+ legacy /_opendistro/_knn/stats alias — RestKNNStatsHandler.java:
       56-64, JVectorKNNPlugin.java:128-129)
  PUT  /{index}                           create index (knn_vector mapping)
  PUT  /{index}/_mapping                  add knn_vector fields to a live
                                          index (identical re-sends no-op;
                                          conflicting updates 400)
  POST /{index}/_doc/{id}                 index one document
  POST /{index}/_bulk                     [{"_id": ..., field: [...]}, ...]
  POST /{index}/_flush                    flush buffered docs to a segment
  POST /{index}/_forcemerge               merge all segments
  POST /{index}/_search                   {"query": {"knn": {field: {...}}}
                                           | {"match_all": {}}, "size": N,
                                           "from": N, "docvalue_fields":
                                           [field|{"field": ...}],
                                           "ext": {"mmr": {...}}}
  DELETE /{index}/_doc/{id}               tombstone a document
  GET  /{index}/_doc/{id}                 derived-source doc retrieval
  GET  /{index}/_count                    live doc count

This is a thin control plane: all heavy work stays in the index layer.
Stdlib-only (no external web framework in the image).
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

from opensearch_jvector_tpu.api.config import SearchConfig, ValidationError
from opensearch_jvector_tpu.api.mapping import parse_knn_vector_mapping
from opensearch_jvector_tpu.api.stats import STATS
from opensearch_jvector_tpu.index.index import VectorIndex
from opensearch_jvector_tpu.query import knn as knn_mod
from opensearch_jvector_tpu.query import mmr as mmr_mod
from opensearch_jvector_tpu.query.builder import parse_knn_query

_PENDING = object()   # registry reservation while an index is constructed
_DELETING = object()  # registry tombstone while drop() removes storage


class MicroBatcher:
    """Dynamic micro-batching of concurrent single-vector knn searches.

    The reference serves each query on its own CPU thread; an
    accelerator serves queries as BATCHES — one [Q, d] dispatch costs
    barely more than one [1, d] dispatch. Concurrent REST requests whose
    query parameters match are therefore coalesced: the first arrival
    becomes the leader, waits `window_ms` for followers, stacks the
    vectors, runs ONE `execute_knn_query`, and hands each requester its
    row. Requests with filters / radial params / nested expansion are
    never batched (their execution shape is per-request).

    This is the serving analog of the msearch-style batched-vector
    surface: that batches within one request, this batches across
    concurrent requests.
    """

    def __init__(self, window_ms: float = 2.0, max_batch: int = 256):
        self.window_s = float(window_ms) / 1000.0
        self.max_batch = int(max_batch)
        self._lock = threading.Lock()
        self._groups: dict[tuple, list] = {}

    @staticmethod
    def batch_key(idx, query):
        """Grouping key, or None when the query must run alone."""
        if (query.filter_docs is not None or query.max_distance is not None
                or query.min_score is not None or query.expand_nested_docs):
            return None
        r = query.rescore
        return (
            id(idx), query.k, query.ef_search, query.overquery_factor,
            query.threshold, query.rerank_floor, query.use_pruning,
            None if r is None else float(r.oversample_factor),
        )

    def submit(self, idx, query, key):
        """Execute `query` against `idx`, possibly coalesced with
        concurrent submissions sharing `key`. Returns (QueryResult, row)."""
        import dataclasses as _dc
        import time as _time

        done = threading.Event()
        slot = [None, None]  # (result, row) | (exception in [0], None)
        with self._lock:
            group = self._groups.setdefault(key, [])
            group.append((np.asarray(query.vector, np.float32), done, slot))
            leader = len(group) == 1
        if not leader:
            done.wait()
            if isinstance(slot[0], BaseException):
                raise slot[0]
            return slot[0], slot[1]
        _time.sleep(self.window_s)
        with self._lock:
            batch = self._groups.pop(key)
        # max_batch is a sizing guideline for window tuning, not a hard
        # cap: everything collected in the window ships in one dispatch
        # (dropping entries would strand their waiters)
        try:
            vecs = np.stack([b[0] for b in batch])
            bq = _dc.replace(query, vector=vecs)
            res = knn_mod.execute_knn_query(idx, bq)
            for i, (_, ev, sl) in enumerate(batch):
                sl[0], sl[1] = res, i
                ev.set()
        except BaseException as e:
            for _, ev, sl in batch:
                sl[0], sl[1] = e, None
                ev.set()
            raise
        return slot[0], slot[1]


class IndexManager:
    """Registry of named indices.

    An index may map SEVERAL knn_vector fields, each with its own method
    parameters — the per-field format dispatch of the reference
    (KNN9120PerFieldKnnVectorsFormat.java:39-79: every field gets its own
    KnnVectorsFormat and its own segment files). Here every field owns an
    independent VectorIndex under `{root}/{index}/{field}`; documents may
    omit any subset of fields (missing-field semantics)."""

    def __init__(self, root: str | Path, mesh=None, batcher=None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self._indices: dict[str, dict[str, VectorIndex]] = {}
        # optional device mesh: sharded indexes must have one shard per
        # mesh device and then get the full-engine mesh path
        self.mesh = mesh
        # optional MicroBatcher: coalesces concurrent single-vector
        # searches into one device dispatch (None disables)
        self.batcher = batcher

    def _make_field_index(self, name: str, field: str, config,
                          n_shards: int):
        """One field's index: a VectorIndex, or with n_shards > 1 a
        ShardedVectorIndex placed on the service's mesh when one is
        attached (the mesh must have one device per shard)."""
        if n_shards == 1:
            return VectorIndex(self.root / name / field, config)
        from opensearch_jvector_tpu.parallel.distributed import (
            ShardedVectorIndex,
        )
        from opensearch_jvector_tpu.parallel.sharded import mesh_size

        if self.mesh is not None and mesh_size(self.mesh) != n_shards:
            raise ValidationError(
                f"number_of_shards ({n_shards}) must equal the service "
                f"mesh's device count ({mesh_size(self.mesh)})")
        return ShardedVectorIndex(self.root / name / field, config,
                                  n_shards=n_shards, mesh=self.mesh)

    def create(self, name: str, mappings: dict,
               settings: dict | None = None) -> dict:
        props = (mappings or {}).get("properties") or {}
        knn_fields = [
            (f, m) for f, m in props.items()
            if isinstance(m, dict) and m.get("type") == "knn_vector"
        ]
        if not knn_fields:
            raise ValidationError(
                "index mapping needs at least one knn_vector field"
            )
        # index.number_of_shards (OpenSearch core setting): >1 builds a
        # ShardedVectorIndex per field (scatter-gather search; attaches to
        # a device mesh via attach_mesh)
        sset = (settings or {}).get("index") or settings or {}
        try:
            n_shards = int(sset.get("number_of_shards", 1))
        except (TypeError, ValueError):
            raise ValidationError("number_of_shards must be an integer")
        if n_shards < 1:
            raise ValidationError("number_of_shards must be >= 1")
        parsed = {f: parse_knn_vector_mapping(m) for f, m in knn_fields}

        def make(f, config):
            return self._make_field_index(name, f, config, n_shards)

        # reserve the name under the lock, construct OUTSIDE it (shard/dir
        # setup must not stall every other request on the registry lock)
        with self._lock:
            if self._indices.get(name) is _DELETING:
                raise ValidationError(
                    f"index {name} is being deleted; retry shortly")
            if name in self._indices:
                raise ValidationError(f"index {name} already exists")
            self._indices[name] = _PENDING  # reservation (404 until ready)
        try:
            built = {f: make(f, config) for f, (config, _) in parsed.items()}
        except BaseException:
            with self._lock:
                self._indices.pop(name, None)  # release the reservation
            raise
        with self._lock:
            self._indices[name] = built
        first = knn_fields[0][0]
        return {"acknowledged": True, "index": name, "field": first,
                "fields": [f for f, _ in knn_fields],
                "shards": n_shards,
                "mode": parsed[first][1]["mode"]}

    def add_fields(self, name: str, mappings: dict) -> dict:
        """PUT /{index}/_mapping: add NEW knn_vector fields to a live
        index (the OpenSearch dynamic-mapping-update surface). Existing
        fields may be re-sent only with an IDENTICAL mapping (no-op);
        conflicting updates are rejected, as core rejects incompatible
        mapper changes. New fields inherit the index's shard count."""
        props = (mappings or {}).get("properties") or {}
        knn_fields = [
            (f, m) for f, m in props.items()
            if isinstance(m, dict) and m.get("type") == "knn_vector"
        ]
        if not knn_fields:
            raise ValidationError(
                "mapping update needs at least one knn_vector field"
            )
        current = self.get(name)  # raises KeyError -> 404 if absent
        parsed = {f: parse_knn_vector_mapping(m) for f, m in knn_fields}
        fresh = {}
        for f, (config, _) in parsed.items():
            if f in current:
                if current[f].config != config:
                    raise ValidationError(
                        f"mapper for [{f}] cannot be changed from its "
                        f"current mapping"
                    )
                continue  # identical re-send: no-op
            fresh[f] = config
        if fresh:
            any_idx = next(iter(current.values()))
            n_shards = getattr(any_idx, "n_shards", 1)

            built = {f: self._make_field_index(name, f, c, n_shards)
                     for f, c in fresh.items()}
            with self._lock:
                val = self._indices.get(name)
                if not isinstance(val, dict):
                    for idx in built.values():  # index dropped mid-update
                        idx.close()
                    raise KeyError(name)
                # replace with a NEW dict: readers iterate the old snapshot
                self._indices[name] = {**val, **built}
        return {"acknowledged": True,
                "added": sorted(fresh),
                "fields": sorted(set(current) | set(fresh))}

    def get(self, name: str) -> dict[str, VectorIndex]:
        """name -> {field: VectorIndex} (insertion-ordered)."""
        with self._lock:
            val = self._indices.get(name)
            if val is None or val is _PENDING or val is _DELETING:
                raise KeyError(name)
            return val

    def drop(self, name: str) -> None:
        """Delete an index: quiesce, unregister, then remove its storage.

        The name stays reserved (_DELETING) until rmtree finishes, so a
        concurrent PUT of the same name cannot create storage that the
        rmtree walk would silently delete. Each index is close()d first —
        an in-flight background merge/flush would otherwise recreate the
        directory (segment mkdir + commits.json) after removal and a later
        index of the same name would resurrect the stale state.
        """
        import shutil

        with self._lock:
            val = self._indices.get(name)
            if val is None or val is _PENDING or val is _DELETING:
                raise KeyError(name)
            self._indices[name] = _DELETING  # name reserved during removal
        try:
            for idx in val.values():
                idx.close()
            shutil.rmtree(self.root / name, ignore_errors=True)
        finally:
            with self._lock:
                if self._indices.get(name) is _DELETING:
                    del self._indices[name]


def _make_handler(mgr: IndexManager):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive: every response goes through _send (which
        # always sets Content-Length), so persistent connections are safe
        # — and under concurrent load they matter: HTTP/1.0 closes the
        # socket per request, forcing a reconnect AND a fresh
        # ThreadingHTTPServer thread per request (measured as a QPS
        # ceiling in the REST bench before this).
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # silence stderr noise
            pass

        def _send(self, code: int, body: dict):
            raw = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            if n == 0:
                return {}
            try:
                return json.loads(self.rfile.read(n))
            except (json.JSONDecodeError, UnicodeDecodeError, ValueError) as e:
                # UnicodeDecodeError: invalid UTF-8 bytes are a client
                # error too, not a 500
                raise ValidationError(f"malformed JSON body: {e}") from e

        def _error(self, code: int, msg: str):
            self._send(code, {"error": msg, "status": code})

        # -- routing -------------------------------------------------------

        def do_GET(self):
            try:
                if self.path == "/_cluster/settings":
                    from opensearch_jvector_tpu.api.settings import (
                        GLOBAL_SETTINGS,
                    )

                    return self._send(
                        200, {"persistent": GLOBAL_SETTINGS.snapshot()})
                m = re.fullmatch(
                    r"/(?:_plugins|_opendistro)/_knn/stats(?:/([\w,]+))?",
                    self.path,
                )
                if m:
                    snap = STATS.snapshot()
                    # sharded indexes carry their own per-shard registries
                    # (the transport-broadcast analog): fold them in so the
                    # node stats cover every index this service hosts
                    with mgr._lock:
                        indices = [dict(f) for f in mgr._indices.values()
                                   if isinstance(f, dict)]  # skip _PENDING
                    for fields in indices:
                        for idx in fields.values():
                            agg = getattr(idx, "stats", None)
                            if callable(agg):  # ShardedVectorIndex.stats()
                                for k, val in agg().items():
                                    snap[k] = snap.get(k, 0) + val
                    if m.group(1):
                        keys = m.group(1).split(",")
                        missing = [k for k in keys if k not in snap]
                        if missing:
                            return self._error(400, f"unknown stats {missing}")
                        snap = {k: snap[k] for k in keys}
                    return self._send(200, {"nodes": {"local": snap}})
                m = re.fullmatch(r"/([\w.-]+)", self.path)
                if m and not m.group(1).startswith("_"):
                    # index introspection: the response round-trips — its
                    # properties/settings replay into PUT /{index} and
                    # resolve to the same configs (the standard GET-then-
                    # reindex pattern)
                    from opensearch_jvector_tpu.api.mapping import (
                        SPACE_TO_SIMILARITY,
                    )

                    sim_to_space = {
                        v: k for k, v in SPACE_TO_SIMILARITY.items()
                        if k != "undefined"
                    }
                    fields = mgr.get(m.group(1))
                    props, n_shards = {}, 1
                    for f, idx in fields.items():
                        cfg = idx.config
                        n_shards = getattr(idx, "n_shards", 1)
                        params = {
                            "m": cfg.m,
                            "ef_construction": cfg.ef_construction,
                            "advanced.alpha": cfg.alpha,
                            "advanced.neighbor_overflow":
                                cfg.neighbor_overflow,
                            "advanced.hierarchy_enabled":
                                cfg.hierarchy_enabled,
                            "advanced.min_batch_size_for_quantization":
                                cfg.min_batch_size_for_quantization,
                            "advanced.quantization_type":
                                cfg.quantization_type,
                            "advanced.nvq.num_subvectors":
                                cfg.nvq_num_subvectors,
                            "advanced.leading_segment_merge_disabled":
                                cfg.leading_segment_merge_disabled,
                        }
                        if cfg.num_pq_subspaces is not None:
                            params["advanced.num_pq_subspaces"] = (
                                cfg.num_pq_subspaces)
                        if cfg.pq_anisotropic_threshold is not None:
                            params["advanced.pq_anisotropic_threshold"] = (
                                cfg.pq_anisotropic_threshold)
                        props[f] = {
                            "type": "knn_vector",
                            "dimension": cfg.dim,
                            "space_type": sim_to_space[cfg.similarity],
                            "mode": cfg.mode,
                            "method": {
                                "name": "disk_ann",
                                "engine": "jvector",
                                "parameters": params,
                            },
                        }
                    return self._send(200, {
                        m.group(1): {
                            "mappings": {"properties": props},
                            "settings": {"index": {
                                "number_of_shards": n_shards,
                            }},
                        },
                    })
                m = re.fullmatch(r"/([\w.-]+)/_doc/(\d+)", self.path)
                if m:
                    # derived-source document retrieval (DerivedSourceIT):
                    # _source is re-synthesized from the vector index — the
                    # vector is stored ONCE, in the segment, and re-injected
                    # at read time (codec/derivedsource/ behavior, default-on
                    # for knn indices — JVectorKNNPlugin.java:217-228)
                    fields = mgr.get(m.group(1))
                    doc = int(m.group(2))
                    src = {}
                    for f, idx in fields.items():
                        vecs, found = idx.get_vectors([doc])
                        if found[0]:
                            src[f] = [float(x) for x in vecs[0]]
                    if not src:
                        return self._send(404, {
                            "_index": m.group(1), "_id": m.group(2),
                            "found": False,
                        })
                    return self._send(200, {
                        "_index": m.group(1), "_id": m.group(2),
                        "found": True, "_source": src,
                    })
                m = re.fullmatch(r"/([\w.-]+)/_count", self.path)
                if m:
                    fields = mgr.get(m.group(1))
                    idxs = list(fields.values())
                    if len(idxs) == 1:
                        count = idxs[0].doc_count()
                    else:  # docs may span fields: count the doc-id UNION
                        ids = np.concatenate(
                            [i.live_doc_ids() for i in idxs]
                        )
                        count = int(np.unique(ids).size)
                    return self._send(200, {"count": count})
                self._error(404, f"no route for GET {self.path}")
            except KeyError as e:
                self._error(404, f"no such index {e}")
            except Exception as e:  # noqa: BLE001 — service boundary
                self._error(500, str(e))

        def do_PUT(self):
            try:
                if self.path == "/_cluster/settings":
                    # dynamic cluster settings (KNNSettings registry): the
                    # typed/validated registry applies each value and fires
                    # its change consumers (e.g. thread-qty pool rebuild)
                    from opensearch_jvector_tpu.api.settings import (
                        GLOBAL_SETTINGS,
                    )

                    body = self._body()
                    updates = {}
                    for tier in ("persistent", "transient"):
                        sub = body.get(tier) or {}
                        if not isinstance(sub, dict):
                            return self._error(
                                400, f"{tier} must be an object")
                        updates.update(sub)
                    if not updates:
                        return self._error(
                            400, "no persistent/transient settings given")
                    try:
                        for k, val in updates.items():
                            GLOBAL_SETTINGS.put(k, val)
                    except (KeyError, ValueError) as e:
                        return self._error(400, str(e))
                    return self._send(200, {
                        "acknowledged": True,
                        "persistent": {
                            k: GLOBAL_SETTINGS.get(k) for k in updates},
                    })
                if m := re.fullmatch(r"/([\w.-]+)/_mapping", self.path):
                    body = self._body()
                    # accept both {"properties": ...} (core shape) and a
                    # {"mappings": {"properties": ...}} wrapper
                    mappings = (body if "properties" in body
                                else body.get("mappings") or {})
                    return self._send(
                        200, mgr.add_fields(m.group(1), mappings))
                m = re.fullmatch(r"/([\w.-]+)", self.path)
                if not m:
                    return self._error(404, f"no route for PUT {self.path}")
                body = self._body()
                out = mgr.create(m.group(1), body.get("mappings") or {},
                                 body.get("settings"))
                self._send(200, out)
            except KeyError as e:
                self._error(404, f"no such index {e}")
            except ValidationError as e:
                self._error(400, str(e))
            except Exception as e:  # noqa: BLE001
                self._error(500, str(e))

        def do_DELETE(self):
            try:
                m = re.fullmatch(r"/([\w.-]+)/_doc/(\d+)", self.path)
                if m:
                    for idx in mgr.get(m.group(1)).values():
                        idx.delete(int(m.group(2)))
                    return self._send(200, {"result": "deleted"})
                m = re.fullmatch(r"/([\w.-]+)", self.path)
                if not m:
                    return self._error(404, f"no route for DELETE {self.path}")
                mgr.drop(m.group(1))  # delete index (storage removed)
                self._send(200, {"acknowledged": True})
            except KeyError as e:
                self._error(404, f"no such index {e}")
            except Exception as e:  # noqa: BLE001
                self._error(500, str(e))

        def do_POST(self):
            try:
                path = self.path
                if m := re.fullmatch(r"/([\w.-]+)/_doc/(\d+)", path):
                    fields = mgr.get(m.group(1))
                    body = self._body()
                    # a doc may carry any non-empty subset of the mapped
                    # fields (missing-field semantics: the doc simply has
                    # no vector in the omitted fields' indexes)
                    present = [f for f in fields if f in body]
                    if not present:
                        return self._error(
                            400, f"doc has none of the mapped fields "
                                 f"{list(fields)}"
                        )
                    parent = body.get("_parent")
                    for f in present:
                        fields[f].add(
                            int(m.group(2)), np.asarray(body[f], np.float32),
                            parent_id=None if parent is None else int(parent),
                        )
                    return self._send(201, {"result": "created"})
                if m := re.fullmatch(r"/([\w.-]+)/_bulk", path):
                    fields = mgr.get(m.group(1))
                    docs = self._body().get("docs") or []
                    for i, doc in enumerate(docs):
                        if not any(f in doc for f in fields):
                            # same contract as the single-doc route: a doc
                            # carrying NONE of the mapped fields is an
                            # error, not a silent success
                            return self._error(
                                400, f"doc {i} (_id={doc.get('_id')}) has "
                                     f"none of the mapped fields "
                                     f"{list(fields)}"
                            )
                    for doc in docs:
                        # `_parent` marks a nested child vector (the REST
                        # analog of indexing a nested knn_vector path)
                        parent = doc.get("_parent")
                        for f in fields:
                            if f in doc:
                                fields[f].add(
                                    int(doc["_id"]),
                                    np.asarray(doc[f], np.float32),
                                    parent_id=(None if parent is None
                                               else int(parent)),
                                )
                    return self._send(200, {"indexed": len(docs)})
                if m := re.fullmatch(r"/([\w.-]+)/_flush", path):
                    segs = {f: i.flush() for f, i in mgr.get(m.group(1)).items()}
                    first = next(iter(segs.values()))
                    return self._send(200, {"segment": first,
                                            "segments": segs})
                if m := re.fullmatch(r"/([\w.-]+)/_forcemerge", path):
                    segs = {f: i.force_merge()
                            for f, i in mgr.get(m.group(1)).items()}
                    first = next(iter(segs.values()))
                    return self._send(200, {"segment": first,
                                            "segments": segs})
                if m := re.fullmatch(r"/([\w.-]+)/_search", path):
                    return self._search(m.group(1))
                self._error(404, f"no route for POST {path}")
            except ValidationError as e:
                self._error(400, str(e))
            except KeyError as e:
                self._error(404, f"no such index {e}")
            except Exception as e:  # noqa: BLE001
                self._error(500, str(e))

        def _search(self, index_name: str):
            body = self._body()  # malformed body -> 400 even if the index
            fields = mgr.get(index_name)  # doesn't exist (client error wins)
            default_field = next(iter(fields))
            size = int(body.get("size", 10))
            frm = int(body.get("from", 0))
            if size < 0 or frm < 0:
                return self._error(400, "size and from must be >= 0")
            qbody = body.get("query") or {}

            # docvalue_fields parity (DocValueFieldsIT.java): hits carry the
            # stored vector(s) re-read from index storage — the single-copy
            # derived-source path (VectorIndex.get_vectors). Entries may be
            # strings or {"field": ..., "format": ...}; knn_vector doc
            # values have no custom format (custom format -> 400, matching
            # testDocValueFields_customFormat_throwsError). Unmapped field
            # names are silently omitted (docs simply lack the field).
            dv_names = []
            for entry in body.get("docvalue_fields") or []:
                if isinstance(entry, str):
                    fname, fmt = entry, None
                elif isinstance(entry, dict):
                    fname, fmt = entry.get("field"), entry.get("format")
                else:
                    return self._error(
                        400, "docvalue_fields entries must be field names "
                             "or {field, format} objects"
                    )
                if fmt is not None:
                    return self._error(
                        400, f"knn_vector doc values do not support a "
                             f"custom format: [{fname}]"
                    )
                if fname in fields:
                    dv_names.append(fname)

            def attach_docvalues(hit_lists):
                """One batched get_vectors per requested field across every
                hit of every response; hits missing the field get no entry
                (missing-field semantics)."""
                if not dv_names:
                    return
                all_ids = sorted({h["_id"] for hl in hit_lists for h in hl})
                if not all_ids:
                    return
                for f in dv_names:
                    vecs, found = fields[f].get_vectors(all_ids)
                    vmap = {
                        d: v for d, v, ok in zip(all_ids, vecs, found) if ok
                    }
                    for hl in hit_lists:
                        for h in hl:
                            v = vmap.get(h["_id"])
                            if v is not None:
                                h.setdefault("fields", {})[f] = [
                                    [float(x) for x in v]
                                ]

            if "match_all" in qbody:
                # match_all + docvalue_fields: enumerate live docs (doc-id
                # union across mapped fields, served from cached docmaps —
                # no segment upload), paginate with from/size
                unions = [i.live_doc_ids() for i in fields.values()]
                all_ids = (np.unique(np.concatenate(unions)) if unions
                           else np.empty(0, np.int64))
                hits = [{"_id": int(d), "_score": 1.0}
                        for d in all_ids[frm:frm + size]]
                attach_docvalues([hits])
                return self._send(200, {
                    "hits": {"total": {"value": int(all_ids.size)},
                             "hits": hits},
                })

            # painless-style script_score (knn_score engine parity):
            # {"script_score": {"script": {"source": "knn_score",
            #   "lang": "knn", "params": {field, query_value, space_type}}}}
            if "script_score" in qbody:
                script = (qbody["script_score"] or {}).get("script") or {}
                if script.get("source") != "knn_score" or (
                    script.get("lang", "knn") != "knn"
                ):
                    return self._error(
                        400, "only the knn_score script is allowlisted"
                    )
                p = script.get("params") or {}
                sfield = p.get("field", default_field)
                if sfield not in fields:
                    return self._error(400, f"unknown field {sfield}")
                res = knn_mod.execute_script_score(
                    fields[sfield], p.get("space_type", "l2"),
                    p["query_value"], k=frm + size,
                )
                hits = [
                    {"_id": int(d), "_score": float(s)}
                    for d, s in zip(res.doc_ids[0], res.scores[0]) if d >= 0
                ][frm:frm + size]
                attach_docvalues([hits])
                return self._send(200, {
                    "hits": {"total": {"value": len(hits)}, "hits": hits},
                })

            qroot = qbody.get("knn") or {}
            tgt = next(iter(qroot), None)
            if tgt not in fields:
                # ignore_unmapped parity: an unmapped target field returns
                # empty hits instead of an error when the flag is set
                if tgt is not None and bool(
                    (qroot[tgt] or {}).get("ignore_unmapped", False)
                ):
                    return self._send(200, {
                        "hits": {"total": {"value": 0}, "hits": []},
                    })
                return self._error(
                    400, f"knn query must target one of {list(fields)}"
                )
            idx = fields[tgt]
            query = parse_knn_query(qroot[tgt])

            row0 = 0  # result row for this request (micro-batching may
            # place it anywhere in a coalesced dispatch)
            ext = body.get("ext") or {}
            if "mmr" in ext:
                mmr_body = ext["mmr"] or {}
                params = mmr_mod.MMRParams(
                    diversity=float(mmr_body.get("diversity", 0.5)),
                    candidates=mmr_body.get("candidates"),
                )
                # vector_field_path (MMRSearchExtBuilder parity): diversity
                # vectors may come from another mapped knn_vector field
                vsrc = None
                vpath = mmr_body.get("vector_field_path")
                if vpath is not None and vpath != tgt:
                    if vpath not in fields:
                        return self._error(
                            400, f"mmr.vector_field_path must name a "
                                 f"mapped knn_vector field: {vpath}"
                        )
                    vsrc = fields[vpath]
                res = mmr_mod.mmr_search(
                    idx, query.vector, size, params,
                    SearchConfig(
                        k=max(query.k or size, size),
                        ef_search=query.ef_search,
                        overquery_factor=query.overquery_factor,
                    ),
                    vector_source=vsrc,
                )
            else:
                bkey = (MicroBatcher.batch_key(idx, query)
                        if (mgr.batcher is not None
                            and np.asarray(query.vector).ndim == 1)
                        else None)
                if bkey is not None:
                    res, row0 = mgr.batcher.submit(idx, query, bkey)
                else:
                    res = knn_mod.execute_knn_query(idx, query)

            def hits_for(row_ids, row_scores):
                hits = []
                for doc, score in zip(row_ids, row_scores):
                    if doc < 0:
                        continue
                    hits.append({"_id": int(doc), "_score": float(score)})
                    if len(hits) >= frm + size:
                        break
                return hits[frm:frm + size]

            profile = {
                "visited": res.visited,
                "expanded": res.expanded,
                "reranked": res.reranked,
                # rows in the device dispatch that served this request
                # (>1 => micro-batched with concurrent requests; the
                # counters above aggregate over the whole dispatch)
                "dispatch_rows": int(np.asarray(res.doc_ids).shape[0]),
            }
            if np.asarray(query.vector).ndim == 2:
                # batched query surface (msearch-style): Q query vectors ran
                # as ONE device dispatch; one response per vector (and ONE
                # batched doc-value read-back across all responses)
                hit_lists = [
                    hits_for(res.doc_ids[i], res.scores[i])
                    for i in range(res.doc_ids.shape[0])
                ]
                attach_docvalues(hit_lists)
                responses = [
                    {"hits": {"total": {"value": len(h)}, "hits": h}}
                    for h in hit_lists
                ]
                return self._send(200, {
                    "responses": responses, "profile": profile,
                })
            hits = hits_for(res.doc_ids[row0], res.scores[row0])
            attach_docvalues([hits])
            return self._send(200, {
                "hits": {"total": {"value": len(hits)}, "hits": hits},
                "profile": profile,
            })

    return Handler


class KnnService:
    """Embedded HTTP service wrapper (threaded; test- and prod-friendly)."""

    def __init__(self, root: str | Path, host: str = "127.0.0.1",
                 port: int = 0, mesh=None, batch_window_ms: float = 2.0):
        # batch_window_ms > 0 enables request coalescing (MicroBatcher);
        # 0 serves every request as its own device dispatch
        batcher = (MicroBatcher(window_ms=batch_window_ms)
                   if batch_window_ms and batch_window_ms > 0 else None)
        self.manager = IndexManager(root, mesh=mesh, batcher=batcher)
        self.server = ThreadingHTTPServer(
            (host, port), _make_handler(self.manager)
        )
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self.server.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.server.serve_forever, daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self.server.shutdown()
        if self._thread:
            self._thread.join(timeout=5)
