"""HTTP service tests: create/ingest/flush/search/stats/merge over REST.

Models the reference's REST integration tests (JVectorEngineIT,
RecallTestsIT run over REST test clusters)."""

import json
import http.client

import numpy as np
import pytest

from opensearch_jvector_tpu.service.http import KnnService

DIM = 16


@pytest.fixture(scope="module")
def service(tmp_path_factory):
    svc = KnnService(tmp_path_factory.mktemp("svc"))
    svc.start()
    yield svc
    svc.stop()


def _req(svc, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", svc.port, timeout=300)
    conn.request(method, path, json.dumps(body) if body is not None else None,
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    data = json.loads(r.read())
    conn.close()
    return r.status, data


def test_full_rest_lifecycle(service):
    rng = np.random.default_rng(0)
    v = rng.standard_normal((400, DIM)).astype(np.float32)

    status, out = _req(service, "PUT", "/myidx", {
        "mappings": {"properties": {"vec": {
            "type": "knn_vector", "dimension": DIM, "space_type": "l2",
            "method": {"name": "disk_ann", "engine": "jvector",
                       "parameters": {"m": 8, "ef_construction": 32}},
        }}},
    })
    assert status == 200 and out["acknowledged"]

    # duplicate create rejected
    status, out = _req(service, "PUT", "/myidx", {
        "mappings": {"properties": {"vec": {"type": "knn_vector",
                                            "dimension": DIM}}}})
    assert status == 400

    # bulk ingest + flush
    docs = [{"_id": i, "vec": v[i].tolist()} for i in range(400)]
    status, out = _req(service, "POST", "/myidx/_bulk", {"docs": docs})
    assert status == 200 and out["indexed"] == 400
    status, out = _req(service, "POST", "/myidx/_flush")
    assert status == 200 and out["segment"]

    # search
    status, out = _req(service, "POST", "/myidx/_search", {
        "size": 5,
        "query": {"knn": {"vec": {"vector": v[7].tolist(), "k": 5}}},
    })
    assert status == 200
    hits = out["hits"]["hits"]
    assert hits[0]["_id"] == 7
    assert out["profile"]["visited"] > 0

    # delete + search: doc gone
    status, _ = _req(service, "DELETE", "/myidx/_doc/7")
    assert status == 200
    status, out = _req(service, "POST", "/myidx/_search", {
        "size": 5,
        "query": {"knn": {"vec": {"vector": v[7].tolist(), "k": 5}}},
    })
    assert all(h["_id"] != 7 for h in out["hits"]["hits"])

    # force merge, count
    status, out = _req(service, "POST", "/myidx/_forcemerge")
    assert status == 200
    status, out = _req(service, "GET", "/myidx/_count")
    assert status == 200 and out["count"] == 399

    # MMR search ext
    status, out = _req(service, "POST", "/myidx/_search", {
        "size": 5,
        "query": {"knn": {"vec": {"vector": v[3].tolist(), "k": 15}}},
        "ext": {"mmr": {"diversity": 0.6}},
    })
    assert status == 200 and len(out["hits"]["hits"]) == 5

    # stats (new + legacy route)
    for prefix in ("/_plugins", "/_opendistro"):
        status, out = _req(service, "GET", prefix + "/_knn/stats")
        assert status == 200
        assert out["nodes"]["local"]["knn_query_count"] > 0
    status, out = _req(service, "GET", "/_plugins/_knn/stats/knn_query_count")
    assert status == 200 and list(out["nodes"]["local"]) == ["knn_query_count"]
    status, out = _req(service, "GET", "/_plugins/_knn/stats/bogus_stat")
    assert status == 400


def test_rest_batched_search_one_dispatch(service, monkeypatch):
    """A [Q, d] query vector runs as ONE engine dispatch (the batch
    amortization surface) and returns one response per query."""
    import opensearch_jvector_tpu.index.reader as reader_mod

    rng = np.random.default_rng(3)
    v = rng.standard_normal((120, DIM)).astype(np.float32)
    _req(service, "PUT", "/batchidx", {
        "mappings": {"properties": {"vec": {
            "type": "knn_vector", "dimension": DIM,
        }}}})
    docs = [{"_id": i, "vec": v[i].tolist()} for i in range(120)]
    _req(service, "POST", "/batchidx/_bulk", {"docs": docs})
    _req(service, "POST", "/batchidx/_flush")

    calls = []
    orig = reader_mod.SegmentReader.search

    def counting(self, queries, sc, **kw):
        calls.append(np.atleast_2d(np.asarray(queries)).shape[0])
        return orig(self, queries, sc, **kw)

    monkeypatch.setattr(reader_mod.SegmentReader, "search", counting)
    q = 6
    status, out = _req(service, "POST", "/batchidx/_search", {
        "size": 3,
        "query": {"knn": {"vec": {
            "vector": v[:q].tolist(), "k": 3,  # [Q, d] batched
        }}},
    })
    assert status == 200
    assert len(out["responses"]) == q
    for i, resp in enumerate(out["responses"]):
        assert resp["hits"]["hits"][0]["_id"] == i  # self-hit per query
    # one segment -> ONE engine dispatch carrying all Q queries
    assert calls == [q], calls

    # batched MMR rides the same single dispatch
    calls.clear()
    status, out = _req(service, "POST", "/batchidx/_search", {
        "size": 3,
        "query": {"knn": {"vec": {"vector": v[:4].tolist(), "k": 12}}},
        "ext": {"mmr": {"diversity": 0.4}},
    })
    assert status == 200 and len(out["responses"]) == 4
    assert all(len(r["hits"]["hits"]) == 3 for r in out["responses"])
    assert calls == [4], calls


def test_rest_error_paths(service):
    status, _ = _req(service, "POST", "/nope/_search", {
        "query": {"knn": {"vec": {"vector": [0.0] * DIM, "k": 3}}}})
    assert status == 404
    status, _ = _req(service, "PUT", "/badidx", {
        "mappings": {"properties": {"vec": {"type": "knn_vector"}}}})
    assert status == 400  # missing dimension
    status, _ = _req(service, "PUT", "/badidx2", {
        "mappings": {"properties": {"vec": {
            "type": "knn_vector", "dimension": DIM, "space_type": "hamming",
        }}}})
    assert status == 400  # script-only space on the engine


def test_ignore_unmapped_field(service):
    """Unmapped target field: 400 without the flag, empty hits with it
    (KNNQueryBuilder.ignoreUnmapped parity)."""
    _req(service, "PUT", "/ium", {
        "mappings": {"properties": {"vec": {
            "type": "knn_vector", "dimension": DIM,
        }}}})
    status, _ = _req(service, "POST", "/ium/_search", {
        "query": {"knn": {"other_field": {"vector": [0.0] * DIM, "k": 3}}}})
    assert status == 400
    status, data = _req(service, "POST", "/ium/_search", {
        "query": {"knn": {"other_field": {
            "vector": [0.0] * DIM, "k": 3, "ignore_unmapped": True,
        }}}})
    assert status == 200
    assert data["hits"]["total"]["value"] == 0


def test_rest_radial_rescore_filter(service):
    """Radial (max_distance / min_score), rescore, and doc-id filters over
    the REST surface (KNNQueryBuilder DSL parity at the service layer)."""
    rng = np.random.default_rng(5)
    v = rng.standard_normal((200, DIM)).astype(np.float32)
    _req(service, "PUT", "/rrf", {
        "mappings": {"properties": {"vec": {
            "type": "knn_vector", "dimension": DIM,
            "method": {"name": "disk_ann",
                       "parameters": {"m": 8, "ef_construction": 32}},
        }}}})
    docs = [{"_id": i, "vec": v[i].tolist()} for i in range(200)]
    _req(service, "POST", "/rrf/_bulk", {"docs": docs})
    _req(service, "POST", "/rrf/_flush")

    # radial: every returned doc satisfies the distance bound
    status, out = _req(service, "POST", "/rrf/_search", {
        "query": {"knn": {"vec": {"vector": v[3].tolist(),
                                  "max_distance": 4.0}}}})
    assert status == 200
    hits = out["hits"]["hits"]
    assert any(h["_id"] == 3 for h in hits)
    for h in hits:
        d = float(np.linalg.norm(v[int(h["_id"])] - v[3]))
        assert d <= 4.0 + 1e-4

    # min_score radial form parses and returns the identical doc first
    status, out = _req(service, "POST", "/rrf/_search", {
        "query": {"knn": {"vec": {"vector": v[3].tolist(),
                                  "min_score": 0.99}}}})
    assert status == 200 and out["hits"]["hits"][0]["_id"] == 3

    # doc-id filter restricts results; rescore keeps exact ordering
    status, out = _req(service, "POST", "/rrf/_search", {
        "size": 5,
        "query": {"knn": {"vec": {
            "vector": v[10].tolist(), "k": 5,
            "filter": list(range(100)),
            "rescore": {"oversample_factor": 3.0},
        }}}})
    assert status == 200
    ids = [h["_id"] for h in out["hits"]["hits"]]
    assert ids and all(i < 100 for i in ids)
    assert ids[0] == 10

    # radial + k together is a 400 (mutual exclusivity)
    status, _ = _req(service, "POST", "/rrf/_search", {
        "query": {"knn": {"vec": {"vector": v[0].tolist(), "k": 3,
                                  "max_distance": 1.0}}}})
    assert status == 400


def test_multi_field_index(service):
    """Per-field format dispatch parity (KNN9120PerFieldKnnVectorsFormat):
    one index maps TWO knn_vector fields with different method params;
    docs may omit fields; searches route per field; _count is the doc-id
    union; deletes hit every field."""
    rng = np.random.default_rng(7)
    a = rng.standard_normal((120, DIM)).astype(np.float32)
    b = rng.standard_normal((120, 2 * DIM)).astype(np.float32)

    status, out = _req(service, "PUT", "/multi", {
        "mappings": {"properties": {
            "vec_a": {"type": "knn_vector", "dimension": DIM,
                      "space_type": "l2",
                      "method": {"name": "disk_ann", "engine": "jvector",
                                 "parameters": {"m": 8,
                                                "ef_construction": 32}}},
            "vec_b": {"type": "knn_vector", "dimension": 2 * DIM,
                      "space_type": "innerproduct",
                      "method": {"name": "disk_ann", "engine": "jvector",
                                 "parameters": {"m": 16,
                                                "ef_construction": 48}}},
        }},
    })
    assert status == 200 and out["fields"] == ["vec_a", "vec_b"]

    # docs 0-99 carry both fields; 100-119 only vec_a (missing field cell)
    docs = []
    for i in range(120):
        d = {"_id": i, "vec_a": a[i].tolist()}
        if i < 100:
            d["vec_b"] = b[i].tolist()
        docs.append(d)
    status, out = _req(service, "POST", "/multi/_bulk", {"docs": docs})
    assert status == 200 and out["indexed"] == 120
    status, out = _req(service, "POST", "/multi/_flush")
    assert status == 200 and len(out["segments"]) == 2

    # count = union of doc ids across fields
    status, out = _req(service, "GET", "/multi/_count")
    assert status == 200 and out["count"] == 120

    # per-field searches route to the right sub-index
    status, out = _req(service, "POST", "/multi/_search", {
        "size": 5, "query": {"knn": {"vec_a": {
            "vector": a[7].tolist(), "k": 5}}}})
    assert status == 200 and out["hits"]["hits"][0]["_id"] == 7
    status, out = _req(service, "POST", "/multi/_search", {
        "size": 5, "query": {"knn": {"vec_b": {
            "vector": b[9].tolist(), "k": 5}}}})
    assert status == 200
    bhits = [h["_id"] for h in out["hits"]["hits"]]
    assert all(i < 100 for i in bhits)  # docs without vec_b can't match

    # a doc with NONE of the mapped fields is a 400
    status, _ = _req(service, "POST", "/multi/_doc/999", {"other": [1.0]})
    assert status == 400

    # delete removes the doc from every field's index
    status, _ = _req(service, "DELETE", "/multi/_doc/7")
    assert status == 200
    status, out = _req(service, "POST", "/multi/_search", {
        "size": 5, "query": {"knn": {"vec_a": {
            "vector": a[7].tolist(), "k": 5}}}})
    assert all(h["_id"] != 7 for h in out["hits"]["hits"])
    status, out = _req(service, "POST", "/multi/_search", {
        "size": 5, "query": {"knn": {"vec_b": {
            "vector": b[7].tolist(), "k": 5}}}})
    assert all(h["_id"] != 7 for h in out["hits"]["hits"])
    status, out = _req(service, "GET", "/multi/_count")
    assert status == 200 and out["count"] == 119

    # script_score routes by params.field
    status, out = _req(service, "POST", "/multi/_search", {
        "size": 3, "query": {"script_score": {"script": {
            "source": "knn_score", "lang": "knn",
            "params": {"field": "vec_b", "space_type": "l2",
                       "query_value": b[5].tolist()}}}}})
    assert status == 200 and out["hits"]["hits"][0]["_id"] == 5


def test_sharded_index_over_rest(service):
    """index.number_of_shards > 1 (OpenSearch core setting): the REST
    layer builds a ShardedVectorIndex per field; search scatter-gathers,
    script_score drives the shard-prefixed segment surface, deletes route
    to the owning shard."""
    rng = np.random.default_rng(11)
    v = rng.standard_normal((300, DIM)).astype(np.float32)
    status, out = _req(service, "PUT", "/shardy", {
        "settings": {"index": {"number_of_shards": 3}},
        "mappings": {"properties": {"vec": {
            "type": "knn_vector", "dimension": DIM, "space_type": "l2",
            "method": {"name": "disk_ann", "engine": "jvector",
                       "parameters": {"m": 8, "ef_construction": 32}},
        }}},
    })
    assert status == 200 and out["shards"] == 3

    docs = [{"_id": i, "vec": v[i].tolist()} for i in range(300)]
    status, out = _req(service, "POST", "/shardy/_bulk", {"docs": docs})
    assert status == 200 and out["indexed"] == 300
    status, out = _req(service, "POST", "/shardy/_flush")
    assert status == 200
    status, out = _req(service, "GET", "/shardy/_count")
    assert status == 200 and out["count"] == 300

    status, out = _req(service, "POST", "/shardy/_search", {
        "size": 5, "query": {"knn": {"vec": {
            "vector": v[17].tolist(), "k": 5}}}})
    assert status == 200 and out["hits"]["hits"][0]["_id"] == 17

    # script_score (exact) over the sharded segment surface
    status, out = _req(service, "POST", "/shardy/_search", {
        "size": 3, "query": {"script_score": {"script": {
            "source": "knn_score", "lang": "knn",
            "params": {"field": "vec", "space_type": "cosinesimil",
                       "query_value": v[42].tolist()}}}}})
    assert status == 200 and out["hits"]["hits"][0]["_id"] == 42

    # rescore (oversample + exact rerank) through the sharded index
    status, out = _req(service, "POST", "/shardy/_search", {
        "size": 5, "query": {"knn": {"vec": {
            "vector": v[23].tolist(), "k": 5,
            "rescore": {"oversample_factor": 2.0}}}}})
    assert status == 200 and out["hits"]["hits"][0]["_id"] == 23

    # node stats fold in the sharded index's per-shard registries
    status, out = _req(service, "GET", "/_plugins/_knn/stats")
    assert status == 200
    snap = out["nodes"]["local"]
    assert snap.get("knn_query_count", 0) >= 3  # shardy queries counted

    status, _ = _req(service, "DELETE", "/shardy/_doc/17")
    status, out = _req(service, "POST", "/shardy/_search", {
        "size": 5, "query": {"knn": {"vec": {
            "vector": v[17].tolist(), "k": 5}}}})
    assert all(h["_id"] != 17 for h in out["hits"]["hits"])
    status, out = _req(service, "GET", "/shardy/_count")
    assert status == 200 and out["count"] == 299


def test_service_mesh_attached(tmp_path):
    """KnnService(mesh=...) places shard-count-matching indexes on the
    device mesh: the REST search runs the full-engine mesh program."""
    import jax

    from opensearch_jvector_tpu.parallel import sharded

    mesh = sharded.make_mesh(jax.devices()[:2])
    svc = KnnService(tmp_path, mesh=mesh)
    svc.start()
    try:
        rng = np.random.default_rng(13)
        v = rng.standard_normal((200, DIM)).astype(np.float32)
        status, out = _req(svc, "PUT", "/meshed", {
            "settings": {"index": {"number_of_shards": 2}},
            "mappings": {"properties": {"vec": {
                "type": "knn_vector", "dimension": DIM,
                "space_type": "l2",
                "method": {"name": "disk_ann", "engine": "jvector",
                           "parameters": {"m": 8, "ef_construction": 32}},
            }}},
        })
        assert status == 200 and out["shards"] == 2
        docs = [{"_id": i, "vec": v[i].tolist()} for i in range(200)]
        _req(svc, "POST", "/meshed/_bulk", {"docs": docs})
        _req(svc, "POST", "/meshed/_flush")
        status, out = _req(svc, "POST", "/meshed/_search", {
            "size": 5, "query": {"knn": {"vec": {
                "vector": v[3].tolist(), "k": 5}}}})
        assert status == 200 and out["hits"]["hits"][0]["_id"] == 3
        idx = svc.manager.get("meshed")["vec"]
        assert idx.mesh is mesh
        assert idx._mesh_state is not None  # mesh program really served
    finally:
        svc.stop()


def test_mmr_vector_field_path(service):
    """ext.mmr.vector_field_path: diversity vectors come from a DIFFERENT
    mapped knn_vector field than the one searched (MMRSearchExtBuilder
    parity)."""
    rng = np.random.default_rng(17)
    a = rng.standard_normal((100, DIM)).astype(np.float32)
    b = rng.standard_normal((100, DIM)).astype(np.float32)
    _req(service, "PUT", "/mmrpath", {
        "mappings": {"properties": {
            "va": {"type": "knn_vector", "dimension": DIM,
                   "space_type": "l2"},
            "vb": {"type": "knn_vector", "dimension": DIM,
                   "space_type": "l2"},
        }}})
    docs = [{"_id": i, "va": a[i].tolist(), "vb": b[i].tolist()}
            for i in range(100)]
    _req(service, "POST", "/mmrpath/_bulk", {"docs": docs})
    _req(service, "POST", "/mmrpath/_flush")

    status, out = _req(service, "POST", "/mmrpath/_search", {
        "size": 5,
        "query": {"knn": {"va": {"vector": a[3].tolist(), "k": 5}}},
        "ext": {"mmr": {"diversity": 0.5, "vector_field_path": "vb"}}})
    assert status == 200
    hits = out["hits"]["hits"]
    assert hits and hits[0]["_id"] == 3

    # unknown path is a 400
    status, _ = _req(service, "POST", "/mmrpath/_search", {
        "size": 5,
        "query": {"knn": {"va": {"vector": a[3].tolist(), "k": 5}}},
        "ext": {"mmr": {"vector_field_path": "nope"}}})
    assert status == 400


def test_malformed_json_is_400(service):
    conn = http.client.HTTPConnection("127.0.0.1", service.port, timeout=60)
    conn.request("POST", "/myidx/_search", "{not json",
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    body = json.loads(r.read())
    conn.close()
    assert r.status == 400 and "malformed" in body["error"]


def test_index_introspection_and_delete(tmp_path):
    svc = KnnService(tmp_path)
    svc.start()
    try:
        rng = np.random.default_rng(19)
        v = rng.standard_normal((50, DIM)).astype(np.float32)
        _req(svc, "PUT", "/dropme", {
            "mappings": {"properties": {"vec": {
                "type": "knn_vector", "dimension": DIM,
                "space_type": "l2"}}}})
        docs = [{"_id": i, "vec": v[i].tolist()} for i in range(50)]
        _req(svc, "POST", "/dropme/_bulk", {"docs": docs})
        _req(svc, "POST", "/dropme/_flush")

        # GET /{index}: mapped fields + resolved config
        status, out = _req(svc, "GET", "/dropme")
        assert status == 200
        props = out["dropme"]["mappings"]["properties"]
        assert props["vec"]["dimension"] == DIM
        assert props["vec"]["type"] == "knn_vector"

        # DELETE /{index}: unregistered and storage removed
        status, out = _req(svc, "DELETE", "/dropme")
        assert status == 200 and out["acknowledged"]
        status, _ = _req(svc, "GET", "/dropme/_count")
        assert status == 404
        status, _ = _req(svc, "DELETE", "/dropme")
        assert status == 404
        # name is reusable after deletion
        status, out = _req(svc, "PUT", "/dropme", {
            "mappings": {"properties": {"vec": {
                "type": "knn_vector", "dimension": DIM,
                "space_type": "l2"}}}})
        assert status == 200
    finally:
        svc.stop()


def test_invalid_utf8_body_is_400(service):
    """Invalid UTF-8 bytes are a client error (400), not a 500."""
    conn = http.client.HTTPConnection("127.0.0.1", service.port, timeout=60)
    conn.request("POST", "/nosuch/_search", b"\xff\xfe\xfa",
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    body = json.loads(r.read())
    conn.close()
    assert r.status == 400 and "malformed" in body["error"]


def test_get_index_round_trips_into_put(tmp_path):
    """GET /{index} output replays into PUT (the introspect-then-reindex
    pattern): the recreated index resolves to the SAME config."""
    svc = KnnService(tmp_path)
    svc.start()
    try:
        _req(svc, "PUT", "/orig", {
            "mappings": {"properties": {"vec": {
                "type": "knn_vector", "dimension": DIM,
                "space_type": "innerproduct",
                "method": {"name": "disk_ann", "parameters": {
                    "m": 12, "ef_construction": 37,
                    "advanced.quantization_type": "pq",
                    "advanced.num_pq_subspaces": 4,
                    "advanced.min_batch_size_for_quantization": 99,
                }}}}},
            "settings": {"index": {"number_of_shards": 2}},
        })
        status, out = _req(svc, "GET", "/orig")
        assert status == 200
        status, _ = _req(svc, "PUT", "/copy", {
            "mappings": out["orig"]["mappings"],
            "settings": out["orig"]["settings"],
        })
        assert status == 200
        a = svc.manager.get("orig")["vec"]
        b = svc.manager.get("copy")["vec"]
        assert a.config == b.config
        assert getattr(a, "n_shards", 1) == getattr(b, "n_shards", 1) == 2
    finally:
        svc.stop()


def test_delete_recreate_does_not_resurrect_old_state(tmp_path):
    """DELETE quiesces in-flight background merges before removing storage;
    a PUT of the same name with a DIFFERENT mapping starts truly fresh
    (no stale commits.json / segments resurrected by a racing merge)."""
    svc = KnnService(tmp_path)
    svc.start()
    try:
        rng = np.random.default_rng(29)
        _req(svc, "PUT", "/phoenix", {
            "mappings": {"properties": {"vec": {
                "type": "knn_vector", "dimension": DIM,
                "space_type": "l2"}}}})
        # several small flushes under the DEFAULT tiered policy so a
        # background merge is likely in flight at DELETE time
        for chunk in range(4):
            docs = [{"_id": chunk * 30 + i,
                     "vec": rng.standard_normal(DIM).astype(
                         np.float32).tolist()}
                    for i in range(30)]
            _req(svc, "POST", "/phoenix/_bulk", {"docs": docs})
            _req(svc, "POST", "/phoenix/_flush")
        status, _ = _req(svc, "DELETE", "/phoenix")
        assert status == 200
        # recreate with a different dimension: must NOT inherit old config
        status, _ = _req(svc, "PUT", "/phoenix", {
            "mappings": {"properties": {"vec": {
                "type": "knn_vector", "dimension": DIM * 2,
                "space_type": "l2"}}}})
        assert status == 200
        assert svc.manager.get("phoenix")["vec"].config.dim == DIM * 2
        status, out = _req(svc, "GET", "/phoenix/_count")
        assert status == 200 and out["count"] == 0
        docs = [{"_id": i, "vec": rng.standard_normal(
            DIM * 2).astype(np.float32).tolist()} for i in range(10)]
        status, _ = _req(svc, "POST", "/phoenix/_bulk", {"docs": docs})
        assert status == 200
        _req(svc, "POST", "/phoenix/_flush")
        status, out = _req(svc, "GET", "/phoenix/_count")
        assert status == 200 and out["count"] == 10
    finally:
        svc.stop()


def test_service_mesh_on_disk_sharded(tmp_path):
    """REST end-to-end for the BASELINE config-5 shape: an on_disk sharded
    index attached to the mesh serves searches through the approx-beam +
    paged-rerank path (mode plumb-through from the mapping)."""
    import jax

    from opensearch_jvector_tpu.parallel import sharded

    mesh = sharded.make_mesh(jax.devices()[:2])
    svc = KnnService(tmp_path, mesh=mesh)
    svc.start()
    try:
        rng = np.random.default_rng(37)
        v = rng.standard_normal((300, DIM)).astype(np.float32)
        status, out = _req(svc, "PUT", "/diskmesh", {
            "settings": {"index": {"number_of_shards": 2}},
            "mappings": {"properties": {"vec": {
                "type": "knn_vector", "dimension": DIM,
                "space_type": "l2", "mode": "on_disk",
                "method": {"name": "disk_ann", "parameters": {
                    "m": 8, "ef_construction": 32,
                    "advanced.quantization_type": "pq",
                    "advanced.num_pq_subspaces": 4,
                    "advanced.min_batch_size_for_quantization": 64,
                }}}}},
        })
        assert status == 200 and out["shards"] == 2
        docs = [{"_id": i, "vec": v[i].tolist()} for i in range(300)]
        _req(svc, "POST", "/diskmesh/_bulk", {"docs": docs})
        _req(svc, "POST", "/diskmesh/_flush")
        status, out = _req(svc, "POST", "/diskmesh/_search", {
            "size": 5, "query": {"knn": {"vec": {
                "vector": v[7].tolist(), "k": 5,
                "method_parameters": {"ef_search": 64}}}}})
        assert status == 200 and out["hits"]["hits"][0]["_id"] == 7
        idx = svc.manager.get("diskmesh")["vec"]
        assert idx._mesh_state is not None and idx._mesh_state.approx_only
        for shard in idx.shards:
            seg = shard._reader(shard._segments[0]).seg
            assert seg.row_store is not None
    finally:
        svc.stop()


def test_mapping_update_adds_field(service):
    """PUT /{index}/_mapping: dynamic mapping updates add knn_vector
    fields to a live index; identical re-sends no-op; conflicting
    updates are rejected (core mapper-conflict semantics)."""
    rng = np.random.default_rng(55)
    v = rng.standard_normal((100, DIM)).astype(np.float32)
    w = rng.standard_normal((100, DIM)).astype(np.float32)

    base_mapping = {"vec": {
        "type": "knn_vector", "dimension": DIM, "space_type": "l2",
        "method": {"name": "disk_ann", "engine": "jvector",
                   "parameters": {"m": 8, "ef_construction": 32}}}}
    status, _ = _req(service, "PUT", "/mapupd", {
        "mappings": {"properties": dict(base_mapping)}})
    assert status == 200
    _req(service, "POST", "/mapupd/_bulk", {"docs": [
        {"_id": i, "vec": v[i].tolist()} for i in range(100)]})
    _req(service, "POST", "/mapupd/_flush")

    # add a second field
    status, out = _req(service, "PUT", "/mapupd/_mapping", {
        "properties": {"vec2": {
            "type": "knn_vector", "dimension": DIM, "space_type": "l2",
            "method": {"name": "disk_ann", "engine": "jvector",
                       "parameters": {"m": 8, "ef_construction": 32}}}}})
    assert status == 200 and out["added"] == ["vec2"]
    assert sorted(out["fields"]) == ["vec", "vec2"]

    # ingest + search the new field; the old field still serves
    _req(service, "POST", "/mapupd/_bulk", {"docs": [
        {"_id": i, "vec2": w[i].tolist()} for i in range(100)]})
    _req(service, "POST", "/mapupd/_flush")
    status, out = _req(service, "POST", "/mapupd/_search", {
        "size": 3, "query": {"knn": {"vec2": {"vector": w[9].tolist(),
                                              "k": 3}}}})
    assert status == 200 and out["hits"]["hits"][0]["_id"] == 9
    status, out = _req(service, "POST", "/mapupd/_search", {
        "size": 3, "query": {"knn": {"vec": {"vector": v[9].tolist(),
                                             "k": 3}}}})
    assert status == 200 and out["hits"]["hits"][0]["_id"] == 9

    # identical re-send: acknowledged no-op
    status, out = _req(service, "PUT", "/mapupd/_mapping", {
        "properties": dict(base_mapping)})
    assert status == 200 and out["added"] == []

    # conflicting update (different dimension) -> 400
    status, out = _req(service, "PUT", "/mapupd/_mapping", {
        "properties": {"vec": {"type": "knn_vector",
                               "dimension": DIM * 2}}})
    assert status == 400 and "cannot be changed" in out["error"]

    # absent index -> 404; no knn fields -> 400
    status, _ = _req(service, "PUT", "/nosuchidx/_mapping", {
        "properties": dict(base_mapping)})
    assert status == 404
    status, _ = _req(service, "PUT", "/mapupd/_mapping", {
        "properties": {"txt": {"type": "text"}}})
    assert status == 400


def test_cluster_settings_roundtrip(service):
    """GET/PUT /_cluster/settings drives the typed dynamic-settings
    registry (KNNSettings parity): valid updates apply and read back,
    unknown names and invalid values return 400, and non-dynamic
    settings refuse re-update."""
    status, out = _req(service, "GET", "/_cluster/settings")
    assert status == 200
    snap = out["persistent"]
    assert "knn.memory.circuit_breaker.limit" in snap

    status, out = _req(service, "PUT", "/_cluster/settings", {
        "persistent": {"knn.memory.circuit_breaker.limit": 60.0}})
    assert status == 200 and out["acknowledged"]
    status, out = _req(service, "GET", "/_cluster/settings")
    assert out["persistent"]["knn.memory.circuit_breaker.limit"] == 60.0

    # restore, via the transient tier (both tiers apply)
    status, _ = _req(service, "PUT", "/_cluster/settings", {
        "transient": {"knn.memory.circuit_breaker.limit": 50.0}})
    assert status == 200

    status, out = _req(service, "PUT", "/_cluster/settings", {
        "persistent": {"knn.no.such.setting": 1}})
    assert status == 400 and "unknown setting" in out["error"]
    status, out = _req(service, "PUT", "/_cluster/settings", {
        "persistent": {"knn.memory.circuit_breaker.limit": 400.0}})
    assert status == 400 and "invalid value" in out["error"]
    status, out = _req(service, "PUT", "/_cluster/settings", {})
    assert status == 400


def test_micro_batching_coalesces_concurrent_searches(service):
    """Concurrent single-vector searches with identical params must
    coalesce into one device dispatch (MicroBatcher), and every requester
    must get ITS OWN row — the device-serving analog of per-thread CPU
    queries."""
    import threading

    rng = np.random.default_rng(77)
    v = rng.standard_normal((64, DIM)).astype(np.float32)
    _req(service, "PUT", "/mbidx", {
        "mappings": {"properties": {
            "vec": {"type": "knn_vector", "dimension": DIM},
        }},
    })
    docs = [{"_id": i, "vec": v[i].tolist()} for i in range(64)]
    _req(service, "POST", "/mbidx/_bulk", {"docs": docs})
    _req(service, "POST", "/mbidx/_flush")

    # widen the window so slow test machines still coalesce
    service.manager.batcher.window_s = 0.25

    results = {}
    barrier = threading.Barrier(8)

    def one(i):
        barrier.wait()
        status, out = _req(service, "POST", "/mbidx/_search", {
            "query": {"knn": {"vec": {"vector": v[i].tolist(), "k": 3}}},
        })
        results[i] = (status, out)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)

    coalesced = 0
    for i in range(8):
        status, out = results[i]
        assert status == 200
        # each requester gets its own nearest neighbor, not the leader's
        assert out["hits"]["hits"][0]["_id"] == i
        coalesced = max(coalesced, out["profile"]["dispatch_rows"])
    # at least some of the 8 concurrent requests must have shared a
    # dispatch (all 8 typically do; >=2 keeps the assert robust)
    assert coalesced >= 2, coalesced


def test_micro_batching_excluded_paths_run_alone(service):
    """Filtered / radial / rescored-with-different-params queries must not
    be miscoalesced; filter queries bypass batching entirely."""
    rng = np.random.default_rng(78)
    v = rng.standard_normal((32, DIM)).astype(np.float32)
    _req(service, "PUT", "/mbidx2", {
        "mappings": {"properties": {
            "vec": {"type": "knn_vector", "dimension": DIM},
        }},
    })
    docs = [{"_id": i, "vec": v[i].tolist()} for i in range(32)]
    _req(service, "POST", "/mbidx2/_bulk", {"docs": docs})
    _req(service, "POST", "/mbidx2/_flush")

    status, out = _req(service, "POST", "/mbidx2/_search", {
        "query": {"knn": {"vec": {
            "vector": v[4].tolist(), "k": 2,
            "filter": [4, 5, 6],
        }}},
    })
    assert status == 200
    assert out["hits"]["hits"][0]["_id"] == 4
    assert out["profile"]["dispatch_rows"] == 1


def test_http11_keepalive_reuses_one_connection(service):
    """The handler speaks HTTP/1.1 with Content-Length on every response,
    so a client connection survives across requests (HTTP/1.0 closed the
    socket per request, forcing a reconnect AND a fresh server thread per
    request — a measured QPS ceiling under concurrent load)."""
    conn = http.client.HTTPConnection("127.0.0.1", service.port, timeout=60)
    socks = []
    for _ in range(3):
        conn.request("GET", "/_plugins/_knn/stats")
        r = conn.getresponse()
        assert r.version == 11
        body = r.read()
        assert r.status == 200 and body
        assert conn.sock is not None  # server did NOT close after response
        socks.append(id(conn.sock))
    assert len(set(socks)) == 1  # one TCP connection served all requests
    conn.close()
