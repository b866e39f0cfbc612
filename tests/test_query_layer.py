"""Query layer tests: DSL parsing/validation, exact fallback, radial,
rescore, MMR, script scoring, scalar quantizers.

Models the reference's KNNQueryBuilderTests (parse/validate), iterator
exact-search tests, MMR processor tests, and quantizer unit tests.
"""

import numpy as np
import pytest

from opensearch_jvector_tpu.api.config import (
    QUANT_NONE,
    DiskAnnConfig,
    SearchConfig,
    ValidationError,
)
from opensearch_jvector_tpu.index.index import VectorIndex
from opensearch_jvector_tpu.models import scalar
from opensearch_jvector_tpu.ops.distances import SimilarityFunction
from opensearch_jvector_tpu.query import exact, knn, mmr
from opensearch_jvector_tpu.query.builder import KnnQuery, Rescore, parse_knn_query
from opensearch_jvector_tpu.utils.ground_truth import ground_truth_topk, recall_at_k

DIM = 16


def _cfg(**kw):
    base = dict(dim=DIM, similarity=SimilarityFunction.EUCLIDEAN, m=8,
                ef_construction=32, quantization_type=QUANT_NONE)
    base.update(kw)
    return DiskAnnConfig(**base)


def _vectors(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, DIM)).astype(np.float32)


@pytest.fixture(scope="module")
def small_index(tmp_path_factory):
    root = tmp_path_factory.mktemp("idx")
    idx = VectorIndex(root, _cfg())
    v = _vectors(500)
    for i in range(500):
        idx.add(i, v[i])
    idx.flush()
    return idx, v


# ---------------------------------------------------------------------------
# DSL parse / validate
# ---------------------------------------------------------------------------


def test_parse_full_query():
    q = parse_knn_query({
        "vector": [0.0] * DIM,
        "k": 10,
        "method_parameters": {
            "ef_search": 64,
            "overquery_factor": 3,
            "advanced.threshold": 0.1,
            "advanced.rerank_floor": 0.05,
            "advanced.use_pruning": False,
        },
        "rescore": {"oversample_factor": 2.0},
    })
    assert q.k == 10 and q.ef_search == 64 and q.overquery_factor == 3
    assert q.rescore.oversample_factor == 2.0
    assert not q.is_radial


def test_parse_rejects_bad_queries():
    with pytest.raises(ValidationError):
        parse_knn_query({"k": 5})  # no vector
    with pytest.raises(ValidationError):
        parse_knn_query({"vector": [0.0] * DIM})  # no k / radial
    with pytest.raises(ValidationError):
        parse_knn_query({"vector": [0.0] * DIM, "k": 5, "max_distance": 1.0})
    with pytest.raises(ValidationError):
        parse_knn_query({"vector": [0.0] * DIM, "k": 10**6})
    with pytest.raises(ValidationError):
        parse_knn_query({"vector": [0.0] * DIM, "k": 5, "bogus": 1})
    with pytest.raises(ValidationError):
        parse_knn_query({"vector": [0.0] * DIM, "k": 5,
                         "method_parameters": {"bogus": 1}})
    with pytest.raises(ValidationError):
        parse_knn_query({"vector": [0.0] * DIM, "k": 5,
                         "rescore": {"oversample_factor": 1000.0}})
    with pytest.raises(ValidationError):  # 2-D is batched; 3-D is invalid
        KnnQuery(vector=np.zeros((2, 2, 2)), k=5)


# ---------------------------------------------------------------------------
# execution paths
# ---------------------------------------------------------------------------


def test_ann_query_path(small_index):
    idx, v = small_index
    q = parse_knn_query({"vector": v[7] + 0.01, "k": 5})
    res = knn.execute_knn_query(idx, q)
    assert 7 in res.doc_ids[0]


def test_exact_fallback_on_restrictive_filter(small_index):
    idx, v = small_index
    accept = np.zeros(500, bool)
    accept[:20] = True  # 20 docs << k * oq -> exact path
    q = parse_knn_query({"vector": v[3], "k": 5, "filter": accept})
    res = knn.execute_knn_query(idx, q)
    ids = res.doc_ids[res.doc_ids >= 0]
    assert (ids < 20).all() and ids.size > 0
    assert res.doc_ids[0, 0] == 3  # exact: true NN is returned
    assert res.visited == 0  # graph was never walked


def test_radial_min_score(small_index):
    idx, v = small_index
    q = parse_knn_query({"vector": v[11], "min_score": 0.99})
    res = knn.execute_knn_query(idx, q)
    assert 11 in res.doc_ids[0]
    assert (res.scores[res.doc_ids >= 0] >= 0.99).all()


def test_radial_max_distance(small_index):
    idx, v = small_index
    q = parse_knn_query({"vector": v[11], "max_distance": 0.5})
    res = knn.execute_knn_query(idx, q)
    # only the identical vector is within distance 0.5 (score >= 1/1.5)
    ids = res.doc_ids[res.doc_ids >= 0]
    assert 11 in ids


def test_radial_inner_product_translation(tmp_path):
    """innerproduct radial: distance = -dot, engine score (1+dot)/2.

    max_distance d -> floor (1-d)/2 (NOT the cosine (2-d)/2, which is off
    by 0.5 and over-restricts); min_score is given in the reference's
    piecewise innerproduct score space (dot>=0 -> 1+dot).
    """
    import dataclasses

    from opensearch_jvector_tpu.api.config import DiskAnnConfig
    from opensearch_jvector_tpu.index.index import VectorIndex
    from opensearch_jvector_tpu.ops.distances import SimilarityFunction

    cfg = DiskAnnConfig(dim=DIM, similarity=SimilarityFunction.DOT_PRODUCT,
                        m=8, ef_construction=32, quantization_type="none")
    idx = VectorIndex(tmp_path / "ip", cfg)
    rng = np.random.default_rng(3)
    v = rng.standard_normal((50, DIM)).astype(np.float32) * 0.1
    # make doc 0 have dot(q, v0) ~= 0.5, doc 1 ~= -0.5 against q
    q_vec = np.zeros(DIM, np.float32)
    q_vec[0] = 1.0
    v[0] = 0.0; v[0][0] = 0.5
    v[1] = 0.0; v[1][0] = -0.5
    for i in range(50):
        idx.add(i, v[i])
    idx.flush()
    # max_distance 0.0 accepts dot >= 0 (doc 0 yes, doc 1 no)
    q = parse_knn_query({"vector": q_vec, "max_distance": 0.0})
    res = knn.execute_knn_query(idx, q)
    ids = res.doc_ids[res.doc_ids >= 0]
    assert 0 in ids and 1 not in ids
    # min_score 1.4 in reference space = dot >= 0.4 (doc 0 qualifies)
    q = parse_knn_query({"vector": q_vec, "min_score": 1.4})
    res = knn.execute_knn_query(idx, q)
    ids = res.doc_ids[res.doc_ids >= 0]
    assert 0 in ids and 1 not in ids
    # min_score 1.6 = dot >= 0.6 excludes doc 0 too
    q = parse_knn_query({"vector": q_vec, "min_score": 1.6})
    res = knn.execute_knn_query(idx, q)
    assert 0 not in res.doc_ids[res.doc_ids >= 0]


def test_rescore_oversample(small_index):
    idx, v = small_index
    q = parse_knn_query({"vector": v[42] + 0.05, "k": 5, "rescore": True})
    res = knn.execute_knn_query(idx, q)
    assert res.doc_ids.shape == (1, 5)
    assert res.doc_ids[0, 0] == 42


def test_exact_search_matches_ground_truth(small_index):
    idx, v = small_index
    seg = idx._reader(idx.segment_names[0]).seg
    qs = _vectors(6, seed=5)
    ids, scores = exact.exact_search_segment(seg, qs, 10)
    truth = ground_truth_topk(qs, v, 10, SimilarityFunction.EUCLIDEAN)
    assert recall_at_k(ids, truth, 10) == 1.0


# ---------------------------------------------------------------------------
# script scoring spaces
# ---------------------------------------------------------------------------


def test_script_scores_all_spaces():
    rng = np.random.default_rng(1)
    v = rng.standard_normal((50, DIM)).astype(np.float32)
    q = rng.standard_normal(DIM).astype(np.float32)
    l2 = exact.script_score(q, v, "l2")
    np.testing.assert_allclose(
        l2, 1.0 / (1.0 + ((v - q) ** 2).sum(-1)), rtol=1e-4)
    l1 = exact.script_score(q, v, "l1")
    np.testing.assert_allclose(
        l1, 1.0 / (1.0 + np.abs(v - q).sum(-1)), rtol=1e-4)
    linf = exact.script_score(q, v, "linf")
    np.testing.assert_allclose(
        linf, 1.0 / (1.0 + np.abs(v - q).max(-1)), rtol=1e-4)
    ip = exact.script_score(q, v, "innerproduct")
    d = v @ q
    np.testing.assert_allclose(
        ip, np.where(d <= 0, 1.0 / (1.0 - d), d + 1.0), rtol=1e-4)
    cos = exact.script_score(q, v, "cosinesimil")
    expected = 1.0 + (v @ q) / (np.linalg.norm(v, axis=1) * np.linalg.norm(q))
    np.testing.assert_allclose(cos, expected, rtol=1e-3)
    # hamming over packed bytes
    qb = np.asarray([0b1010_1010, 0b1111_0000], np.uint8)
    vb = np.asarray([[0b1010_1010, 0b1111_0000],
                     [0b0101_0101, 0b1111_0000]], np.uint8)
    h = exact.script_score(qb, vb, "hamming")
    np.testing.assert_allclose(h, [1.0, 1.0 / 9.0], rtol=1e-6)
    with pytest.raises(ValueError):
        exact.script_score(q, v, "bogus")


# ---------------------------------------------------------------------------
# MMR
# ---------------------------------------------------------------------------


def test_mmr_diversifies(small_index):
    idx, v = small_index
    qv = v[100] + 0.01
    plain = idx.search(qv, SearchConfig(k=5, ef_search=48))
    res = mmr.mmr_search(idx, qv, size=5, params=mmr.MMRParams(diversity=0.8))
    assert res.doc_ids.shape == (1, 5)
    assert (res.doc_ids >= 0).all()
    # diversity=0 must reproduce pure relevance ordering
    res0 = mmr.mmr_search(idx, qv, size=5, params=mmr.MMRParams(diversity=0.0))
    np.testing.assert_array_equal(res0.doc_ids, plain.doc_ids)
    with pytest.raises(ValidationError):
        mmr.MMRParams(diversity=1.5)


# ---------------------------------------------------------------------------
# scalar quantization
# ---------------------------------------------------------------------------


def test_one_bit_quantizer_roundtrip():
    rng = np.random.default_rng(2)
    v = rng.standard_normal((300, DIM)).astype(np.float32)
    state = scalar.train_scalar_quantizer(v, bits=1)
    assert state.thresholds.shape == (1, DIM)
    codes = scalar.quantize_vectors(state, v)
    assert codes.shape == (300, DIM // 8)
    # bit j of row i == v[i, j] > mean[j]
    bits = np.unpackbits(codes, axis=1)[:, :DIM]
    np.testing.assert_array_equal(bits, (v > state.thresholds[0]).astype(np.uint8))


def test_multibit_quantizer_and_hamming_recall():
    rng = np.random.default_rng(3)
    v = rng.standard_normal((500, DIM)).astype(np.float32)
    state = scalar.train_scalar_quantizer(v, bits=2)
    assert state.thresholds.shape == (3, DIM)
    codes = scalar.quantize_vectors(state, v)
    q = v[17] + 0.01
    qcode = scalar.quantize_vectors(state, q[None, :])[0]
    ids, scores = scalar.hamming_search(qcode, codes, 10)
    assert 17 in ids  # hamming over thermometer codes finds the near dup


def test_quantization_state_cache_evicts():
    cache = scalar.QuantizationStateCache(max_bytes=2000, ttl_seconds=1000)
    s1 = scalar.train_scalar_quantizer(np.ones((10, 100), np.float32), bits=1)
    cache.put("a", s1)
    cache.put("b", s1)
    cache.put("c", s1)  # 3 x 400B > 2000? no; force small
    assert cache.get("a") is not None
    big = scalar.QuantizationState(bits=1,
                                   thresholds=np.zeros((1, 1000), np.float32))
    cache.put("big1", big)
    cache.put("big2", big)  # 2 x 4kB > 2kB -> evictions
    assert cache.stats()["weight_bytes"] <= 8100


def test_batched_query_execution(small_index):
    """[Q, d] query vectors run as ONE batched engine call end-to-end,
    including rescore (the batch-amortization surface)."""
    idx, v = small_index
    qv = np.stack([v[3], v[17], v[29]])
    q = parse_knn_query({"vector": qv, "k": 5,
                         "rescore": {"oversample_factor": 2.0}})
    res = knn.execute_knn_query(idx, q)
    assert res.doc_ids.shape == (3, 5)
    # batched execution == three single-query executions
    for row, vec in enumerate(qv):
        q1 = parse_knn_query({"vector": vec, "k": 5,
                              "rescore": {"oversample_factor": 2.0}})
        r1 = knn.execute_knn_query(idx, q1)
        np.testing.assert_array_equal(res.doc_ids[row], r1.doc_ids[0])

    # batched radial
    q = parse_knn_query({"vector": qv, "max_distance": 0.5})
    res = knn.execute_knn_query(idx, q)
    assert res.doc_ids.shape[0] == 3
    for row, expect in zip(res.doc_ids, (3, 17, 29)):
        assert expect in row[row >= 0]  # exact scan: self-match present


def test_bulk_vector_readback(small_index):
    idx, v = small_index
    vecs, found = idx.get_vectors([7, 13, 10_000, -1, 42])
    assert found.tolist() == [True, True, False, False, True]
    np.testing.assert_allclose(vecs[0], v[7], rtol=1e-6)
    np.testing.assert_allclose(vecs[4], v[42], rtol=1e-6)
    assert (vecs[2] == 0).all()


def test_mmr_batched_multi_query(small_index):
    """MMR accepts [Q, d] query batches: the oversampled ANN pass runs as
    one engine dispatch and each row is reranked independently."""
    idx, v = small_index
    qv = np.stack([v[100] + 0.01, v[200] + 0.01])
    res = mmr.mmr_search(idx, qv, size=5,
                         params=mmr.MMRParams(diversity=0.5))
    assert res.doc_ids.shape == (2, 5)
    assert (res.doc_ids >= 0).all()
    # rows differ: each query got its own rerank
    assert set(res.doc_ids[0].tolist()) != set(res.doc_ids[1].tolist())
