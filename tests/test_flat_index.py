"""Flat (graph-less) index type: scan-tier-only segments.

FlatVectorFieldMapper parity (the reference's no-index flat vector type):
ingest is quantize + store only, every query serves through the scan
tier, and the bulk `add_batch` surface makes big-corpus ingest one array
append.
"""

import numpy as np
import pytest

from opensearch_jvector_tpu.api.config import (
    DiskAnnConfig,
    SearchConfig,
    ValidationError,
)
from opensearch_jvector_tpu.index.index import VectorIndex
from opensearch_jvector_tpu.index.scheduler import ForceMergesOnlyMergePolicy
from opensearch_jvector_tpu.ops.distances import SimilarityFunction
from opensearch_jvector_tpu.utils.ground_truth import (
    ground_truth_topk,
    recall_at_k,
)

DIM = 16


def _cfg(**kw):
    base = dict(dim=DIM, similarity=SimilarityFunction.EUCLIDEAN,
                index_type="flat", quantization_type="none")
    base.update(kw)
    return DiskAnnConfig(**base)


def _vectors(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, DIM)).astype(
        np.float32)


def test_flat_exact_scan_lifecycle(tmp_path):
    """flat + none: exact brute-force scan — recall 1.0 by construction;
    deletes, merge (concat-only), and reopen all behave."""
    v = _vectors(300)
    idx = VectorIndex(tmp_path, _cfg(),
                      merge_policy=ForceMergesOnlyMergePolicy())
    idx.add_batch(np.arange(200), v[:200])  # bulk block
    for i in range(200, 300):
        idx.add(i, v[i])
    idx.flush()
    assert idx.doc_count() == 300

    q = _vectors(8, seed=1)
    truth = ground_truth_topk(q, v, 10, SimilarityFunction.EUCLIDEAN)
    res = idx.search(q, SearchConfig(k=10))
    assert recall_at_k(res.doc_ids, truth, 10) == 1.0  # exact scan
    assert res.expanded == 0  # no graph traversal happened

    idx.delete([int(res.doc_ids[0, 0])])
    res2 = idx.search(q, SearchConfig(k=10))
    assert res.doc_ids[0, 0] not in res2.doc_ids[0].tolist()

    # concat-only merge keeps everything searchable
    extra = _vectors(50, seed=2)
    idx.add_batch(np.arange(300, 350), extra)
    idx.flush()
    idx.force_merge()
    assert len(idx.segment_names) == 1
    assert idx.doc_count() == 349
    res3 = idx.search(q, SearchConfig(k=10))
    deleted = int(res.doc_ids[0, 0])
    all_v = np.concatenate([v, extra])
    truth3 = ground_truth_topk(q, all_v, 11, SimilarityFunction.EUCLIDEAN)
    for qi in range(q.shape[0]):  # exact scan: top-10 of the live corpus
        want = [d for d in truth3[qi].tolist() if d != deleted][:10]
        assert res3.doc_ids[qi].tolist() == want

    idx2 = VectorIndex(tmp_path)  # reopen
    assert idx2.config.index_type == "flat"
    res4 = idx2.search(q, SearchConfig(k=10))
    np.testing.assert_array_equal(res3.doc_ids, res4.doc_ids)


def test_flat_pq_on_disk_scan(tmp_path):
    """flat + pq + on_disk: ADC/decoded scan on device, fp32 rerank paged
    from the native row store (the big-N larger-than-memory tier)."""
    n = 1500
    v = _vectors(n, seed=3)
    idx = VectorIndex(
        tmp_path,
        _cfg(quantization_type="pq", mode="on_disk", num_pq_subspaces=8,
             min_batch_size_for_quantization=64),
        merge_policy=ForceMergesOnlyMergePolicy(),
    )
    idx.add_batch(np.arange(n), v)
    idx.flush()

    seg = idx._reader(idx.segment_names[0]).seg
    assert seg.row_store is not None and seg.vectors is None  # really tiered
    assert seg.pqv is not None

    q = _vectors(8, seed=4)
    truth = ground_truth_topk(q, v, 10, SimilarityFunction.EUCLIDEAN)
    res = idx.search(q, SearchConfig(k=10, overquery_factor=8))
    assert recall_at_k(res.doc_ids, truth, 10) >= 0.9
    assert res.reranked > 0  # fp32 rerank ran

    # filters plumb through the scan tier
    accept = np.zeros(n, bool)
    accept[: n // 3] = True
    res2 = idx.search(q, SearchConfig(k=10, overquery_factor=8),
                      accept_docs=accept)
    ids = res2.doc_ids[res2.doc_ids >= 0]
    assert ids.size and (ids < n // 3).all()


def test_flat_rejects_unsupported_quant():
    with pytest.raises(ValidationError, match="flat index_type"):
        _cfg(quantization_type="nvq+pq")
    with pytest.raises(ValidationError, match="flat index_type"):
        _cfg(quantization_type="1bit")


def test_add_batch_validation(tmp_path):
    idx = VectorIndex(tmp_path, _cfg())
    with pytest.raises(ValueError):
        idx.add_batch([1, 2], _vectors(3))
    with pytest.raises(TypeError):
        idx.add_batch([1], np.zeros((1, DIM), np.int32))
    idx.add_batch([1, 2], _vectors(2))
    # buffered deletes hit blocks
    assert idx.writer.num_buffered() == 2
    idx.delete([1])
    assert idx.writer.num_buffered() == 1
