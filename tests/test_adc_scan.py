"""The scan tier's scoring pieces against NumPy float64 references: the
codes-only LUT ADC scan, the euclidean value fold, the scan's top-k rule
and the recall oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from opensearch_jvector_tpu.ops import adc as adc_ops
from opensearch_jvector_tpu.ops.distances import SimilarityFunction

SHAPES = [
    (300, 7, 64, 256, 2),     # sift-like: 64 subspaces of 2 dims
    (257, 16, 192, 256, 5),   # 960d default schedule
    (64, 3, 8, 16, 8),        # tiny K, dsub=8
    (1030, 130, 12, 256, 16), # GIST 64x-compression-like, Q > 128
    (16, 1, 6, 256, 21),      # odd dsub, Q=1
]


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("n,qn,m,k,dsub", SHAPES)
def test_lut_adc_scan_matches_float64_oracle(n, qn, m, k, dsub, dtype):
    """lookup_scan(build_luts(q), codes) == sum_m ||q_m - cb[m, code_m]||^2
    computed in float64 from the same codebooks."""
    rng = np.random.default_rng(7)
    codes = rng.integers(0, k, (n, m)).astype(dtype)
    books = rng.standard_normal((m, k, dsub)).astype(np.float32)
    q = rng.standard_normal((qn, m * dsub)).astype(np.float32)
    luts = adc_ops.build_luts(jnp.asarray(q.reshape(qn, m, dsub)),
                              jnp.asarray(books), euclidean=True)
    got = np.asarray(adc_ops.lookup_scan(luts, jnp.asarray(codes)))
    dec = books.astype(np.float64)[np.arange(m)[None, :],
                                   codes.astype(np.int64)]  # [n, m, dsub]
    ref = ((dec[None] - q.astype(np.float64).reshape(qn, 1, m, dsub)) ** 2
           ).sum((-1, -2))
    assert got.shape == (qn, n)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_euclidean_value_fold_matches_decoded_distance():
    """The euclidean fold q2 + c2 - 2 q.c inside the tables reproduces the
    squared distance to the decoded (centered) vector, and
    adc_value_to_score maps it to 1/(1+d^2)."""
    from opensearch_jvector_tpu.models import pq as pq_mod

    rng = np.random.default_rng(3)
    n, qn, dim = 400, 5, 32
    v = rng.standard_normal((n, dim)).astype(np.float32)
    q = rng.standard_normal((qn, dim)).astype(np.float32)
    pq = pq_mod.train_pq(jnp.asarray(v), SimilarityFunction.EUCLIDEAN,
                         num_subspaces=8, num_clusters=16)
    codes = pq_mod.encode(pq, jnp.asarray(v), SimilarityFunction.EUCLIDEAN)
    pqv = pq_mod.PQVectors(pq=pq, codes=codes)
    scores = np.asarray(pqv.score_scan(jnp.asarray(q),
                                       SimilarityFunction.EUCLIDEAN))
    dec = np.asarray(pqv.decode(), np.float64)  # center included
    d2 = ((q.astype(np.float64)[:, None, :] - dec[None]) ** 2).sum(-1)
    np.testing.assert_allclose(scores, 1.0 / (1.0 + d2), rtol=1e-4)


@pytest.mark.parametrize("n,r", [(300, 50), (20_000, 50), (5_000, 5_000),
                                 (10, 50)])
def test_topk_scan_rule_is_exact(n, r):
    """The scan's selection rule returns the exact top-r scores."""
    from opensearch_jvector_tpu.index.reader import _topk_scan

    rng = np.random.default_rng(n)
    s = rng.standard_normal((3, n)).astype(np.float32)
    vals, idx = _topk_scan(jnp.asarray(s), r)
    want = -np.sort(-s, axis=1)[:, : min(r, n)]
    np.testing.assert_array_equal(np.asarray(vals), want)
    np.testing.assert_array_equal(
        np.take_along_axis(s, np.asarray(idx), axis=1), want)


@pytest.mark.parametrize("simf", list(SimilarityFunction))
def test_ground_truth_matches_float64_topk(simf):
    """The recall oracle (float32 products at Precision.HIGHEST, exact
    top-k) returns the float64 top-k."""
    from opensearch_jvector_tpu.utils.ground_truth import ground_truth_topk

    rng = np.random.default_rng(simf.value)
    v = rng.standard_normal((3000, 48)).astype(np.float32)
    q = rng.standard_normal((20, 48)).astype(np.float32)
    v64, q64 = v.astype(np.float64), q.astype(np.float64)
    if simf is SimilarityFunction.EUCLIDEAN:
        s = -((q64[:, None, :] - v64[None]) ** 2).sum(-1)
    elif simf is SimilarityFunction.DOT_PRODUCT:
        s = q64 @ v64.T
    else:
        s = (q64 / np.linalg.norm(q64, axis=1, keepdims=True)) @ (
            v64 / np.linalg.norm(v64, axis=1, keepdims=True)).T
    want = np.argsort(-s, axis=1, kind="stable")[:, :10]
    got = ground_truth_topk(q, v, 10, simf)
    np.testing.assert_array_equal(np.sort(got, axis=1),
                                  np.sort(want, axis=1))
