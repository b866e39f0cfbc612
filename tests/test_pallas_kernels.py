"""Pallas kernel correctness vs the plain references.

The ADC scan kernel (`ops/pallas/adc_gpu.py`, Triton route) runs here in
interpret mode; `chip_smoke.py` checks the compiled kernel on the GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from opensearch_jvector_tpu.ops import adc as adc_ops
from opensearch_jvector_tpu.ops.pallas.adc_gpu import adc_scan_triton

SHAPES = [
    (300, 7, 64, 256),     # sift-like: M=64, N not a block multiple
    (257, 16, 192, 256),   # 960d default schedule: M padded to 256
    (64, 3, 8, 16),        # tiny K
    (1030, 130, 12, 256),  # Q > block, M padded to 16
    (16, 1, 6, 256),       # Q=1
]


def _oracle(luts, codes):
    m = luts.shape[1]
    return luts.astype(np.float64)[:, np.arange(m)[None, :],
                                   codes.astype(np.int64)].sum(-1)


@pytest.mark.parametrize("n,qn,m,k", SHAPES)
def test_triton_adc_kernel_matches_oracle(n, qn, m, k):
    rng = np.random.default_rng(n + m)
    luts = rng.random((qn, m, k), dtype=np.float32)
    codes = rng.integers(0, k, (n, m)).astype(np.uint8)
    out = adc_scan_triton(jnp.asarray(luts), jnp.asarray(codes),
                          interpret=True)
    assert out.shape == (qn, n)
    np.testing.assert_allclose(np.asarray(out), _oracle(luts, codes),
                               rtol=1e-5)


@pytest.mark.parametrize("bq,bn", [(1, 16), (4, 64), (8, 128)])
def test_triton_adc_kernel_block_shapes_pad(bq, bn):
    """Any block shape gives the same sums: Q and N are padded to the
    block, M and K to powers of two, and the padding is sliced off."""
    rng = np.random.default_rng(bq)
    luts = rng.random((5, 10, 24), dtype=np.float32)
    codes = rng.integers(0, 24, (70, 10)).astype(np.int32)
    out = adc_scan_triton(jnp.asarray(luts), jnp.asarray(codes),
                          block_q=bq, block_n=bn, interpret=True)
    np.testing.assert_allclose(np.asarray(out), _oracle(luts, codes),
                               rtol=1e-5)


def test_lookup_scan_off_gpu_is_the_xla_form():
    """`lookup_scan` picks its kernel by platform: off the GPU it is the
    XLA gather form, with no Triton call in the compiled program."""
    rng = np.random.default_rng(4)
    luts = jnp.asarray(rng.random((8, 16, 64), dtype=np.float32))
    codes = jnp.asarray(rng.integers(0, 64, (200, 16)).astype(np.uint8))
    assert jax.devices()[0].platform == "cpu"
    hlo = adc_ops.lookup_scan.lower(luts, codes).compile().as_text()
    assert "triton" not in hlo
    np.testing.assert_array_equal(
        np.asarray(adc_ops.lookup_scan(luts, codes)),
        np.asarray(adc_ops.lookup_scan_xla(luts, codes)))


def test_exact_topk_wide_matches_lax_topk():
    from opensearch_jvector_tpu.ops.topk import exact_topk_wide

    rng = np.random.default_rng(3)
    for qn, b, k in [(4, 20000, 10), (2, 4096, 5), (3, 12289, 50),
                     (1, 64, 7)]:
        s = jnp.asarray(rng.standard_normal((qn, b)), jnp.float32)
        ws, wi = exact_topk_wide(s, k)
        ts, ti = jax.lax.top_k(s, min(k, b))
        np.testing.assert_allclose(np.asarray(ws), np.asarray(ts))
        # ids may differ on exact score ties; values are the contract
        got = np.take_along_axis(np.asarray(s), np.asarray(wi), axis=1)
        np.testing.assert_allclose(got, np.asarray(ts))
