"""ADC (asymmetric distance computation) kernels for PQ search.

Device replacement for jVector's per-query precomputed score function
(`pqVectors.precomputedScoreFunctionFor`, call site JVectorReader.java:355)
and the fused-ADC lookup path (README.md:37 "Fused ADC").

Two pieces:
  1. `build_luts` — per-query lookup tables: partial scores of each query
     subvector against every centroid of that subspace ([Q, M, K] in one
     batched matmul).
  2. `lookup_*` — accumulate LUT entries addressed by PQ codes.

Raw accumulated value convention (matches PQ training space):
  EUCLIDEAN:    sum of per-subspace squared distances  -> score 1/(1+sum)
  DOT_PRODUCT:  sum of per-subspace dots               -> score (1+sum)/2
  COSINE:       handled as DOT_PRODUCT over pre-normalized vectors
Use `adc_value_to_score` to map accumulated values to graph scores.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from opensearch_jvector_tpu.ops.distances import SimilarityFunction


@functools.partial(jax.jit, static_argnames=("euclidean",))
def build_luts(
    query_sub: jax.Array,  # [Q, M, dsub] query split into subvectors
    codebooks: jax.Array,  # [M, K, dsub]
    euclidean: bool,
) -> jax.Array:
    """Per-query ADC lookup tables [Q, M, K].

    One batched matmul per call: einsum('qmd,mkd->qmk').
    """
    dots = jnp.einsum(
        "qmd,mkd->qmk", query_sub, codebooks,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    if not euclidean:
        return dots
    q2 = jnp.sum(query_sub * query_sub, axis=-1)[:, :, None]  # [Q, M, 1]
    c2 = jnp.sum(codebooks * codebooks, axis=-1)[None, :, :]  # [1, M, K]
    return jnp.maximum(q2 + c2 - 2.0 * dots, 0.0)


def _lookup_one_query(luts_q: jax.Array, codes: jax.Array) -> jax.Array:
    """luts_q: [M, K]; codes: [C, M] int -> accumulated [C]."""
    # Per-subspace gather, vectorized over M; XLA lowers to dynamic gathers.
    per_m = jax.vmap(lambda lut_m, code_m: lut_m[code_m], in_axes=(0, 1))(
        luts_q, codes
    )  # [M, C]
    return jnp.sum(per_m, axis=0)


@jax.jit
def lookup_candidates(luts: jax.Array, codes: jax.Array) -> jax.Array:
    """Accumulate ADC values for per-query candidate code rows.

    luts: [Q, M, K]; codes: [Q, C, M] -> [Q, C].
    """
    return jax.vmap(_lookup_one_query)(luts, codes)


@jax.jit
def lookup_scan_xla(luts: jax.Array, codes: jax.Array) -> jax.Array:
    """Accumulate ADC values for ALL code rows, as plain XLA: table
    gathers [Q, M*K] addressed by code + m*K, summed over M (the reference
    form, and the scan off the GPU). luts [Q, M, K]; codes [N, M] -> [Q, N].
    """
    q, m, k = luts.shape
    idx = codes.astype(jnp.int32) + (jnp.arange(m, dtype=jnp.int32) * k)
    return jnp.sum(luts.reshape(q, m * k)[:, idx], axis=-1)


@jax.jit
def lookup_scan(luts: jax.Array, codes: jax.Array) -> jax.Array:
    """Accumulate ADC values for ALL code rows (full-scan path).

    luts: [Q, M, K]; codes: [N, M] (shared across queries) -> [Q, N].

    On a GPU this is the Pallas Triton-route kernel
    (`ops/pallas/adc_gpu.adc_scan_triton`), which beat both XLA forms of
    the scan end to end on an H100, and beat the gather form at every
    (M, K) timed there: M = 7, 32, 64, 100, 192 at K=256, and M=12 at
    K=16 (CHANGES.md). On other platforms it is `lookup_scan_xla`. Both
    are float32 sums of the same table entries.
    """
    from opensearch_jvector_tpu.ops.pallas.adc_gpu import adc_scan_triton

    return jax.lax.platform_dependent(
        luts, codes, cuda=adc_scan_triton, default=lookup_scan_xla)


def adc_value_to_score(values: jax.Array, simf: SimilarityFunction) -> jax.Array:
    """Map accumulated ADC values to graph scores (higher = better)."""
    if simf is SimilarityFunction.EUCLIDEAN:
        return 1.0 / (1.0 + values)
    # DOT_PRODUCT and COSINE (cosine encodes normalized vectors)
    return (1.0 + values) / 2.0
