"""Product quantization model (codebooks + codes).

Device replacement for jVector's `ProductQuantization` /
`PQVectors` (training call site JVectorIndexQuantization.java:114-140,
encode at :133, query-time ADC at JVectorReader.java:355).

Semantics mirrored from the reference:
  * k-means++ per subspace, <=256 clusters => 1 byte/code
    (`clusters = min(256, n)`, ProductQuantization.compute call)
  * global-mean centering for EUCLIDEAN (`centerData = EUCLIDEAN?`)
  * UNWEIGHTED clustering (plain-mean centroid updates)
  * dimension-adaptive default subspace count — the strictly-increasing
    bytes-per-vector schedule of JVectorIndexQuantization.PQ
    .defaultNumSubspaces (:428-446)
  * codebook reuse: an existing trained PQ re-encodes new vectors without
    retraining (merge path, JVectorWriter.java:1110-1125), plus the
    `refine` step the reference leaves TODO (issue #661): a few Lloyd
    iterations seeded from the existing codebooks over the merged data.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from opensearch_jvector_tpu.ops import adc as adc_ops
from opensearch_jvector_tpu.ops.distances import SimilarityFunction
from opensearch_jvector_tpu.ops.kmeans import _lloyd_iter, train_kmeans_subspaces


def default_num_subspaces(dim: int) -> int:
    """Dimension-adaptive PQ subspace count (bytes/vector strictly
    increasing with dim; schedule from the reference, see module docstring).
    """
    if dim <= 32:
        m = dim
    elif dim <= 64:
        m = 32
    elif dim <= 200:
        m = int(dim * 0.5)
    elif dim <= 400:
        m = 100
    elif dim <= 768:
        m = int(dim * 0.25)
    elif dim <= 1536:
        m = 192
    else:
        m = int(dim * 0.125)
    # the subspace count must divide into contiguous equal slices; snap down
    # to a divisor of dim so reshape-based subspace splits stay static
    while dim % m != 0:
        m -= 1
    return max(m, 1)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ProductQuantization:
    """Trained PQ state: codebooks + the global centering vector.

    `aniso_eta` (None = plain PQ) marks codebooks trained with the
    anisotropic score-aware loss (ScaNN, Guo et al. 2020): encode-time
    assignment must use the same loss, so it travels with the state."""

    codebooks: jax.Array  # [M, K, dsub] f32
    center: jax.Array  # [d] f32 (zeros when centering disabled)
    aniso_eta: jax.Array | None = None  # scalar f32

    @property
    def num_subspaces(self) -> int:
        return self.codebooks.shape[0]

    @property
    def num_clusters(self) -> int:
        return self.codebooks.shape[1]

    @property
    def dim(self) -> int:
        return self.codebooks.shape[0] * self.codebooks.shape[2]

    def compressed_bytes(self) -> int:
        return self.num_subspaces  # 1 byte/code (K <= 256)

    def original_bytes(self) -> int:
        return self.dim * 4


def _preprocess(
    vectors: jax.Array, simf: SimilarityFunction, center: jax.Array | None
):
    """Apply the training-space transform: centering (L2) / normalize (cos)."""
    if simf is SimilarityFunction.COSINE:
        v = vectors * jax.lax.rsqrt(
            jnp.sum(vectors * vectors, -1, keepdims=True) + 1e-30
        )
        return v, jnp.zeros((vectors.shape[1],), jnp.float32)
    if simf is SimilarityFunction.EUCLIDEAN:
        c = jnp.mean(vectors, axis=0) if center is None else center
        return vectors - c[None, :], c
    return vectors, jnp.zeros((vectors.shape[1],), jnp.float32)


def eta_for_threshold(threshold: float, dim: int) -> float:
    """ScaNN's parallel-error weight from a score threshold T: queries
    scoring >= T against a point matter; eta = (d-1) T^2 / (1 - T^2).

    `dim` should be the INTRINSIC dimension of the corpus: the formula
    assumes isotropic queries in d dims, so for latent-structured data the
    ambient dimension over-weights the parallel residual (measured: at
    960 ambient / 32 latent dims, eta=40 from ambient LOSES recall while
    eta~2 from the latent dim gains +3.6pts)."""
    t2 = float(threshold) ** 2
    return max(1.0, (dim - 1) * t2 / max(1e-9, 1.0 - t2))


def estimate_intrinsic_dim(vectors, max_rows: int = 16384) -> float:
    """Participation ratio of the covariance spectrum: (sum l)^2 / sum l^2.

    Real embedding corpora concentrate variance in far fewer directions
    than the ambient dimension; feeding the ambient dim into
    eta_for_threshold over-weights the parallel residual (measured recall
    LOSS at 960 ambient / 32 latent). The PR equals the ambient dim for
    isotropic data and the latent dim for low-rank data, so it is the
    right plug-in for the eta formula without user input."""
    x = np.asarray(vectors[:max_rows], np.float32)
    x = x - x.mean(axis=0, keepdims=True)
    cov = (x.T @ x) / max(1, x.shape[0] - 1)
    ev = np.linalg.eigvalsh(cov)
    ev = np.clip(ev, 0.0, None)
    s1, s2 = float(ev.sum()), float((ev * ev).sum())
    if s2 <= 0.0:
        return float(x.shape[1])
    return max(1.0, min(float(x.shape[1]), s1 * s1 / s2))


def eta_from_config(cfg, vectors) -> float | None:
    """Resolve the anisotropic weight for a config: threshold + ESTIMATED
    intrinsic dimension (None when the feature is off)."""
    t = getattr(cfg, "pq_anisotropic_threshold", None)
    if not t:
        return None
    # slice BEFORE np.asarray: the estimator needs <=16k rows, not a full
    # device->host fetch of the corpus
    return eta_for_threshold(t, estimate_intrinsic_dim(vectors))


def train_pq(
    vectors: jax.Array,  # [n, d]
    simf: SimilarityFunction,
    num_subspaces: int | None = None,
    num_clusters: int | None = None,
    iters: int = 8,
    seed: int = 0,
    max_train: int = 131072,
    anisotropic_eta: float | None = None,
) -> ProductQuantization:
    """Train PQ codebooks (k-means++ per subspace, vmapped).

    `anisotropic_eta` > 1 switches to the score-aware anisotropic loss
    (beyond-reference extension; best for inner-product/cosine corpora —
    BASELINE config 4 names anisotropic-PQ for Deep10M)."""
    n, d = vectors.shape
    m = num_subspaces or default_num_subspaces(d)
    if d % m != 0:
        raise ValueError(f"num_subspaces {m} must divide dim {d}")
    k = num_clusters or min(256, n)
    if isinstance(vectors, np.ndarray) and n > max_train:
        # big host-resident corpus (bulk/flat ingest): sample BEFORE the
        # device upload — training never needs more than max_train rows,
        # and a 10M-row corpus would otherwise ship 5GB over the host link
        # just to be subsampled. The sample mean stands in for the global
        # center (131k rows: same estimate to ~3 decimals).
        sel = np.random.default_rng(seed).choice(n, max_train, replace=False)
        vectors = vectors[np.sort(sel)]
        n = vectors.shape[0]
    x, center = _preprocess(jnp.asarray(vectors, jnp.float32), simf, None)
    if n > max_train:
        sel = np.random.default_rng(seed).choice(n, max_train, replace=False)
        x = x[jnp.asarray(np.sort(sel))]
    dsub = d // m
    x_sub = jnp.transpose(x.reshape(-1, m, dsub), (1, 0, 2))  # [M, n, dsub]
    if anisotropic_eta is not None and anisotropic_eta > 1.0:
        from opensearch_jvector_tpu.ops.kmeans import (
            train_kmeans_subspaces_aniso,
        )

        codebooks = train_kmeans_subspaces_aniso(
            x_sub, k, float(anisotropic_eta), iters,
            jax.random.PRNGKey(seed),
        )
        return ProductQuantization(
            codebooks=codebooks, center=center,
            aniso_eta=jnp.float32(anisotropic_eta),
        )
    codebooks = train_kmeans_subspaces(
        x_sub, k, iters, jax.random.PRNGKey(seed)
    )
    return ProductQuantization(codebooks=codebooks, center=center)


@jax.jit
def encode_pq(pq: ProductQuantization, vectors: jax.Array) -> jax.Array:
    """Encode [n, d] -> codes [n, M] uint8 (nearest centroid per subspace).

    One batched matmul per subspace (argmin over centroid distances).
    Anisotropically-trained codebooks assign with the same score-aware
    loss (the assignment metric is part of the trained state).
    """
    n, d = vectors.shape
    m, k, dsub = pq.codebooks.shape
    x = vectors - pq.center[None, :]
    x_sub = jnp.transpose(x.reshape(n, m, dsub), (1, 0, 2))  # [M, n, dsub]

    if pq.aniso_eta is not None:
        from opensearch_jvector_tpu.ops.kmeans import aniso_assign_scores

        def enc_one(xs, cb):  # [n, dsub], [K, dsub]
            return jnp.argmin(
                aniso_assign_scores(xs, cb, pq.aniso_eta), axis=1
            )
    else:
        def enc_one(xs, cb):  # [n, dsub], [K, dsub]
            dots = jax.lax.dot_general(
                xs, cb, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
            c2 = jnp.sum(cb * cb, axis=-1)[None, :]
            return jnp.argmin(c2 - 2.0 * dots, axis=1)  # x^2 const in argmin

    codes = jax.vmap(enc_one)(x_sub, pq.codebooks)  # [M, n]
    return jnp.transpose(codes).astype(jnp.uint8)


def encode_for_cosine(pq: ProductQuantization, vectors: jax.Array) -> jax.Array:
    """Cosine corpora are encoded normalized (ADC then uses plain dots)."""
    v = vectors * jax.lax.rsqrt(jnp.sum(vectors * vectors, -1, keepdims=True) + 1e-30)
    return encode_pq(pq, v)


ENCODE_CHUNK = 1 << 16  # bounds the [M, chunk, K] argmin intermediate


def encode(
    pq: ProductQuantization, vectors: jax.Array, simf: SimilarityFunction
) -> jax.Array:
    """Encode a corpus, chunked over rows.

    The per-subspace argmin materializes an [M, n, K] f32 intermediate —
    ~65KB/vector at M=64, K=256 — so one-shot encoding of a 10M corpus
    would need ~650GB. Fixed pow2 chunks keep the intermediate ~4GB and
    the program family at one compiled shape.
    """
    n = vectors.shape[0]
    enc_one = encode_for_cosine if simf is SimilarityFunction.COSINE \
        else encode_pq
    if n <= ENCODE_CHUNK:
        return enc_one(pq, vectors)
    out = []
    for s in range(0, n, ENCODE_CHUNK):
        chunk = vectors[s: s + ENCODE_CHUNK]
        if chunk.shape[0] < ENCODE_CHUNK:  # pad the tail: one program shape
            chunk = jnp.concatenate([
                chunk,
                jnp.zeros((ENCODE_CHUNK - chunk.shape[0], chunk.shape[1]),
                          chunk.dtype),
            ])
            out.append(enc_one(pq, chunk)[: n - s])
        else:
            out.append(enc_one(pq, chunk))
    return jnp.concatenate(out)


def refine_pq(
    pq: ProductQuantization,
    vectors: jax.Array,
    simf: SimilarityFunction,
    iters: int = 2,
    max_train: int = 131072,
    seed: int = 0,
) -> ProductQuantization:
    """Codebook refinement: Lloyd iterations seeded from existing codebooks.

    Implements the refinement hook the reference leaves as a no-op pending
    upstream issue #661 (JVectorWriter.java:1118-1123): on merge, the leading
    segment's codebooks are adapted to the merged distribution instead of
    being reused verbatim or retrained from scratch.
    """
    n, d = vectors.shape
    m, k, dsub = pq.codebooks.shape
    x, center = _preprocess(jnp.asarray(vectors, jnp.float32), simf, None)
    if n > max_train:
        sel = np.random.default_rng(seed).choice(n, max_train, replace=False)
        x = x[jnp.asarray(np.sort(sel))]
    x_sub = jnp.transpose(x.reshape(-1, m, dsub), (1, 0, 2))

    if pq.aniso_eta is not None:
        from opensearch_jvector_tpu.ops.kmeans import _lloyd_iter_aniso

        def refine_one(xs, cb):
            return jax.lax.fori_loop(
                0, iters,
                lambda _, c: _lloyd_iter_aniso(xs, c, pq.aniso_eta), cb,
            )
    else:
        def refine_one(xs, cb):
            return jax.lax.fori_loop(
                0, iters, lambda _, c: _lloyd_iter(xs, c), cb
            )

    codebooks = jax.vmap(refine_one)(x_sub, pq.codebooks)
    return ProductQuantization(codebooks=codebooks, center=center,
                               aniso_eta=pq.aniso_eta)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PQVectors:
    """PQ-encoded corpus: the device-resident approximate phase storage."""

    pq: ProductQuantization
    codes: jax.Array  # [n, M] uint8

    def decode(self, dtype=jnp.float32) -> jax.Array:
        """Approximate reconstruction [n, d] (centroid lookup + un-center).

        Chunked over rows: the [M, n, dsub] gather intermediate is
        4*d bytes/vector, so a one-shot 10M-row decode would transiently
        triple the corpus footprint.
        """
        n = self.codes.shape[0]
        chunk = ENCODE_CHUNK * 4

        def dec(codes):
            gathered = jax.vmap(
                lambda cb, c: cb[c], in_axes=(0, 1)
            )(self.pq.codebooks, codes.astype(jnp.int32))  # [M, c, dsub]
            flat = jnp.transpose(gathered, (1, 0, 2)).reshape(
                codes.shape[0], -1
            )
            return (flat + self.pq.center[None, :]).astype(dtype)

        if n <= chunk:
            return dec(self.codes)
        out = []
        for s in range(0, n, chunk):
            blk = self.codes[s: s + chunk]
            if blk.shape[0] < chunk:  # pad the tail: one program shape
                blk = jnp.concatenate([
                    blk,
                    jnp.zeros((chunk - blk.shape[0], blk.shape[1]),
                              blk.dtype),
                ])
                out.append(dec(blk)[: n - s])
            else:
                out.append(dec(blk))
        return jnp.concatenate(out)

    def decode_bf16(self) -> jax.Array:
        """Decoded-candidate cache [n, d] bf16 for the in-graph ADC tier.

        Replacement for fused-ADC beam scoring (the reference scores beam
        candidates through per-query LUT gathers —
        `pqVectors.precomputedScoreFunctionFor`, JVectorReader.java:355):
        the codes are decoded ONCE per segment load into a bf16 array, and
        beam candidates are then scored like fp32 rows (gather rows +
        einsum). Identical math: d(q, decode(c)) == sum_m LUT[m, code_m].
        Costs 2*d bytes/vector of device memory (vs 4*d fp32; the fp32
        rows stay in the host-side native store for rerank).
        """
        return self.decode(dtype=jnp.bfloat16)

    def build_query_luts(
        self, queries: jax.Array, simf: SimilarityFunction
    ) -> jax.Array:
        """Per-query ADC lookup tables [Q, M, K] (precomputedScoreFunctionFor
        parity): center/normalize the queries, score every centroid."""
        q = queries - self.pq.center[None, :]
        if simf is SimilarityFunction.COSINE:
            q = q * jax.lax.rsqrt(jnp.sum(q * q, -1, keepdims=True) + 1e-30)
        m, k, dsub = self.pq.codebooks.shape
        qsub = q.reshape(q.shape[0], m, dsub)
        return adc_ops.build_luts(qsub, self.pq.codebooks, simf.is_euclidean)

    def score_scan(
        self, queries: jax.Array, simf: SimilarityFunction,
        lo: int = 0, hi: int | None = None,
    ) -> jax.Array:
        """Full-scan ADC scores [Q, n] (`ops/adc.lookup_scan`).

        `lo`/`hi` scan a code slice (blocked big-N scans: the [Q, n] score
        slab must stay bounded)."""
        luts = self.build_query_luts(queries, simf)
        codes = self.codes if lo == 0 and hi is None else self.codes[lo:hi]
        vals = adc_ops.lookup_scan(luts, codes)
        return adc_ops.adc_value_to_score(vals, simf)
