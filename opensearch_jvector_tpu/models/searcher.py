"""Batched, jitted Vamana beam search (the query-time hot loop).

Device replacement for jVector's `GraphSearcher.search(ssp, k, rerankK,
threshold, rerankFloor, acceptBits)` two-phase DiskANN search (call site
JVectorReader.java:166-208): an approximate phase walks the graph scoring
candidates with a (possibly PQ/ADC) score function, then survivors are
reranked with exact scores.

Design for XLA (no data-dependent shapes):
  * A whole batch of queries runs in one compiled program (`Q` static).
  * Per query: a fixed-size candidate pool `L` (ef_search) that doubles as a
    running deduplicated top-L of everything scored, `E` parallel expansions
    per iteration (beam widening — raises arithmetic intensity of the
    neighbor-gather + score step), and a fixed-capacity visited buffer.
  * `lax.while_loop` with an `active` mask per query; a query goes inactive
    when its pool has no unexpanded candidates or the iteration budget is
    hit; results = the pool's accepted top-`R = k * overquery_factor`.
  * Optional hierarchy pre-stage: a short beam on the coarse upper layer
    picks a per-query base-layer entry point.

Counters mirror `SearchResult` (visited/expanded/expanded-base-layer/
reranked; JVectorReader.java:184-208).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp

from opensearch_jvector_tpu.ops.distances import (
    SimilarityFunction,
    batched_candidate_scores,
)
from opensearch_jvector_tpu.ops.topk import topk_scores

NEG_INF = jnp.float32(-jnp.inf)


# ---------------------------------------------------------------------------
# Score providers (approximate phase). Static-dispatch via module-level
# callables: (ctx, qstate, ids [Q, C]) -> scores [Q, C].
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def make_exact_provider(simf_id: int):
    """Exact fp32 scoring provider: ctx={'vectors': [N, d]}; qstate=[Q, d].

    lru_cache gives each (provider, simf) pair a stable identity so it can be
    a static jit argument without retracing.
    """
    simf = SimilarityFunction(simf_id)

    def provider(ctx: dict[str, Any], qstate: jax.Array, ids: jax.Array):
        vecs = ctx["vectors"][jnp.clip(ids, 0)]  # [Q, C, d]
        return batched_candidate_scores(qstate, vecs, simf)

    return provider


@functools.lru_cache(maxsize=None)
def make_pq_provider(simf_id: int):
    """ADC scoring provider, decode-then-score formulation.

    ctx={'codes': [N, M] uint8, 'codebooks': [M, K, dsub]}; qstate = the
    CENTERED (and, for cosine, normalized) queries [Q, d].

    Gathers the candidates' codebook rows (decode) and scores them against
    the query with one batched einsum. Mathematically identical to
    per-element LUT gathers — the PQ distance decomposes per subspace, so
    d(q, decode(c)) == sum_m LUT[m, code_m]. Which of the two is faster on
    the H100 is not measured (ROADMAP S5); the full-scan path uses
    per-query LUTs (ops/adc.lookup_scan).
    """
    simf = SimilarityFunction(simf_id)
    # cosine corpora are encoded pre-normalized: plain dot, no re-normalize
    score_simf = (
        SimilarityFunction.DOT_PRODUCT
        if simf is SimilarityFunction.COSINE else simf
    )

    def provider(ctx: dict[str, Any], qstate: jax.Array, ids: jax.Array):
        codes = ctx["codes"][jnp.clip(ids, 0)]  # [Q, C, M] row gather
        cb = ctx["codebooks"]  # [M, K, dsub]
        m = cb.shape[0]
        dec = cb[jnp.arange(m)[None, None, :], codes]  # [Q, C, M, dsub]
        dec = dec.reshape(*codes.shape[:2], -1)  # [Q, C, d]
        return batched_candidate_scores(qstate, dec, score_simf)

    return provider


@functools.lru_cache(maxsize=None)
def make_hamming_provider():
    """Hamming scoring provider for scalar (1/2/4-bit) quantization:
    ctx={'codes': [N, B] uint8 bit-packed}; qstate = packed query codes
    [Q, B]. XOR + popcount on the VPU; score = 1/(1+distance)
    (KNNScoringUtil.calculateHammingBit parity)."""

    def provider(ctx: dict[str, Any], qstate: jax.Array, ids: jax.Array):
        codes = ctx["codes"][jnp.clip(ids, 0)]  # [Q, C, B] uint8
        x = jnp.bitwise_xor(codes, qstate[:, None, :])
        d = jnp.sum(jax.lax.population_count(x).astype(jnp.int32), axis=-1)
        return 1.0 / (1.0 + d.astype(jnp.float32))

    return provider


def _encode_scalar_queries(queries: jax.Array, thr: jax.Array) -> jax.Array:
    """Quantize queries against per-dimension thresholds -> packed uint8.

    Thermometer coding across levels (d-major bit order), identical to
    models/scalar.quantize_vectors so query and storage codes align.
    """
    above = (queries[:, None, :] > thr[None, :, :]).astype(jnp.uint8)
    qn = queries.shape[0]
    flat = jnp.transpose(above, (0, 2, 1)).reshape(qn, -1)
    pad = (-flat.shape[1]) % 8
    b = jnp.pad(flat, ((0, 0), (0, pad))).reshape(qn, -1, 8)
    weights = (2 ** jnp.arange(7, -1, -1, dtype=jnp.uint8))[None, None, :]
    return jnp.sum(b * weights, axis=-1).astype(jnp.uint8)


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Static search configuration (part of the jit cache key)."""

    k: int
    ef_search: int = 100  # candidate pool size L
    overquery_factor: int = 5  # rerank pool R = k * overquery_factor
    expansions_per_iter: int = 16  # E: beam widening factor (parallel
    # expansions per while_loop iteration; inherited, ROADMAP D4)
    max_iters: int = 0  # 0 -> derived from ef_search
    threshold: float = 0.0  # similarity cutoff on final results
    rerank_floor: float = 0.0  # approx-score floor to qualify for rerank

    def resolved_iters(self, ef: int) -> int:
        """Beam iteration cap for a candidate pool of `ef`.

        A query leaves the loop by itself once its pool holds no
        unexpanded candidate; a converged query expands about 1.5 * ef
        nodes, E per iteration, so the cap allows 2 * ef/E + 2 iterations.
        (A cap of ef/E stopped queries before their pools converged: on an
        H100 at a 700 W limit, 1M SIFT-like codes at ef=100 gave recall@10
        0.944 under it and 0.988 once every query converged. The factor
        and the +2 are still to be derived at a recall target, ROADMAP D4.)"""
        if self.max_iters:
            return self.max_iters
        return max(8, 2 * -(-ef // self.expansions_per_iter) + 2)


@dataclasses.dataclass
class SearchResult:
    """Batched results + per-batch counters (SearchResult parity incl. the
    base-layer expansion split used when the hierarchy layer is on)."""

    ids: jax.Array  # [Q, k] int32 (-1 pad)
    scores: jax.Array  # [Q, k] f32 (-inf pad)
    visited_count: jax.Array  # [Q] nodes scored
    expanded_count: jax.Array  # [Q] nodes expanded (all layers)
    reranked_count: jax.Array  # [Q]
    expanded_base_count: jax.Array | None = None  # [Q] base layer only


def _in_list(items: jax.Array, pool: jax.Array) -> jax.Array:
    """Membership mask of items [C] against pool [P] (ids; -1 never matches)."""
    eq = items[:, None] == pool[None, :]
    return jnp.any(eq & (items[:, None] >= 0), axis=1)


def _first_occurrence(items: jax.Array) -> jax.Array:
    """True at the first occurrence of each id within items [C]."""
    c = items.shape[0]
    eq = (items[:, None] == items[None, :]) & (items[:, None] >= 0)
    lower = jnp.tril(jnp.ones((c, c), bool), k=-1)
    return ~jnp.any(eq & lower, axis=1)


@functools.partial(
    jax.jit,
    static_argnames=("score_fn", "L", "E", "R", "max_iters", "vma_axis",
                     "masked_results"),
)
def beam_search(
    adjacency: jax.Array,  # [N, M] int32
    live: jax.Array,  # [N] bool
    entry: jax.Array,  # int32 scalar
    qstate: jax.Array,  # per-query scoring state ([Q,d] vectors or [Q,M,K] LUTs)
    ctx: dict[str, Any],  # storage-side scoring context
    accept: jax.Array,  # [N] bool — result filter (all-true when unfiltered)
    score_fn,
    L: int,
    E: int,
    R: int,
    max_iters: int,
    vma_axis: str | None = None,  # set when called inside shard_map: marks
    # constant-initialized loop carries as varying over that mesh axis
    masked_results: bool = True,  # False -> skip the accept/live result mask
    # (filter-free search on a clean graph needs no gather at all)
):
    """Batched best-first graph search.

    Returns (res_ids [Q,R], res_scores [Q,R], visited [Q], expanded [Q]).

    Design notes:
      * The candidate pool is a running top-L of every scored node — scores
        are static, duplicates are blocked on entry — so the results are
        just the pool's accepted top-R. No separate result queue, history
        buffer, or final dedupe sort.
      * `live` is NOT checked during traversal: adjacency rows only ever
        reference inserted nodes, and tombstoned (deleted-but-not-cleaned)
        nodes stay traversable, exactly like the reference
        (markNodeDeleted -> cleanup). Bool-table gathers per iteration were
        the single largest cost in the profile; deleted nodes are instead
        masked out of the RESULTS via `accept & live` on the final pool.
    """
    q = qstate.shape[0]
    m = adjacency.shape[1]
    v_cap = max_iters * E

    # entry: scalar (shared) or [Q] (per-query, e.g. from the upper layer)
    entry_arr = jnp.atleast_1d(jnp.asarray(entry, jnp.int32))
    entry_ids = jnp.broadcast_to(entry_arr[:, None], (q, 1)) if (
        entry_arr.shape[0] == q
    ) else jnp.broadcast_to(entry_arr[None, 0], (q, 1))
    entry_scores = score_fn(ctx, qstate, entry_ids)  # [Q, 1]

    cand_ids = jnp.full((q, L), -1, jnp.int32).at[:, 0].set(entry_ids[:, 0])
    cand_scores = jnp.full((q, L), NEG_INF).at[:, 0].set(entry_scores[:, 0])
    cand_expanded = jnp.zeros((q, L), bool)

    visited_buf = jnp.full((q, v_cap), -1, jnp.int32)
    visited_n = jnp.ones((q,), jnp.int32)  # entry was scored
    expanded_n = jnp.zeros((q,), jnp.int32)
    active = jnp.ones((q,), bool)

    def body(state):
        (it, cand_ids, cand_scores, cand_expanded,
         visited_buf, visited_n, expanded_n, active) = state

        # ---- pick top-E unexpanded candidates per query -------------------
        pickable = (~cand_expanded) & (cand_ids >= 0)
        pick_scores = jnp.where(pickable, cand_scores, NEG_INF)
        top_s, slots = jax.lax.top_k(pick_scores, E)  # [Q, E]
        picked_ids = jnp.take_along_axis(cand_ids, slots, axis=1)
        # Classic beam termination: run until the ef-sized candidate pool has
        # no unexpanded entries (or the iteration budget is hit). The
        # stop-at-worst-result rule fires far too early on high-dim data —
        # the frontier must cross score "valleys" below the k-th best seen.
        q_active = active & (top_s[:, 0] > NEG_INF)
        picked_valid = (top_s > NEG_INF) & q_active[:, None]

        # mark expanded
        cand_expanded = jax.vmap(lambda e, s, v: e.at[s].max(v))(
            cand_expanded, slots, picked_valid
        )

        # record visited (expanded) ids
        upd = jnp.where(picked_valid, picked_ids, -1)
        visited_buf = jax.lax.dynamic_update_slice(
            visited_buf, upd, (0, it * E)
        )
        expanded_n = expanded_n + jnp.sum(picked_valid, axis=1)

        # ---- gather neighbors --------------------------------------------
        nb = adjacency[jnp.clip(picked_ids, 0)]  # [Q, E, M]
        nb = jnp.where(picked_valid[:, :, None], nb, -1)
        nb = nb.reshape(q, E * m)

        nb_valid = nb >= 0
        nb_valid &= ~jax.vmap(_in_list)(nb, cand_ids)
        nb_valid &= ~jax.vmap(_in_list)(nb, visited_buf)
        nb_valid &= jax.vmap(_first_occurrence)(nb)
        nb = jnp.where(nb_valid, nb, -1)

        # ---- score new candidates ----------------------------------------
        nb_scores = score_fn(ctx, qstate, nb)  # [Q, E*M]
        nb_scores = jnp.where(nb_valid, nb_scores, NEG_INF)
        visited_n = visited_n + jnp.sum(nb_valid, axis=1)

        # ---- merge into candidate pool (top-L) ---------------------------
        all_ids = jnp.concatenate([cand_ids, nb], axis=1)
        all_scores = jnp.concatenate([cand_scores, nb_scores], axis=1)
        all_exp = jnp.concatenate(
            [cand_expanded, jnp.zeros_like(nb, dtype=bool)], axis=1
        )
        cand_scores, idx = jax.lax.top_k(all_scores, L)
        cand_ids = jnp.take_along_axis(all_ids, idx, axis=1)
        cand_expanded = jnp.take_along_axis(all_exp, idx, axis=1)

        return (it + 1, cand_ids, cand_scores, cand_expanded,
                visited_buf, visited_n, expanded_n, q_active)

    def cond(state):
        it = state[0]
        active = state[-1]
        return (it < max_iters) & jnp.any(active)

    state = (jnp.int32(0), cand_ids, cand_scores, cand_expanded,
             visited_buf, visited_n, expanded_n, active)
    if vma_axis is not None:
        def ensure_varying(x):
            try:
                return jax.lax.pcast(x, vma_axis, to="varying")
            except ValueError:  # already varying over this axis
                return x

        it0, *rest = state
        state = (it0, *(ensure_varying(x) for x in rest))
    (_, cand_ids, cand_scores, _, _, visited_n, expanded_n, _) = (
        jax.lax.while_loop(cond, body, state)
    )

    # ---- results: accepted & live top-R of the pool ------------------------
    if masked_results:
        ok = accept[jnp.clip(cand_ids, 0)] & live[jnp.clip(cand_ids, 0)]
        ok &= cand_ids >= 0
        pool_scores = jnp.where(ok, cand_scores, NEG_INF)
    else:
        pool_scores = cand_scores
    res_scores, res_ids = topk_scores(pool_scores, cand_ids, R)
    res_ids = jnp.where(res_scores > NEG_INF, res_ids, -1)
    return res_ids, res_scores, visited_n, expanded_n


@functools.lru_cache(maxsize=None)
def _make_search_fn(
    simf_id: int,
    approx: str,  # "exact" | "pq" | "scalar" approximate-phase provider
    rerank_src: str,  # "none" | "vectors" | "rerank_vectors" | "nvq"
    k: int,
    ef: int,
    e: int,
    r: int,
    iters: int,
    threshold: float,
    rerank_floor: float,
    masked_results: bool,
    use_upper: bool,
):
    """Build (and cache) ONE jitted program for the whole two-phase search.

    Everything — LUT build, beam loop, rerank, threshold — runs in a single
    XLA executable: per-query dispatch overhead is one call.
    """
    simf = SimilarityFunction(simf_id)
    provider = {
        "pq": make_pq_provider(simf_id),
        # decoded-bf16 ADC: candidates scored from a per-segment decoded
        # cache (PQVectors.decode_bf16) via row gathers + einsum — the
        # fused-ADC equivalent for the in-graph (beam) tier
        "pq_decoded": make_exact_provider(simf_id),
        "scalar": make_hamming_provider(),
        "exact": make_exact_provider(simf_id),
    }[approx]

    @jax.jit
    def run(adjacency, live, entry, queries, accept,
            vectors, pq_codes, pq_codebooks, pq_center, rerank_vectors, nvq,
            upper_adjacency, scalar_codes, scalar_thresholds, pq_decoded):
        qn = queries.shape[0]
        if approx == "pq_decoded":
            # decoded cache includes the center; raw queries, cast to the
            # cache dtype so the einsum runs in bf16 (f32 accumulation)
            qstate = queries.astype(pq_decoded.dtype)
            ctx = {"vectors": pq_decoded}
        elif approx == "pq":
            centered = (
                queries if pq_center is None else queries - pq_center[None, :]
            )
            if simf is SimilarityFunction.COSINE:
                centered = centered * jax.lax.rsqrt(
                    jnp.sum(centered * centered, -1, keepdims=True) + 1e-30
                )
            qstate = centered
            ctx = {"codes": pq_codes, "codebooks": pq_codebooks}
        elif approx == "scalar":
            qstate = _encode_scalar_queries(queries, scalar_thresholds)
            ctx = {"codes": scalar_codes}
        else:
            qstate, ctx = queries, {"vectors": vectors}

        upper_expanded = jnp.zeros((qn,), jnp.int32)
        if use_upper:
            # hierarchy layer: short beam on the coarse graph picks a
            # per-query base-layer entry point (HNSW-style descent)
            up_ids, _, up_visited, upper_expanded = beam_search(
                upper_adjacency, live, entry, qstate, ctx, accept, provider,
                L=16, E=4, R=1, max_iters=8, masked_results=False,
            )
            entry = jnp.where(up_ids[:, 0] >= 0, up_ids[:, 0],
                              jnp.broadcast_to(entry, (qn,)))
        res_ids, res_scores, visited, expanded = beam_search(
            adjacency, live, entry, qstate, ctx, accept, provider,
            L=ef, E=e, R=r, max_iters=iters, masked_results=masked_results,
        )
        base_expanded = expanded
        expanded = expanded + upper_expanded

        # ---- rerank phase -------------------------------------------------
        if approx not in ("exact",) and rerank_src != "none":
            qualify = res_ids >= 0
            if rerank_floor > 0.0:  # 0.0 == disabled (reference default)
                qualify &= res_scores >= rerank_floor
            safe = jnp.clip(res_ids, 0)
            if rerank_src == "nvq":
                cand = nvq.decode_rows(safe)  # lazy NVQ row decode
            elif rerank_src == "rerank_vectors":
                cand = rerank_vectors[safe]
            else:
                cand = vectors[safe]
            exact = batched_candidate_scores(queries, cand, simf)
            exact = jnp.where(qualify, exact, NEG_INF)
            reranked = jnp.sum(qualify, axis=1).astype(jnp.int32)
            final_scores, final_ids = topk_scores(exact, res_ids, k)
        else:
            reranked = jnp.zeros((qn,), jnp.int32)
            final_scores, final_ids = topk_scores(res_scores, res_ids, k)

        keep = final_scores > NEG_INF
        if threshold > 0.0:  # 0.0 == disabled (reference default)
            keep &= final_scores >= threshold
        final_ids = jnp.where(keep, final_ids, -1)
        final_scores = jnp.where(keep, final_scores, NEG_INF)
        return (final_ids, final_scores, visited, expanded, base_expanded,
                reranked)

    return run


def search(
    adjacency: jax.Array,
    live: jax.Array,
    entry: jax.Array,
    queries: jax.Array,  # [Q, d] f32
    params: SearchParams,
    simf: SimilarityFunction,
    *,
    vectors: jax.Array | None = None,  # [N, d] exact storage (rerank source)
    pq_codes: jax.Array | None = None,  # [N, M] uint8/int32 PQ codes
    pq_codebooks: jax.Array | None = None,  # [M, K, dsub]
    pq_center: jax.Array | None = None,  # [d] global mean (EUCLIDEAN centering)
    accept: jax.Array | None = None,  # [N] bool result filter
    rerank_vectors: jax.Array | None = None,  # override rerank source
    nvq=None,  # NVQVectors: lazy-decoded rerank source (nvq+pq segments)
    has_tombstones: bool = True,  # False -> skip result masking when
    # unfiltered (clean graph: every pool entry is live)
    upper_adjacency: jax.Array | None = None,  # hierarchy layer (optional)
    scalar_codes: jax.Array | None = None,  # [N, B] uint8 bit-packed codes
    scalar_thresholds: jax.Array | None = None,  # [levels, d] f32
    pq_decoded: jax.Array | None = None,  # [N, d] bf16 decoded-PQ cache
    # (in-graph ADC tier)
) -> SearchResult:
    """Two-phase search over one graph segment (ONE compiled program).

    Approximate phase scores with ADC when PQ codes are provided, else exact.
    Rerank phase rescores the top `k*overquery_factor` survivors with exact
    fp32 (or NVQ-decoded) scores, applying `rerank_floor` then `threshold`
    (JVectorReader.java:166-208).
    """
    masked_results = (accept is not None) or has_tombstones
    if accept is None:
        accept = live  # mask reduces to live & live; skipped when unmasked
    r = max(params.k * params.overquery_factor, params.k)
    ef = max(params.ef_search, r)
    iters = params.resolved_iters(ef)
    if pq_decoded is not None:
        approx = "pq_decoded"
        if rerank_vectors is not None:
            rerank_src = "rerank_vectors"
        elif vectors is not None:
            rerank_src = "vectors"
        else:
            rerank_src = "none"
    elif pq_codes is not None:
        approx = "pq"
        assert pq_codebooks is not None
        if nvq is not None:
            rerank_src = "nvq"
        elif rerank_vectors is not None:
            rerank_src = "rerank_vectors"
        elif vectors is not None:
            rerank_src = "vectors"
        else:
            rerank_src = "none"
    elif scalar_codes is not None:
        approx = "scalar"
        assert scalar_thresholds is not None and vectors is not None
        rerank_src = "vectors"
    else:
        approx = "exact"
        assert vectors is not None
        rerank_src = "none"

    fn = _make_search_fn(
        simf.value, approx, rerank_src, params.k, ef,
        params.expansions_per_iter, r, iters,
        float(params.threshold), float(params.rerank_floor), masked_results,
        upper_adjacency is not None,
    )
    final_ids, final_scores, visited, expanded, base_expanded, reranked = fn(
        adjacency, live, entry, queries, accept,
        vectors, pq_codes, pq_codebooks, pq_center, rerank_vectors, nvq,
        upper_adjacency, scalar_codes, scalar_thresholds, pq_decoded,
    )
    return SearchResult(
        ids=final_ids,
        scores=final_scores,
        visited_count=visited,
        expanded_count=expanded,
        expanded_base_count=base_expanded,
        reranked_count=reranked,
    )
