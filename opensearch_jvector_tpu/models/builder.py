"""Batched Vamana graph construction on the device.

Replaces jVector's `GraphIndexBuilder` (thread-safe concurrent greedy insert,
call sites JVectorWriter.java:1390-1417 fresh build / :1298-1331 incremental
mutation) with bulk-synchronous *rounds*: each round beam-searches candidate
sets for a whole batch of pending inserts on-device (one compiled program),
alpha-robust-prunes the batch in one vmapped kernel, then applies adjacency
updates with deterministic vectorized conflict resolution.

The adjacency matrix is DEVICE-RESIDENT throughout the build (the earlier
host-mirrored design re-uploaded ~20MB of adjacency per round over the host
link and capped build throughput): the host computes only the small edge
lists (slots, overflow sets) from the downloaded [B, M] selection and
applies them with device scatters.

Capabilities mirrored from the reference builder:
  * maxConn (M), beamWidth, alpha, neighborOverflow slack, hierarchy flag
    (accepted, single-layer only — reference default is also off,
    KNNConstants.java:112)
  * quantized construction: beam scoring via a PQ build-score provider
    (BuildScoreProvider.pqBuildScoreProvider, JVectorWriter.java:1059-1063)
  * markNodeDeleted + cleanup() — tombstones folded in with 2-hop edge
    repair at cleanup (GraphIndexBuilder.cleanup semantics)
  * incremental append into a loaded graph (leading-segment merge,
    JVectorWriter.java:1166-1341)
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from opensearch_jvector_tpu.models import searcher as searcher_mod
from opensearch_jvector_tpu.models.graph import (
    VamanaGraph,
    bucket_capacity,
    pad_rows,
)
from opensearch_jvector_tpu.ops.distances import (
    SimilarityFunction,
    batched_candidate_scores,
    pairwise_scores,
)

NEG_INF = float("-inf")

# JVECTOR_TPU_BUILD_PROFILE=1 -> per-phase wall-clock breakdown of insert
# rounds (search / prune / back-edges / apply / overflow), accumulated in
# BuildCounters.phase_s. Blocks after each phase, so throughput drops while
# profiling; diagnosis only.
import os as _os

BUILD_PROFILE = _os.environ.get("JVECTOR_TPU_BUILD_PROFILE", "0") == "1"

# Program shapes already compiled in THIS process (the jitted factories are
# lru_cached, so jit caches persist process-wide). A warm thread's throwaway
# insert round costs real device compute — ~30% of a 100k build when every
# pow2 ramp bucket re-warms — so repeat builds of the same shape family
# (flush after flush of one index, bench warm passes) skip it entirely.
_WARMED_PROGRAMS: set = set()


def _as_build_rows(vectors) -> jax.Array:
    """Build-source rows: fp32 by default, bf16 passed THROUGH.

    A bf16 source is the quantized-construction configuration (the
    decoded-PQ cache as the only resident corpus — the reference's pure
    PQ BuildScoreProvider, BuildScoreProvider.pqBuildScoreProvider): beam
    scoring reads it natively and every prune/score site upcasts its
    gathered rows to f32, so the fp32 corpus never needs device
    residency. This is what lifts the single-chip build ceiling past
    2^22 (see docs/design.md, build memory)."""
    arr = jnp.asarray(vectors)
    if arr.dtype == jnp.bfloat16:
        return arr
    return arr.astype(jnp.float32)


def _score_to_dist(scores: jax.Array, simf: SimilarityFunction) -> jax.Array:
    """Map similarity scores to a pruning distance (lower = closer)."""
    if simf is SimilarityFunction.EUCLIDEAN:
        # score = 1/(1+d2)  ->  d2 = 1/score - 1; use sqrt for a true metric.
        return jnp.sqrt(jnp.maximum(1.0 / jnp.maximum(scores, 1e-30) - 1.0, 0.0))
    # DOT/COSINE: score in ~[0,1]; 1 - score is a consistent pseudo-distance.
    return 1.0 - scores


@functools.partial(jax.jit, static_argnames=("m_out", "simf_id"))
def robust_prune_batch(
    point_vecs: jax.Array,  # [B, d] the nodes being pruned for
    cand_ids: jax.Array,  # [B, C] candidate ids (-1 pad)
    cand_vecs: jax.Array,  # [B, C, d]
    cand_scores: jax.Array,  # [B, C] similarity to point (-inf pad)
    alpha: float,
    m_out: int,
    simf_id: int,
    point_ids: jax.Array | None = None,  # [B] to mask self-candidates
) -> jax.Array:
    """Vectorized alpha-robust-prune -> selected ids [B, m_out] (-1 pad).

    DiskANN rule: repeatedly take the closest unpruned candidate c*, then
    prune every c with alpha * d(c*, c) <= d(p, c). Sequential in the m_out
    selections, O(C) vector work per step, vmapped over the batch.
    (VamanaDiversityProvider semantics, JVectorWriter.java:1294.)
    """
    simf = SimilarityFunction(simf_id)
    b, c = cand_ids.shape
    # f32 edge precision even when the gathered rows come from a bf16
    # build source (quantized construction): the gathers are [B, C, d]
    # blocks, so the upcast is fused and never materializes a corpus copy
    point_vecs = point_vecs.astype(jnp.float32)
    cand_vecs = cand_vecs.astype(jnp.float32)
    cand_scores = cand_scores.astype(jnp.float32)

    d_p = _score_to_dist(cand_scores, simf)  # [B, C]
    cc_scores = jax.vmap(lambda v: pairwise_scores(v, v, simf))(cand_vecs)
    d_cc = _score_to_dist(cc_scores, simf)  # [B, C, C]

    # Dedupe: keep only first occurrence of each candidate id.
    eq = (cand_ids[:, :, None] == cand_ids[:, None, :]) & (
        cand_ids[:, :, None] >= 0
    )
    lower = jnp.tril(jnp.ones((c, c), bool), k=-1)[None]
    dup = jnp.any(eq & lower, axis=2)
    valid0 = (cand_ids >= 0) & ~dup
    if point_ids is not None:
        valid0 &= cand_ids != point_ids[:, None]

    inf = jnp.float32(jnp.inf)

    def step(t, state):
        alive, selected = state
        dp = jnp.where(alive, d_p, inf)
        i = jnp.argmin(dp, axis=1)  # [B]
        ok = jnp.take_along_axis(dp, i[:, None], axis=1)[:, 0] < inf
        sel_id = jnp.take_along_axis(cand_ids, i[:, None], axis=1)[:, 0]
        selected = selected.at[:, t].set(jnp.where(ok, sel_id, -1))
        d_star = jnp.take_along_axis(
            d_cc, i[:, None, None], axis=1
        )[:, 0, :]  # [B, C] distances from c* to all candidates
        # STRICT inequality: differs from <= only on exact ties, i.e.
        # duplicate vectors (d_star == d_p == 0), which must stay selectable
        # or an all-duplicates corpus collapses to degree-1 chains
        pruned = alpha * d_star < d_p
        alive = alive & ~pruned & ok[:, None]
        alive = alive.at[jnp.arange(b), i].set(False)
        return alive, selected

    selected0 = jnp.full((b, m_out), -1, jnp.int32)
    _, selected = jax.lax.fori_loop(0, m_out, step, (valid0, selected0))
    return selected


# ---------------------------------------------------------------------------
# cached jitted device programs (one eager dispatch each per round)
# ---------------------------------------------------------------------------


# Corpus-block width for the orphan-repair nearest-host scan. A single
# [512, capacity] score pass is 8.6GB f32 at 4M capacity (x2 with the
# hostable mask select); blocking caps the score matrix at [512, 2^18] =
# 0.5GB while reusing ONE compiled program across blocks (capacity is
# pow2 >= 64, so blocks divide evenly). The width is inherited, not
# derived on the H100 (ROADMAP D4).
ORPHAN_SCAN_BLOCK = 1 << 18


@functools.lru_cache(maxsize=None)
def _make_orphan_block_fn(simf_id: int):
    """Running nearest-hostable argmax over one corpus block."""
    simf = SimilarityFunction(simf_id)

    @jax.jit
    def fn(rows, vblock, hblock, base, best_s, best_i):
        sc = pairwise_scores(rows, vblock, simf)  # [512, CB]
        sc = jnp.where(hblock[None, :], sc, NEG_INF)
        bs = jnp.max(sc, axis=1)
        bi = jnp.argmax(sc, axis=1).astype(jnp.int32) + base
        take = bs > best_s
        return jnp.where(take, bs, best_s), jnp.where(take, bi, best_i)

    return fn


def _nearest_hostable(ob_dev, vectors, hostable_dev, simf):
    """argmax over the hostable corpus of similarity to 512 query rows,
    scanned in ORPHAN_SCAN_BLOCK-wide corpus blocks. Returns [512] int32
    host ids (device array)."""
    cap = int(vectors.shape[0])
    cb = min(cap, ORPHAN_SCAN_BLOCK)
    rows = vectors[ob_dev].astype(jnp.float32)
    fn = _make_orphan_block_fn(simf.value)
    best_s = jnp.full((ob_dev.shape[0],), NEG_INF, jnp.float32)
    best_i = jnp.zeros((ob_dev.shape[0],), jnp.int32)
    for lo in range(0, cap, cb):
        best_s, best_i = fn(
            rows, jax.lax.dynamic_slice_in_dim(vectors, lo, cb),
            jax.lax.dynamic_slice_in_dim(hostable_dev, lo, cb),
            jnp.int32(lo), best_s, best_i,
        )
    return best_i


@functools.lru_cache(maxsize=None)
def _make_round_prune_fn(simf_id: int, m_out: int, top_r: int, alpha: float):
    """Insert-round device work: intra-round candidates + gather + prune."""
    simf = SimilarityFunction(simf_id)

    @jax.jit
    def run(batch_ids, cand_ids, cand_scores, vectors):
        queries = vectors[batch_ids].astype(jnp.float32)
        b = queries.shape[0]
        if top_r > 0:
            rr = pairwise_scores(queries, queries, simf)
            rr = jnp.where(jnp.eye(b, dtype=bool), NEG_INF, rr)
            rr_scores, rr_idx = jax.lax.top_k(rr, top_r)
            rr_ids = batch_ids[rr_idx]
            cand_ids = jnp.concatenate([cand_ids, rr_ids], axis=1)
            cand_scores = jnp.concatenate([cand_scores, rr_scores], axis=1)
        cand_vecs = vectors[jnp.clip(cand_ids, 0)]
        return robust_prune_batch(
            queries, cand_ids, cand_vecs, cand_scores,
            alpha, m_out, simf_id, point_ids=batch_ids,
        )

    return run


@functools.lru_cache(maxsize=None)
def _make_dead_scan_fn():
    """[capacity] bool: which rows reference a tombstoned (non-live)
    neighbor. Runs where the adjacency lives."""

    @jax.jit
    def run(adj, live):
        return jnp.any((adj >= 0) & ~live[jnp.clip(adj, 0)], axis=1)

    return run


@functools.lru_cache(maxsize=None)
def _make_reachability_fn():
    """Device-side BFS: which live nodes are reachable from `entry` over
    live-node paths. One full-adjacency scatter sweep per hop (Vamana
    diameter is ~log n, so ~10-20 sweeps); replaces the host BFS that
    fetched the whole adjacency (20MB at 100k) through the host link every
    cleanup pass."""

    @jax.jit
    def run(adj, live, entry):
        cap = adj.shape[0]
        reach0 = jnp.zeros((cap,), bool).at[entry].set(live[entry])

        def body(state):
            reach, _ = state
            tgt = jnp.where(reach[:, None] & (adj >= 0), adj, cap)
            hit = jnp.zeros((cap + 1,), bool).at[tgt.reshape(-1)].set(True)
            nxt = (hit[:cap] & live) | reach
            return nxt, jnp.any(nxt != reach)

        reach, _ = jax.lax.while_loop(
            lambda s: s[1], body, (reach0, live[entry])
        )
        return reach

    return run


@functools.lru_cache(maxsize=None)
def _make_overflow_prune_fn(simf_id: int, m_out: int, alpha: float):
    """Overflow prune: gather rows from the device adjacency, append the
    dropped-edge extras, score + prune, return (sel, new adjacency rows)."""
    simf = SimilarityFunction(simf_id)

    @jax.jit
    def run(ids, adj, extras, vectors):
        cand = jnp.concatenate([adj[ids], extras], axis=1)
        pvecs = vectors[ids].astype(jnp.float32)
        cvecs = vectors[jnp.clip(cand, 0)].astype(jnp.float32)
        scores = batched_candidate_scores(pvecs, cvecs, simf)
        scores = jnp.where(cand >= 0, scores, NEG_INF)
        sel = robust_prune_batch(
            pvecs, cand, cvecs, scores, alpha, m_out, simf_id, point_ids=ids
        )
        rows = jnp.full((ids.shape[0], adj.shape[1]), -1, jnp.int32)
        rows = rows.at[:, : sel.shape[1]].set(sel)
        new_adj = adj.at[ids].set(rows)
        return sel, new_adj

    return run


@functools.lru_cache(maxsize=None)
def _make_splice_prune_fn(simf_id: int, m_out: int, alpha: float):
    """Delete-splice: replace dead neighbors with live 2-hop candidates,
    prune, and write the rows back — all on device."""
    simf = SimilarityFunction(simf_id)

    @jax.jit
    def run(ids, adj, live, vectors):
        rows = adj[ids]  # [B, cap]
        b, cap = rows.shape
        hop2 = adj[jnp.clip(rows, 0)].reshape(b, cap * cap)
        hop2 = jnp.where(
            jnp.repeat(rows < 0, cap, axis=1), -1, hop2
        )
        cand = jnp.concatenate([rows, hop2], axis=1)
        cand = jnp.where(live[jnp.clip(cand, 0)] & (cand >= 0), cand, -1)
        cand = jnp.where(cand == ids[:, None], -1, cand)
        pvecs = vectors[ids].astype(jnp.float32)
        cvecs = vectors[jnp.clip(cand, 0)]
        scores = batched_candidate_scores(pvecs, cvecs, simf)
        # Mask duplicate ids (keep one occurrence) BEFORE the top-k so the
        # narrowed window isn't wasted on copies of one near neighbor. Done
        # by sort + adjacent-equal (O(C log C)); a pairwise-equality mask
        # would be O(C^2) — the very blowup this function avoids.
        order = jnp.argsort(cand, axis=1)
        sorted_cand = jnp.take_along_axis(cand, order, axis=1)
        dup_sorted = jnp.concatenate(
            [jnp.zeros((b, 1), bool),
             (sorted_cand[:, 1:] == sorted_cand[:, :-1])
             & (sorted_cand[:, 1:] >= 0)],
            axis=1,
        )
        dup = jnp.zeros_like(dup_sorted).at[
            jnp.arange(b)[:, None], order
        ].set(dup_sorted)
        scores = jnp.where((cand >= 0) & ~dup, scores, NEG_INF)
        # Narrow to the best W candidates by score before robust prune: the
        # prune is O(C^2) in memory ([B, C, C] pairwise), and the raw 2-hop
        # set is cap + cap^2 wide (~1.5k at m=32) — 18GB of intermediate at
        # B=2048. The alpha-prune only ever selects near candidates, so a
        # score top-k preselect is lossless in practice.
        w = min(4 * m_out, cand.shape[1])
        top_scores, top_idx = jax.lax.top_k(scores, w)
        top_cand = jnp.take_along_axis(cand, top_idx, axis=1)
        top_cand = jnp.where(top_scores > NEG_INF, top_cand, -1)
        sel = robust_prune_batch(
            pvecs, top_cand, vectors[jnp.clip(top_cand, 0)], top_scores,
            alpha, m_out, simf_id, point_ids=ids,
        )
        out_rows = jnp.full((b, cap), -1, jnp.int32)
        out_rows = out_rows.at[:, : sel.shape[1]].set(sel)
        new_adj = adj.at[ids].set(out_rows)
        return sel, new_adj

    return run


@functools.lru_cache(maxsize=None)
def _make_apply_edges_fn():
    """Forward-row write + reverse-edge scatter in one device program.

    Edge arrays are padded to a fixed width (retraces per round otherwise);
    padding uses out-of-bounds destinations dropped by the scatter mode.
    """

    @jax.jit
    def run(adj, new_ids, rows, dst, slot, src):
        adj = adj.at[new_ids].set(rows)
        return adj.at[dst, slot].set(src, mode="drop")

    return run


@functools.cache
def _make_fwd_apply_fn(cap_deg: int):
    """Forward-row write + live mark, straight from the prune's DEVICE
    output — no host round trip. This is the half of edge application the
    pipelined build runs eagerly so the NEXT round's beam search can be
    dispatched before the host has even seen this round's prune results
    (reverse edges follow one round later; see build())."""

    @jax.jit
    def run(adj, live, new_ids, sel):
        rows = jnp.pad(
            sel, ((0, 0), (0, cap_deg - sel.shape[1])), constant_values=-1
        )
        return adj.at[new_ids].set(rows), live.at[new_ids].set(True)

    return run


@functools.lru_cache(maxsize=None)
def _make_apply_reverse_fn():
    """Reverse-edge scatter alone (the host-computed half of a round)."""

    @jax.jit
    def run(adj, dst, slot, src):
        return adj.at[dst, slot].set(src, mode="drop")

    return run


class _DeviceAdj:
    """Device-resident adjacency + host degree mirror."""

    def __init__(self, adj_dev: jax.Array, deg: np.ndarray):
        self.dev = adj_dev  # int32 [capacity, cap_deg]
        self.deg = deg  # host int32 [capacity]

    @property
    def cap_deg(self) -> int:
        return self.dev.shape[1]

    def rows(self, ids: np.ndarray) -> np.ndarray:
        return np.asarray(self.dev[jnp.asarray(ids, jnp.int32)])

    def pad_rows(self, sel: np.ndarray) -> np.ndarray:
        out = np.full((sel.shape[0], self.cap_deg), -1, np.int32)
        out[:, : sel.shape[1]] = sel
        return out


@dataclasses.dataclass
class BuildCounters:
    rounds: int = 0
    nodes_inserted: int = 0
    nodes_deleted: int = 0
    phase_s: dict = dataclasses.field(default_factory=dict)

    def _phase(self, name: str, dt: float) -> None:
        self.phase_s[name] = self.phase_s.get(name, 0.0) + dt


class GraphIndexBuilder:
    """Bulk-synchronous Vamana builder.

    Usage:
        builder = GraphIndexBuilder(dim, max_degree=32, beam_width=100, ...)
        graph = builder.build(vectors, simf)              # fresh build
        graph = builder.add_nodes(graph, vectors, ids)    # delta insert
        graph = builder.cleanup(graph, vectors)           # prune + repair
    """

    def __init__(
        self,
        dim: int,
        max_degree: int = 32,
        beam_width: int = 100,
        alpha: float = 1.2,
        neighbor_overflow: float = 1.2,
        hierarchy_enabled: bool = False,
        batch_size: int | None = None,  # None -> auto by dim (see below)
        seed: int = 42,
        refine_passes: int = 0,
        score_dtype: str = "fp32",  # "bf16": construction beam scores from
        # a bf16 corpus copy (half the HBM traffic of the dominant build
        # phase); prune distances stay fp32, so graph quality holds
        extra_width: int | None = None,  # overflow-prune extras per node
        # per round; bounds the O(C^2) robust-prune candidate width
        # (C = overflow_degree + extra_width). Back-edges beyond it in one
        # round are dropped (forward edges remain; cleanup repairs orphans)
        construction_expansions: int = 8,  # beam E during insert rounds
        overflow_chunk: int | None = None,  # overflow-prune dispatch width
        # (None -> batch_size). Wider chunks cut per-round dispatch count
        # for the overflow phase (the dominant build phase at 100k) at the
        # cost of a larger [chunk, C, d] gather transient.
    ):
        self.hierarchy_enabled = bool(hierarchy_enabled)
        self.dim = dim
        self.max_degree = int(max_degree)
        self.beam_width = int(beam_width)
        self.alpha = float(alpha)
        self.neighbor_overflow = float(neighbor_overflow)
        self.overflow_degree = max(
            self.max_degree, int(self.max_degree * self.neighbor_overflow)
        )
        if batch_size is None:
            # Insert-round size is the dominant throughput lever (fewer
            # serial rounds -> fewer host syncs and better device
            # utilization). Bounded by the round-prune's
            # transient [B, C, d] candidate gather (~1.5GB budget), so it
            # scales down automatically for high-dim corpora.
            c_width = self.beam_width + self.max_degree
            cap = int(1.5e9 / (max(1, dim) * 4 * max(1, c_width)))
            batch_size = 2048
            while batch_size * 2 <= min(cap, 16384):
                batch_size *= 2
        self.batch_size = int(batch_size)
        self.seed = seed
        self.refine_passes = int(refine_passes)
        if score_dtype not in ("fp32", "bf16"):
            raise ValueError(f"score_dtype must be fp32|bf16: {score_dtype}")
        self.score_dtype = score_dtype
        self.extra_width = (min(2 * self.max_degree, 32)
                            if extra_width is None else int(extra_width))
        self.construction_expansions = int(construction_expansions)
        oc = int(overflow_chunk) if overflow_chunk else self.batch_size
        # snap DOWN to a pow2 so overflow chunks stay inside the pre-warmed
        # pow2 program family (a 50k chunk would compile a one-off shape
        # serially inside cleanup — the stall the warm threads exist to hide)
        self.overflow_chunk = max(64, 1 << (oc.bit_length() - 1))
        self.counters = BuildCounters()
        self._has_tombstones = False

    def _bucket(self, n: int) -> int:
        """Pad width for a round of n real items: next power of two (min 64),
        capped at batch_size. Bounds compute for small rounds while keeping
        the set of compiled program shapes small (pow2 family, one compile
        each, persistent-cached)."""
        b = 64
        while b < n:
            b *= 2
        return min(b, self.batch_size)

    # -- scoring helpers ---------------------------------------------------

    @staticmethod
    def _pad_pq(pq: dict | None, capacity: int) -> dict | None:
        """Pad row-indexed PQ score-source arrays to the graph capacity.

        Search-program families are keyed by array SHAPES: a caller handing
        a [n, d] decoded cache to build() and a [n', d] one to add_nodes()
        would otherwise trigger a full recompile of every round program for
        the second shape. Normalizing to the pow2 capacity keeps one
        family.
        """
        if pq is None:
            return None
        out = dict(pq)
        for k in ("decoded", "codes"):
            if k in out:
                out[k] = pad_rows(out[k], capacity)
        return out

    def _search_candidates(
        self, adj_dev, live_dev, entry, vectors, queries, simf, pq=None
    ):
        """Beam-search candidate pools for a batch of insert points.

        Returns (ids [B, R], scores [B, R]) of the best-scored visited nodes.
        """
        r = self.beam_width
        params = searcher_mod.SearchParams(
            # E=8 default for construction: build rounds are
            # throughput-bound (big insert batches) and E=16 scores ~25%
            # more candidates for the same recall (tunable —
            # construction_expansions — because fewer, wider serial hops
            # can win when per-iteration fixed costs dominate).
            k=r, ef_search=r, overquery_factor=1,
            expansions_per_iter=self.construction_expansions,
            # Iteration budget: the beam stops when the ef-pool holds no
            # unexpanded entry — measured at ~ceil(ef/E) iterations,
            # uniformly across queries (expanded mean==max==97 at ef=100/
            # E=8). The default budget (ef iterations) sizes the visited
            # ring at ef*E entries and the per-iteration dedup sweep with
            # it — 6x the VPU work the loop can ever use. +8 covers
            # eviction-driven re-expansions on adversarial corpora.
            max_iters=-(-r // self.construction_expansions) + 8,
        )
        if pq is not None and "decoded" in pq:
            # quantized construction, decoded-bf16 formulation: candidate
            # scoring gathers rows from the decoded cache (einsum) — same
            # scores as ADC LUTs (see PQVectors.decode_bf16). No rerank
            # during construction.
            kwargs = dict(pq_decoded=pq["decoded"])
        elif pq is not None:
            kwargs = dict(
                pq_codes=pq["codes"],
                pq_codebooks=pq["codebooks"],
                pq_center=pq.get("center"),
                vectors=vectors,
            )
        else:
            kwargs = dict(vectors=vectors)
        res = searcher_mod.search(
            adj_dev, live_dev, jnp.int32(entry), queries, params, simf,
            has_tombstones=self._has_tombstones, **kwargs,
        )
        return res.ids, res.scores

    # -- adjacency application ----------------------------------------------

    def _compute_back_edges(self, deg, new_ids, selected, cap):
        """Host-side reverse-edge slot assignment (deterministic).

        Returns (dst, slot, src) fitting edges plus overflow prune work
        (overflow_ids, extras). Edges that don't fit are NOT silently
        dropped — they become overflow-prune candidates so the node chooses
        among (current neighbors ∪ new sources), mirroring the reference's
        insert-with-overflow-then-prune. Silent drops disconnect late-round
        nodes.
        """
        b, ms = selected.shape
        src = np.repeat(new_ids, ms)
        dst = selected.reshape(-1)
        keep = dst >= 0
        src, dst = src[keep], dst[keep]
        empty = (np.empty(0, np.int64),) * 3
        if dst.size == 0:
            return (*empty, np.empty(0, np.int64), np.empty((0, 0), np.int32))
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
        group_start = np.searchsorted(dst, dst, side="left")
        rank = np.arange(dst.size) - group_start
        slot = deg[dst] + rank
        ok = slot < cap
        counts = np.bincount(dst, minlength=deg.shape[0])
        newdeg = np.minimum(deg + counts, cap)
        overflow_ids = np.unique(dst[newdeg[dst] >= cap])
        deg[:] = newdeg

        dropped = ~ok
        max_extra = self.extra_width  # bounds the overflow-prune C width
        extras = np.full((overflow_ids.size, max_extra), -1, np.int32)
        if dropped.any():
            ddst, dsrc = dst[dropped], src[dropped]
            dgs = np.searchsorted(ddst, ddst, side="left")
            drank = np.arange(ddst.size) - dgs
            sel_rows = np.searchsorted(overflow_ids, ddst)
            m = drank < max_extra
            extras[sel_rows[m], drank[m]] = dsrc[m]
        return dst[ok], slot[ok], src[ok], overflow_ids, extras

    def _prune_overflow(self, st: _DeviceAdj, node_ids, vectors, simf,
                        extras=None):
        """Re-prune `node_ids` to max_degree on device (rows written back)."""
        if node_ids.size == 0:
            return
        chunk = self.overflow_chunk
        e_width = self.extra_width  # constant candidate width (no retrace)
        fn = _make_overflow_prune_fn(simf.value, self.max_degree, self.alpha)
        pending: list[tuple[np.ndarray, object]] = []
        for s in range(0, node_ids.size, chunk):
            ids = node_ids[s : s + chunk]
            bucket = 64  # pow2 family capped at the overflow chunk width
            while bucket < ids.size:
                bucket *= 2
            bucket = min(bucket, chunk)
            pad = bucket - ids.size
            # pad with duplicates of the first id AND its extras: duplicate
            # scatter rows then compute identical results, so the undefined
            # write order of duplicate scatter indices cannot matter
            ids_p = np.pad(ids, (0, pad), constant_values=ids[0])
            ex = np.full((bucket, e_width), -1, np.int32)
            if extras is not None and extras.size:
                blk = extras[s : s + chunk]
                ex[: blk.shape[0], : blk.shape[1]] = blk[:, :e_width]
            if pad:
                ex[ids.size:] = ex[0]
            sel, st.dev = fn(
                jnp.asarray(ids_p, jnp.int32), st.dev, jnp.asarray(ex),
                vectors,
            )
            pending.append((ids, sel))
        # ONE host fetch for the whole overflow pass: per-chunk fetches were
        # the dominant overflow cost through the host link (each sync pays
        # the full dispatch RTT; the chunks' adjacency updates chain on
        # device regardless)
        for ids, sel in pending:
            sel_np = np.asarray(sel)[: ids.size]
            st.deg[ids] = (sel_np >= 0).sum(axis=1)

    # -- compile pre-warm ----------------------------------------------------

    def _prewarm_programs(self, st: _DeviceAdj, live_dev, entry, vectors,
                          simf, pq, buckets) -> None:
        """Compile the per-bucket round program family CONCURRENTLY.

        XLA compiles of the round programs dominate cold builds (tens of
        seconds per shape; the ramp loop otherwise serializes them). Each
        warm thread runs one THROWAWAY insert round at a distinct bucket
        size against a scratch adjacency (jax arrays are immutable, so the
        real adjacency cannot be affected); compiles overlap, so cold cost
        ~= max(compile) instead of sum(compile). Threads are joined before
        the real loop starts so the main thread never races a warm thread
        into compiling the same program twice.
        """
        import threading

        # warm threads compile for the device this build runs on (JAX's
        # default device is thread-local, e.g. one shard build per device)
        device = jax.config.jax_default_device
        capacity = int(st.dev.shape[0])
        if pq is None:
            pk = ("fp32",)
        elif "decoded" in pq:
            pk = ("decoded", tuple(pq["decoded"].shape),
                  str(pq["decoded"].dtype))
        else:
            pk = ("codes", tuple(pq["codes"].shape),
                  tuple(pq["codebooks"].shape))
        base = (capacity, self.dim, self.max_degree, self.beam_width,
                self.alpha, self.construction_expansions,
                self.overflow_degree, self.extra_width, simf.value,
                self._has_tombstones, pk, str(device))

        def key(kind: str, bucket: int):
            return (kind, bucket, base)

        buckets = sorted(
            b for b in set(buckets)
            if key("round", b) not in _WARMED_PROGRAMS
        )

        def warm(bucket: int) -> None:
            try:
                scratch = _DeviceAdj(st.dev, st.deg.copy())
                batch = np.full(bucket, int(entry), np.int64)
                self._insert_round(scratch, live_dev, entry, batch, vectors,
                                   simf, pq)
            except Exception:  # noqa: BLE001 — warm-up must never fail a build
                pass

        def warm_cleanup() -> None:
            # cleanup's device programs (dead scan, reachability BFS, row
            # gather) are one-per-capacity; compile them overlapped too
            try:
                _make_dead_scan_fn()(st.dev, live_dev)
                _make_reachability_fn()(st.dev, live_dev, jnp.int32(entry))
                st.dev[jnp.full((512,), int(entry), jnp.int32)]
                # orphan-repair block-scan program (512-wide gather +
                # per-block pairwise + running argmax — one compile)
                ob = jnp.full((512,), int(entry), jnp.int32)
                np.asarray(_nearest_hostable(ob, vectors, live_dev, simf))
            except Exception:  # noqa: BLE001
                pass

        def warm_overflow(bucket: int) -> None:
            # cleanup-time overflow prunes hit pow2 chunk shapes the insert
            # rounds never touch; compiling them here (overlapped) instead
            # of serially inside cleanup() shaves minutes off cold builds
            try:
                fn = _make_overflow_prune_fn(
                    simf.value, self.max_degree, self.alpha
                )
                ids = jnp.full((bucket,), int(entry), jnp.int32)
                ex = jnp.full((bucket, self.extra_width), -1, jnp.int32)
                fn(ids, st.dev, ex, vectors)
            except Exception:  # noqa: BLE001
                pass

        over_buckets = set()
        b = 64
        while b <= max(self.batch_size, self.overflow_chunk):
            if key("overflow", b) not in _WARMED_PROGRAMS:
                over_buckets.add(b)
            b *= 2
        def on_device(fn):
            def run(*args):
                with jax.default_device(device):
                    fn(*args)
            return run

        threads = [threading.Thread(target=on_device(warm), args=(b,),
                                    daemon=True)
                   for b in buckets]
        threads += [
            threading.Thread(target=on_device(warm_overflow), args=(b,),
                             daemon=True)
            for b in sorted(over_buckets)
        ]
        if key("cleanup", 0) not in _WARMED_PROGRAMS:
            threads.append(threading.Thread(target=on_device(warm_cleanup),
                                            daemon=True))
            _WARMED_PROGRAMS.add(key("cleanup", 0))
        if not threads:
            return  # everything in this family already compiled
        if len(threads) > 1:  # one cold program: let the loop compile it
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        # best-effort marking: a failed warm falls back to a serial compile
        # inside the loop (correctness unaffected), so mark unconditionally
        for b in buckets:
            _WARMED_PROGRAMS.add(key("round", b))
        for b in over_buckets:
            _WARMED_PROGRAMS.add(key("overflow", b))

    def _delta_chunks(self, n: int) -> list[int]:
        """Round sizes for a delta insert. Full batch_size rounds, then the
        remainder — split once at its pow2 floor when that shrinks total
        bucketed compute (a 10k delta as one 16384-padded round wastes
        ~40% of the round; 8192 + 2048-padded costs ~10.2k units). Never
        splits below 2048 (per-round fixed costs dominate tiny rounds)."""
        out, rem = [], int(n)
        while rem > self.batch_size:
            out.append(self.batch_size)
            rem -= self.batch_size
        if rem > 0:
            p = 1 << (rem.bit_length() - 1)  # pow2 floor
            if (p >= 2048 and rem > p
                    and p + self._bucket(rem - p) < self._bucket(rem)):
                out.append(p)
                rem -= p
            out.append(rem)
        return out

    def _ramp_buckets(self, start: int, n: int) -> list[int]:
        """The pow2 round-bucket family the build loop will touch."""
        out, pos = set(), start
        while pos < n:
            cur = min(self.batch_size, max(pos, 64))
            out.add(self._bucket(cur))
            pos += cur
        return sorted(out)

    # -- insert round --------------------------------------------------------

    def _round_dispatch(self, st: _DeviceAdj, live_dev, entry, batch,
                        vectors, simf, pq):
        """Device half of an insert round: beam search + round prune +
        forward-row apply + live mark, all dispatched without waiting on
        any result. Returns (pending, live_dev') where `pending` carries
        the DEVICE prune output for _round_finish.

        The forward rows land immediately, so the next round's search can
        be dispatched before this round's host bookkeeping runs — the
        pipelined build overlaps host work with device beam search.
        """
        # Pad the batch to a pow2 bucket so rounds hit a small family of
        # compiled programs (XLA retraces on shape changes) without paying
        # full-batch compute for tiny rounds.
        real_b = len(batch)
        bucket = self._bucket(real_b)
        padded = batch
        if real_b < bucket:
            padded = np.concatenate(
                [batch, np.full(bucket - real_b, batch[0], batch.dtype)]
            )
        import time as _time

        t0 = _time.time() if BUILD_PROFILE else 0.0
        batch_dev = jnp.asarray(padded, jnp.int32)
        queries = vectors[batch_dev]
        cand_ids, cand_scores = self._search_candidates(
            st.dev, live_dev, entry, vectors, queries, simf, pq
        )
        if BUILD_PROFILE:
            jax.block_until_ready(cand_ids)
            self.counters._phase("search", _time.time() - t0)
            t0 = _time.time()
        b = len(padded)
        top_r = min(b - 1, self.max_degree) if b > 1 else 0
        prune_fn = _make_round_prune_fn(
            simf.value, self.max_degree, top_r, self.alpha
        )
        sel_dev = prune_fn(batch_dev, cand_ids, cand_scores, vectors)
        # forward rows + live mark from the device output (padded
        # duplicates recompute identical rows — duplicate scatter writes
        # of identical content are well-defined)
        fwd = _make_fwd_apply_fn(st.cap_deg)
        st.dev, live_dev = fwd(st.dev, live_dev, batch_dev, sel_dev)
        if BUILD_PROFILE:
            jax.block_until_ready(st.dev)
            self.counters._phase("prune+fwd", _time.time() - t0)
        return (np.asarray(batch), sel_dev, real_b), live_dev

    def _round_finish(self, st: _DeviceAdj, pending, vectors, simf):
        """Host half of an insert round: fetch the prune output, compute
        reverse-edge slots, apply them, queue overflow prunes. While this
        runs, the device is (in the pipelined build) already executing the
        next round's beam search."""
        new_ids, sel_dev, real_b = pending
        import time as _time

        t0 = _time.time() if BUILD_PROFILE else 0.0
        sel = np.asarray(sel_dev)[:real_b]
        if BUILD_PROFILE:
            self.counters._phase("sel_fetch", _time.time() - t0)
            t0 = _time.time()
        st.deg[new_ids] = (sel >= 0).sum(axis=1)
        dst, slot, src, overflowed, extras = self._compute_back_edges(
            st.deg, new_ids, sel, self.overflow_degree
        )
        if BUILD_PROFILE:
            self.counters._phase("backedges_host", _time.time() - t0)
            t0 = _time.time()
        st.dev = self._apply_reverse(st, new_ids.size, dst, slot, src)
        if BUILD_PROFILE:
            jax.block_until_ready(st.dev)
            self.counters._phase("apply", _time.time() - t0)
            t0 = _time.time()
        self._prune_overflow(st, overflowed, vectors, simf, extras=extras)
        if BUILD_PROFILE:
            jax.block_until_ready(st.dev)
            self.counters._phase("overflow", _time.time() - t0)

    def _insert_round(self, st: _DeviceAdj, live_dev, entry, batch, vectors,
                      simf, pq):
        """Serial round (dispatch + finish back to back) — used by the
        prewarm threads and as the building block of the pipelined loops."""
        pending, live_dev = self._round_dispatch(
            st, live_dev, entry, batch, vectors, simf, pq
        )
        self._round_finish(st, pending, vectors, simf)
        return live_dev

    def _apply_reverse(self, st, n_new, dst, slot, src):
        """Reverse-edge scatter, padded to the round's bucketed width."""
        bucket = self._bucket(n_new)
        width = bucket * self.max_degree
        n_cap = st.dev.shape[0]
        dst_p = np.full(width, n_cap, np.int32)  # OOB -> dropped by scatter
        slot_p = np.zeros(width, np.int32)
        src_p = np.full(width, -1, np.int32)
        m = min(dst.size, width)
        dst_p[:m], slot_p[:m], src_p[:m] = dst[:m], slot[:m], src[:m]
        fn = _make_apply_reverse_fn()
        return fn(
            st.dev,
            jnp.asarray(dst_p),
            jnp.asarray(slot_p),
            jnp.asarray(src_p),
        )

    def _apply_edges(self, st, new_ids, sel, dst, slot, src):
        """Pad edge lists to a bucketed width and apply on device (bounded
        shape family, no per-round retrace)."""
        bucket = self._bucket(new_ids.size)
        width = bucket * self.max_degree
        n_cap = st.dev.shape[0]
        dst_p = np.full(width, n_cap, np.int32)  # OOB -> dropped by scatter
        slot_p = np.zeros(width, np.int32)
        src_p = np.full(width, -1, np.int32)
        m = min(dst.size, width)
        dst_p[:m], slot_p[:m], src_p[:m] = dst[:m], slot[:m], src[:m]
        # pad the row write to the bucket with duplicates (identical content
        # -> duplicate scatter indices are harmless)
        rows = st.pad_rows(sel)
        if new_ids.size < bucket:
            padn = bucket - new_ids.size
            new_ids = np.concatenate(
                [new_ids, np.full(padn, new_ids[0], new_ids.dtype)]
            )
            rows = np.concatenate([rows, np.repeat(rows[:1], padn, axis=0)])
        apply_fn = _make_apply_edges_fn()
        return apply_fn(
            st.dev,
            jnp.asarray(new_ids, jnp.int32),
            jnp.asarray(rows),
            jnp.asarray(dst_p),
            jnp.asarray(slot_p),
            jnp.asarray(src_p),
        )

    # -- public API --------------------------------------------------------

    def build(
        self,
        vectors: jax.Array,  # [N, d]
        simf: SimilarityFunction,
        pq: dict | None = None,  # quantized-construction score source
        capacity: int | None = None,
    ) -> VamanaGraph:
        """Fresh Vamana build over `vectors` (insertion in shuffled rounds).

        `capacity` (>= n) is rounded up to a pow2 bucket so graphs of any
        corpus size share XLA program families (each distinct capacity is a
        full retrace of the search/prune programs — seconds per shape).
        """
        n = int(vectors.shape[0])
        cap_deg = self.overflow_degree
        if n == 0:
            return VamanaGraph.empty(capacity or 0, cap_deg)
        capacity = bucket_capacity(max(capacity or 0, n))
        vectors = pad_rows(_as_build_rows(vectors), capacity)
        pq = self._pad_pq(pq, capacity)
        if pq is None and self.score_dtype == "bf16":
            # construction-only approximate score source: beam candidates
            # gather from a bf16 corpus copy (same einsum path as the
            # decoded-PQ ADC tier); round prune re-scores selected edges
            # in fp32, so edge choices keep full precision
            pq = {"decoded": vectors.astype(jnp.bfloat16)}

        st = _DeviceAdj(
            jnp.full((capacity, cap_deg), -1, jnp.int32),
            np.zeros((capacity,), np.int32),
        )
        live = np.zeros((capacity,), bool)
        live_dev = jnp.zeros((capacity,), bool)
        self._has_tombstones = False

        # entry point: medoid approximation = nearest to the mean (pad rows
        # beyond n are zeros — exclude them from both mean and argmax).
        # f32 accumulation: a multi-million-row mean in bf16 is garbage
        mean = jnp.mean(vectors[:n].astype(jnp.float32), axis=0,
                        keepdims=True)
        escores = pairwise_scores(mean, vectors, simf)[0]
        escores = jnp.where(jnp.arange(capacity) < n, escores, NEG_INF)
        entry = int(jnp.argmax(escores))

        rng = np.random.default_rng(self.seed)
        order = rng.permutation(n)
        # The entry medoid MUST be in the bootstrap block: every round's beam
        # search starts at `entry`, so if it isn't live from round 0 the
        # early inserts can only link to each other and the bootstrap
        # component ends up disconnected.
        mpos = int(np.nonzero(order == entry)[0][0])
        order[[0, mpos]] = order[[mpos, 0]]
        # bootstrap block: all-pairs + prune (no graph to search yet).
        # 1024 (not 64): every pow2 ramp round below batch_size is its own
        # compiled program family, and on big builds those compiles cost
        # more than the bootstrap's O(b0^2) scoring — starting the ramp at
        # 1024 leaves at most ceil(log2(batch_size/1024))+1 round families.
        b0 = min(n, max(self.max_degree + 1, min(1024, self.batch_size)))
        boot = order[:b0]
        self._bootstrap(st, boot, vectors, simf)
        live[boot] = True
        live_dev = live_dev.at[jnp.asarray(boot)].set(True)

        # Ramp the round size with graph size: inserting a huge batch into a
        # tiny graph yields poor search candidates (the batch outnumbers the
        # graph), so cap each round at the current graph size (doubling).
        self._prewarm_programs(
            st, live_dev, entry, vectors, simf, pq,
            self._ramp_buckets(b0, n),
        )
        # Pipelined insert loop: dispatch round k's device work (search +
        # prune + forward rows), THEN finish round k-1 on the host (fetch
        # prune output, reverse-edge slots, overflow prunes) while the
        # device executes round k's beam search. Reverse edges therefore
        # land one round late — round k's search cannot reach round k-1's
        # nodes (equivalent in effect to one double-width round; measured
        # recall-neutral, see docs/design.md) — and the host bookkeeping
        # cost disappears from the critical path.
        pos = b0
        pending = None
        while pos < n:
            cur = min(self.batch_size, max(pos, 64))
            batch = order[pos : pos + cur]
            nxt, live_dev = self._round_dispatch(
                st, live_dev, entry, batch, vectors, simf, pq
            )
            live[batch] = True
            if pending is not None:
                self._round_finish(st, pending, vectors, simf)
            pending = nxt
            pos += len(batch)
            self.counters.rounds += 1
        if pending is not None:
            self._round_finish(st, pending, vectors, simf)

        self.counters.nodes_inserted += n
        graph = VamanaGraph(
            adjacency=st.dev,
            degrees=jnp.asarray(st.deg),
            live=jnp.asarray(live),
            entry=jnp.int32(entry),
        )
        if self.refine_passes > 0:
            graph = self.refine_graph(
                graph, vectors, simf, pq, passes=self.refine_passes
            )
        return self.cleanup(graph, vectors, simf)

    def refine_graph(
        self,
        graph: VamanaGraph,
        vectors: jax.Array,
        simf: SimilarityFunction,
        pq: dict | None = None,
        passes: int = 1,
    ) -> VamanaGraph:
        """Second-pass refinement (DiskANN's two-pass build): re-search every
        node over the finished graph and re-prune its list from (current
        neighbors ∪ fresh beam candidates), then re-apply back edges."""
        st = _DeviceAdj(graph.adjacency, np.asarray(graph.degrees).copy())
        live = np.asarray(graph.live)
        live_dev = graph.live
        entry = int(graph.entry)
        vectors = pad_rows(_as_build_rows(vectors), graph.capacity)
        pq = self._pad_pq(pq, graph.capacity)
        ids_all = np.nonzero(live)[0]
        rng = np.random.default_rng(self.seed + 1)
        for _ in range(passes):
            order = rng.permutation(ids_all)
            for s in range(0, order.size, self.batch_size):
                batch = order[s : s + self.batch_size]
                real_b = batch.size
                bucket = self._bucket(real_b)
                if real_b < bucket:
                    batch = np.concatenate(
                        [batch,
                         np.full(bucket - real_b, batch[0], batch.dtype)]
                    )
                batch_dev = jnp.asarray(batch, jnp.int32)
                queries = vectors[batch_dev]
                cand_ids, _ = self._search_candidates(
                    st.dev, live_dev, entry, vectors, queries, simf, pq
                )
                # candidates = fresh beam results ∪ current neighbor list
                fn = _make_overflow_prune_fn(
                    simf.value, self.max_degree, self.alpha
                )
                # reuse the overflow program: extras = beam candidates
                pad_w = 2 * self.max_degree
                extras = np.asarray(cand_ids)[:, :pad_w].astype(np.int32)
                if extras.shape[1] < pad_w:
                    extras = np.pad(extras, ((0, 0),
                                             (0, pad_w - extras.shape[1])),
                                    constant_values=-1)
                sel, st.dev = fn(batch_dev, st.dev, jnp.asarray(extras),
                                 vectors)
                sel = np.asarray(sel)[:real_b]
                new_ids = batch[:real_b]
                st.deg[new_ids] = (sel >= 0).sum(axis=1)
                dst, slot, src, overflowed, extras2 = self._compute_back_edges(
                    st.deg, new_ids, sel, self.overflow_degree
                )
                st.dev = self._apply_edges(st, new_ids, sel, dst, slot, src)
                self._prune_overflow(st, overflowed, vectors, simf,
                                     extras=extras2)
        return VamanaGraph(
            adjacency=st.dev,
            degrees=jnp.asarray(st.deg),
            live=graph.live,
            entry=graph.entry,
        )

    def _bootstrap(self, st: _DeviceAdj, ids, vectors, simf):
        if len(ids) < 2:  # a single node has no candidates to prune
            return
        real = len(ids)
        # pad to a pow2 bucket (duplicates of ids[0]: identical rows, so the
        # duplicate-scatter write order cannot matter) — the bootstrap size
        # tracks corpus size below 1024 and would otherwise compile per n.
        # NOT self._bucket: that caps at batch_size, and the bootstrap block
        # (>= max_degree+1) may legitimately exceed a small batch_size.
        bucket = bucket_capacity(real)
        ids_p = np.pad(np.asarray(ids), (0, bucket - real),
                       constant_values=ids[0])
        v = vectors[jnp.asarray(ids_p)].astype(jnp.float32)
        scores = pairwise_scores(v, v, simf)
        scores = jnp.where(jnp.eye(bucket, dtype=bool), NEG_INF, scores)
        # mask the pad COLUMNS too: 'bucket - real' duplicates of ids[0]
        # would otherwise crowd real candidates out of the top-k before
        # robust_prune's id-dedupe runs (low-diversity graphs for every
        # non-pow2 bootstrap block)
        col_real = jnp.asarray(np.arange(bucket) < real)
        scores = jnp.where(col_real[None, :], scores, NEG_INF)
        cand_scores, idx = jax.lax.top_k(
            scores, min(bucket - 1, self.beam_width)
        )
        cand_ids = jnp.asarray(ids_p, jnp.int32)[idx]
        cand_vecs = v[idx]
        sel = np.asarray(
            robust_prune_batch(
                v, cand_ids, cand_vecs, cand_scores,
                self.alpha, self.max_degree, simf.value,
                point_ids=jnp.asarray(ids_p, jnp.int32),
            )
        )[:real]
        ids = np.asarray(ids)
        st.deg[ids] = (sel >= 0).sum(axis=1)
        # reverse edges, exactly like an insert round (addGraphNode adds
        # bidirectional links): a forward-only kNN bootstrap leaves
        # multi-cluster corpora as one-way islands — nodes whose prune
        # keeps intra-cluster edges only are unreachable from the entry
        # until orphan repair, and repair should be the backstop, not the
        # routine connectivity mechanism.
        dst, slot, src, overflowed, extras = self._compute_back_edges(
            st.deg, ids, sel, self.overflow_degree
        )
        st.dev = self._apply_edges(st, ids, sel, dst, slot, src)
        self._prune_overflow(st, overflowed, vectors, simf, extras=extras)

    def add_nodes(
        self,
        graph: VamanaGraph,
        vectors: jax.Array,  # full vector storage covering new ids
        new_ids: np.ndarray,
        simf: SimilarityFunction,
        pq: dict | None = None,
    ) -> VamanaGraph:
        """Delta-insert `new_ids` into an existing graph (incremental merge).

        Mirrors the reference's parallel addGraphNode append into a loaded
        graph (JVectorWriter.java:1313-1319).
        """
        st = _DeviceAdj(graph.adjacency, np.asarray(graph.degrees).copy())
        live = np.asarray(graph.live).copy()
        live_dev = graph.live
        entry = int(graph.entry)
        vectors = pad_rows(_as_build_rows(vectors), graph.capacity)
        pq = self._pad_pq(pq, graph.capacity)
        if pq is None and self.score_dtype == "bf16":
            pq = {"decoded": vectors.astype(jnp.bfloat16)}
        # deleted nodes referenced by the loaded adjacency must be masked out
        # of candidate pools during delta inserts. Computed on device (one
        # scalar readback) — downloading the full adjacency over the host
        # link costs more than several insert rounds.
        adj_dev = graph.adjacency
        ref_ok = jnp.all(
            jnp.where(adj_dev >= 0, graph.live[jnp.clip(adj_dev, 0)], True)
        )
        self._has_tombstones = not bool(ref_ok)

        chunks = self._delta_chunks(len(new_ids))
        self._prewarm_programs(
            st, live_dev, entry, vectors, simf, pq,
            [self._bucket(c) for c in chunks],
        )
        # same pipelined dispatch/finish overlap as build()
        s = 0
        pending = None
        for c in chunks:
            batch = np.asarray(new_ids[s : s + c])
            s += c
            nxt, live_dev = self._round_dispatch(
                st, live_dev, entry, batch, vectors, simf, pq
            )
            live[batch] = True
            if pending is not None:
                self._round_finish(st, pending, vectors, simf)
            pending = nxt
            self.counters.rounds += 1
        if pending is not None:
            self._round_finish(st, pending, vectors, simf)
        self.counters.nodes_inserted += len(new_ids)

        return VamanaGraph(
            adjacency=st.dev,
            degrees=jnp.asarray(st.deg),
            live=jnp.asarray(live),
            entry=jnp.int32(entry),
        )

    @staticmethod
    def mark_deleted(graph: VamanaGraph, ids: np.ndarray) -> VamanaGraph:
        """Tombstone nodes (folded in at cleanup; markNodeDeleted parity)."""
        live = np.asarray(graph.live).copy()
        live[ids] = False
        return dataclasses.replace(graph, live=jnp.asarray(live))

    def cleanup(
        self, graph: VamanaGraph, vectors: jax.Array, simf: SimilarityFunction
    ) -> VamanaGraph:
        """Fold deletes in and enforce the degree bound (cleanup() parity).

        Dead neighbors are replaced by their own live neighbors (2-hop edge
        repair), then every touched/overflowing node is re-pruned to
        max_degree.
        """
        import time as _time

        t0 = _time.time() if BUILD_PROFILE else 0.0
        st = _DeviceAdj(graph.adjacency, np.asarray(graph.degrees).copy())
        live = np.asarray(graph.live)
        live_dev = jnp.asarray(live)
        vectors = pad_rows(_as_build_rows(vectors), graph.capacity)

        # dead-neighbor scan ON DEVICE: only the [capacity] bool row mask
        # crosses the host link (the full-adjacency fetch this replaces was
        # 20MB at 100k and the top fixed cost of tombstone-free cleanups)
        has_dead = np.asarray(_make_dead_scan_fn()(st.dev, live_dev))
        dead_nodes = np.nonzero(has_dead & live)[0]
        if BUILD_PROFILE:
            self.counters._phase("cleanup_fetch", _time.time() - t0)
            t0 = _time.time()
        if dead_nodes.size:
            fn = _make_splice_prune_fn(simf.value, self.max_degree, self.alpha)
            for s in range(0, dead_nodes.size, self.batch_size):
                ids = dead_nodes[s : s + self.batch_size]
                pad = self._bucket(ids.size) - ids.size
                ids = np.pad(ids, (0, pad), constant_values=ids[0])
                sel, st.dev = fn(
                    jnp.asarray(ids, jnp.int32), st.dev, live_dev, vectors
                )
                sel = np.asarray(sel)
                st.deg[ids] = (sel >= 0).sum(axis=1)

        if BUILD_PROFILE:
            jax.block_until_ready(st.dev)
            self.counters._phase("cleanup_splice", _time.time() - t0)
            t0 = _time.time()
        over = np.nonzero(st.deg > self.max_degree)[0]
        self._prune_overflow(st, over, vectors, simf)
        if BUILD_PROFILE:
            jax.block_until_ready(st.dev)
            self.counters._phase("cleanup_overflow", _time.time() - t0)
            t0 = _time.time()

        # entry repair: if the entry died, pick the live node closest to mean
        # (mask-based: full-capacity shapes only, no data-dependent compiles)
        entry = int(graph.entry)
        if not live[entry] and live.any():
            live_j = jnp.asarray(live)
            lm = live_j[:, None].astype(jnp.float32)
            mean = jnp.sum(vectors * lm, axis=0, keepdims=True) / jnp.maximum(
                jnp.sum(lm), 1.0
            )
            s = pairwise_scores(mean, vectors, simf)[0]
            s = jnp.where(live_j, s, NEG_INF)
            entry = int(jnp.argmax(s))

        # reachability repair: overflow pruning can drop a node's only
        # in-path, leaving it unreachable from the entry (observed ~3% of
        # nodes on small builds — a hard recall cap). Link every live node
        # not reachable from the entry from its nearest reachable neighbor.
        # Overwrites on full hosts can re-orphan an ex-neighbor, so iterate
        # (converges immediately in practice; 3 passes is a safety bound).
        if live.any():
            for _ in range(3):
                if self._repair_orphans(st, live, vectors, simf, entry) == 0:
                    break
        if BUILD_PROFILE:
            jax.block_until_ready(st.dev)
            self.counters._phase("cleanup_orphans", _time.time() - t0)

        upper = None
        if self.hierarchy_enabled:
            upper = self._build_upper_layer(vectors, live, entry, simf)

        return VamanaGraph(
            adjacency=st.dev,
            degrees=jnp.asarray(st.deg),
            live=jnp.asarray(live),
            entry=jnp.int32(entry),
            upper_adjacency=upper,
        )

    def _repair_orphans(self, st: _DeviceAdj, live, vectors, simf,
                        entry) -> int:
        """Link live nodes unreachable from `entry` from their nearest
        reachable neighbor (device BFS + batched scoring). Returns the
        number of orphans repaired."""
        if not live[entry]:
            return 0
        import jax.numpy as jnp_

        live_d = jnp_.asarray(live)
        reach = np.asarray(
            _make_reachability_fn()(st.dev, live_d, jnp_.int32(entry))
        )
        orphans = np.nonzero(live & ~reach)[0]
        if orphans.size == 0:
            return 0

        hostable_dev = jnp_.asarray(live & reach)
        host_of: dict[int, list[int]] = {}  # host -> its orphan group
        for s in range(0, orphans.size, 512):
            ob = orphans[s : s + 512]
            real = ob.size
            # pad every chunk to the SAME 512 width: a distinct chunk shape
            # is a fresh XLA compile (remote compiles cost ~15s each; the
            # old pow2-of-real padding compiled one program per orphan-count
            # bucket, 26-92s of cold cleanup at 100k). Pad ids repeat ob[0]
            # — duplicate (host, orphan) pairs are dropped below.
            if real < 512:
                ob = np.pad(ob, (0, 512 - real), constant_values=ob[0])
            # argmax ON DEVICE (only the host ids come back), scanned in
            # corpus blocks: one [chunk, capacity] pass is 8.6GB at 4M
            # capacity — see _nearest_hostable
            hosts = np.asarray(_nearest_hostable(
                jnp_.asarray(ob), vectors, hostable_dev, simf
            ))[:real]
            ob = ob[:real]
            for h, o in zip(hosts, ob):
                group = host_of.setdefault(int(h), [])
                if int(o) not in group:
                    group.append(int(o))

        # fetch ONLY the rows the chained linking can touch (hosts +
        # orphans) — the full-adjacency host fetch this replaces was 20MB
        # per repair pass at 100k
        need = np.unique(np.concatenate(
            [np.fromiter(host_of.keys(), np.int64, len(host_of)), orphans]
        )).astype(np.int64)
        row_of: dict[int, np.ndarray] = {}
        for s in range(0, need.size, 512):
            nb_ids = need[s : s + 512]
            real = nb_ids.size
            if real < 512:  # fixed gather shape: one compiled program
                nb_ids = np.pad(nb_ids, (0, 512 - real),
                                constant_values=nb_ids[0])
            got = st.rows(nb_ids)[:real]
            for i, n in enumerate(need[s : s + 512]):
                row_of[int(n)] = got[i]
        touched: dict[int, np.ndarray] = {}

        def _row(nid: int) -> np.ndarray:
            row = touched.get(nid)
            if row is None:
                row = row_of[nid].copy()
                touched[nid] = row
            return row

        def _link(src: int, dst: int) -> None:
            """One edge src -> dst: append below max_degree, else overwrite
            the tail slot (a single eviction per src)."""
            row = _row(src)
            if dst in row:
                return
            if st.deg[src] < self.max_degree:
                slot = int(st.deg[src])
                st.deg[src] += 1
            else:
                slot = self.max_degree - 1
            row[slot] = dst

        # CHAIN each host's orphan group: host -> o1 -> o2 -> ... . A whole
        # unreachable island maps its orphans onto the same (nearest)
        # boundary host; writing them all into the host's max_degree row
        # would thrash it — later writes evict earlier repairs AND the
        # host's own edges, disconnecting what was reachable (observed:
        # multi-cluster corpora lost the entry's own cluster to this).
        # Chaining costs the host ONE slot and each orphan at most one
        # tail-slot eviction of its own (still-intact) row, and makes the
        # whole group reachable through the chain.
        for h, group in host_of.items():
            _link(h, group[0])
            for prev, nxt in zip(group, group[1:]):
                _link(prev, nxt)
        if touched:
            hid = np.fromiter(touched.keys(), np.int32, len(touched))
            hrows = np.stack([touched[int(h)] for h in hid])
            st.dev = st.dev.at[jnp_.asarray(hid)].set(jnp_.asarray(hrows))
        return int(orphans.size)

    def _build_upper_layer(self, vectors, live, entry, simf):
        """Coarse hierarchy layer (hierarchy_enabled parity, HNSW-style).

        A Vamana graph over a ~4*sqrt(n) sample (entry included), expressed
        in the BASE ordinal space as a sparse full-height adjacency so the
        same score providers drive both layers. Rebuilt at cleanup — it is
        orders of magnitude smaller than the base layer.
        """
        live_ids = np.nonzero(np.asarray(live))[0]
        n = live_ids.size
        if n < 8:
            return None
        rng = np.random.default_rng(self.seed + 7)
        s_size = min(n, max(64, int(4 * np.sqrt(n))))
        members = rng.choice(live_ids, s_size, replace=False)
        if entry not in members:
            members[0] = entry
        members = np.unique(members)
        m_up = min(16, self.max_degree)
        sub = GraphIndexBuilder(
            dim=self.dim, max_degree=m_up, beam_width=64,
            alpha=self.alpha, batch_size=min(self.batch_size, 1024),
            seed=self.seed + 11,
        )
        sub_graph = sub.build(vectors[jnp.asarray(members)], simf)
        # the sub-build pads to its own capacity bucket; only the first
        # len(members) rows are real nodes
        local = np.asarray(sub_graph.adjacency)[: members.size, :m_up]
        translated = np.where(local >= 0, members[np.clip(local, 0, None)], -1)
        capacity = live.shape[0]
        upper = np.full((capacity, m_up), -1, np.int32)
        upper[members] = translated
        return jnp.asarray(upper)
