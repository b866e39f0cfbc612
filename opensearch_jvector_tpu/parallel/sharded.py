"""Mesh-sharded distributed search (corpus data-parallelism over devices).

Device replacement for OpenSearch's shard-level scatter-gather (SURVEY.md
§2.5: the reference delegates multi-node search fan-out + top-k merge to
OpenSearch core over the transport layer). Here each mesh device owns one
corpus shard (its own sub-graph + vectors/codes); queries are replicated;
every device runs the same beam-search program on its shard; the per-shard
top-k lists cross the device interconnect (NVLink between GPUs of one host)
in one all-gather, followed by a replicated global top-k merge.

Layout convention: shard-stacked arrays with a leading `shard` axis —
  adjacency [D, n, M], live [D, n], entries [D], vectors [D, n, d], ...
Global ordinals are `shard_idx * n + local_ordinal`.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from opensearch_jvector_tpu.models import searcher as searcher_mod
from opensearch_jvector_tpu.models.searcher import SearchParams
from opensearch_jvector_tpu.ops.distances import (
    SimilarityFunction,
    batched_candidate_scores,
)
from opensearch_jvector_tpu.ops.topk import topk_scores

AXIS = "shard"


def make_mesh(devices=None) -> Mesh:
    """1-D corpus-sharding mesh over all (or given) devices. Flat, because
    every GPU of one host reaches every other at the same NVLink rate."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices).reshape(-1), (AXIS,))


def mesh_size(mesh: Mesh) -> int:
    return int(np.prod(mesh.devices.shape))


# ---------------------------------------------------------------------------
# Full-engine sharded search: each mesh device runs the COMPLETE two-phase
# segment search (PQ/ADC approximate phase + exact rerank + accept/tombstone
# masking + ordinal->doc mapping) over its shard's segment — the per-shard
# search is the full search, exactly like OpenSearch's shard scatter-gather
# where every shard is a whole index (SURVEY.md §2.5,
# KNNStatsTransportAction.java:28). Only the [Q, k] doc-id/score lists and
# the per-shard counters cross the interconnect (one all_gather each).
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ShardedEngineState:
    """Shard-stacked device arrays for the full-engine mesh search.

    All arrays carry a leading shard axis D and a segment axis G (shards
    are whole indexes, exactly like OpenSearch shards — a shard may hold
    several segments; each device searches its segments via vmap and
    merges locally before the cross-shard merge). Shards with fewer than G
    segments are padded with empty slots (live=False / doc=-1). Segments
    are padded to a common capacity `n`. `pq_*` are None for fp32-exact
    shards; doc ids are shard-global (no rebasing needed).
    """

    adjacency: jax.Array  # [D, G, n, M] int32
    live: jax.Array  # [D, G, n] bool
    entries: jax.Array  # [D, G] int32
    ord_to_doc: jax.Array  # [D, G, n] int32 (-1 = hole/deleted)
    vectors: jax.Array  # [D, G, n, d] f32 (rerank + exact source;
    #                     dummy [D, G, 1, d] for NVQ shards — rerank
    #                     decodes NVQ rows instead)
    pq_codes: jax.Array | None = None  # [D, G, n, Msub] int32
    pq_codebooks: jax.Array | None = None  # [D, G, Msub, K, dsub] f32
    pq_center: jax.Array | None = None  # [D, G, d] f32
    # NVQ shards ("nvq+pq"): the beam rides the aux PQ above; rerank
    # decodes these inline codes (reference: NVQ rerank-only provider,
    # JVectorReader.java:353-366)
    nvq_bytes: jax.Array | None = None  # [D, G, n, d] u8
    nvq_params: jax.Array | None = None  # [D, G, n, Mn, 4] f32
    nvq_mean: jax.Array | None = None  # [D, G, d] f32
    # scalar (1/2/4-bit) shards: Hamming approximate phase over bit-packed
    # codes + fp32 rerank (same composition as the host searcher)
    scalar_codes: jax.Array | None = None  # [D, G, n, B] u8 bit-packed
    scalar_thresholds: jax.Array | None = None  # [D, G, levels, d] f32
    # on_disk shards (fp32 rows in the per-segment host store): the mesh
    # runs the PQ approximate phase only and returns candidate locators;
    # the caller pages rows and reranks in one batched device program
    # (BASELINE config 5: larger-than-memory sharded over the mesh)
    approx_only: bool = False

    @property
    def n_shards(self) -> int:
        return self.adjacency.shape[0]

    @property
    def n_segments(self) -> int:
        return self.adjacency.shape[1]

    @property
    def n_local(self) -> int:
        return self.adjacency.shape[2]

    @property
    def use_pq(self) -> bool:
        return self.pq_codes is not None

    @property
    def use_nvq(self) -> bool:
        return self.nvq_bytes is not None

    @property
    def use_scalar(self) -> bool:
        return self.scalar_codes is not None


def homogenize_pq(shard_lists, similarity, cache=None):
    """Make a PQ/fp32-mixed segment set mesh-stackable.

    The min-batch quantization policy (JVectorWriter.quantizeForFlush:
    263-283) leaves small fresh flushes fp32 next to PQ segments — the
    most common steady-state mix. Rather than dropping the whole index to
    the host loop, encode the fp32 segments' rows with a donor segment's
    codebooks (largest PQ segment): the beam rides ADC codes uniformly
    and the rerank still reads the exact fp32 rows. Segments are
    immutable, so `cache` (name -> synthetic PQVectors) avoids
    re-encoding on every restack.

    Returns shard_lists (with synthetic-pqv replacements), or the input
    unchanged when no mixing (or a non-PQ mix) is present.
    """
    import dataclasses as _dc

    from opensearch_jvector_tpu.models import pq as pq_mod

    import jax.numpy as _jnp

    from opensearch_jvector_tpu.models.graph import pad_rows as _pad_rows

    all_segs = [s for lst in shard_lists for s in lst]
    have = [s for s in all_segs if s.pqv is not None]
    need = [s for s in all_segs if s.pqv is None]
    if not have or not need:
        return shard_lists  # already uniform (all fp32 or all PQ)
    for s in need:
        if (s.nvq is not None or s.scalar_codes is not None
                or s.config.index_type == "flat"
                or (s.vectors is None and s.row_store is None)):
            return shard_lists  # other mixes: host loop handles them
    donor = max(have, key=lambda s: s.docmap.num_ordinals).pqv.pq
    cache = cache if cache is not None else {}
    out = []
    for shard_idx, lst in enumerate(shard_lists):
        row = []
        for s in lst:
            if s.pqv is None:
                # cache key MUST include the shard: segment names repeat
                # across shards (each shard numbers its own segments)
                key = (shard_idx, s.name)
                pqv = cache.get(key)
                if pqv is None:
                    if s.vectors is not None:
                        rows = s.vectors  # [capacity, d]
                    else:  # on_disk small flush: page its rows once
                        import numpy as _np

                        rows = _pad_rows(
                            _jnp.asarray(s.row_store.gather(
                                _np.arange(s.row_store.num_rows))),
                            s.capacity(),
                        )
                    # encode the FULL capacity-padded row array (segment
                    # codes cover the capacity bucket; padding rows are
                    # live=False so their garbage codes are never scored)
                    codes = pq_mod.encode(donor, rows, similarity)
                    pqv = pq_mod.PQVectors(pq=donor, codes=codes)
                    cache[key] = pqv
                s = _dc.replace(s, pqv=pqv)
            row.append(s)
        out.append(row)
    return out


def stack_engine_state(segments, mesh: Mesh | None = None
                       ) -> ShardedEngineState:
    """Stack per-shard segment lists into mesh-ready [D, G, ...] arrays.

    With `mesh`, every array is placed shard-per-device (leading axis split
    over the mesh) once here, so searches never move corpus state between
    devices; without it the arrays land on the default device.

    `segments`: one Segment per shard, or a list of Segments per shard
    (multi-segment shards — steady-state ingest with un-merged flushes).

    Requirements (caller falls back to the host scatter-gather otherwise):
    uniformly quantized segments — all-fp32, all-PQ (identical codebook
    shapes), or all-NVQ (aux-PQ beam + NVQ-decoded rerank; identical
    subvector counts) — with a graph to beam on (no flat segments). Doc
    ids must fit int32 (device-side mapping). on_disk (row-store) segments
    stack as approx_only states: codes/graph on device, rows stay in the
    host store, and the caller must use sharded_engine_search_approx plus
    its own paged rerank.
    """
    shard_lists, mode = _stack_mode(segments)
    grids = [_shard_grid(lst, mode) for lst in shard_lists]
    stacked = {k: np.stack([g[k] for g in grids])
               for k in grids[0] if grids[0][k] is not None}
    use_pq, use_nvq = mode["use_pq"], mode["use_nvq"]
    use_scalar = mode["use_scalar"]
    if mesh is not None:
        from opensearch_jvector_tpu.utils.circuit_breaker import BREAKER

        per_device = sum(x.nbytes for x in stacked.values()) // len(grids)
        for dev in mesh.devices.flat:
            BREAKER.check(per_device, device=dev)
        spec = NamedSharding(mesh, P(AXIS))

        def put(x):
            return jax.device_put(x, spec)
    else:
        put = jnp.asarray
    return ShardedEngineState(
        adjacency=put(stacked["adj"]),
        live=put(stacked["live"]),
        entries=put(stacked["ent"]),
        ord_to_doc=put(stacked["o2d"]),
        vectors=put(stacked["v"]),
        pq_codes=put(stacked["codes"]) if use_pq else None,
        pq_codebooks=put(stacked["books"]) if use_pq else None,
        pq_center=put(stacked["center"]) if use_pq else None,
        nvq_bytes=put(stacked["nvq_b"]) if use_nvq else None,
        nvq_params=put(stacked["nvq_p"]) if use_nvq else None,
        nvq_mean=put(stacked["nvq_m"]) if use_nvq else None,
        scalar_codes=put(stacked["sc_c"]) if use_scalar else None,
        scalar_thresholds=(put(stacked["sc_t"]) if use_scalar else None),
        approx_only=mode["use_disk"],
    )


def _stack_mode(segments):
    """Validate segment lists and compute the stacked-shape parameters."""
    if segments and not isinstance(segments[0], (list, tuple)):
        shard_lists = [[s] for s in segments]
    else:
        shard_lists = [list(x) for x in segments]
    all_segs = [s for lst in shard_lists for s in lst]
    if not all_segs:
        raise ValueError("mesh path requires at least one segment")
    g_max = max(len(lst) for lst in shard_lists)
    n = max(s.capacity() for s in all_segs)
    use_pq = all_segs[0].pqv is not None
    use_nvq = all_segs[0].nvq is not None
    use_scalar = all_segs[0].scalar_codes is not None
    # on_disk shards: rows live in the host store, so the mesh runs the PQ
    # approximate phase only (approx_only) and the caller pages + reranks.
    # ANY row-store segment switches the whole state to approx_only; small
    # below-min-batch flushes keep fp32 in memory (vectors) and their rows
    # are paged from that copy instead.
    use_disk = any(s.row_store is not None for s in all_segs)
    for s in all_segs:
        if use_disk and s.row_store is None and s.vectors is None:
            raise ValueError("mesh path requires a row source per segment")
        if s.config.index_type == "flat":
            raise ValueError(
                "flat segments have no graph to beam on the mesh"
            )
        if (s.scalar_codes is not None) != use_scalar:
            raise ValueError("mesh path requires uniform quantization")
        if (s.nvq is not None) != use_nvq:
            raise ValueError("mesh path requires uniform quantization")
        if not use_nvq and not use_disk and s.vectors is None:
            raise ValueError("mesh path requires device-resident fp32 rows")
        if (s.pqv is not None) != use_pq:
            raise ValueError("mesh path requires uniform quantization")
    if use_disk and (not use_pq or use_nvq or use_scalar):
        raise ValueError(
            "on_disk mesh shards require the PQ beam (codes in HBM)"
        )
    if use_disk and len(shard_lists) * g_max * n > np.iinfo(np.int32).max:
        raise ValueError(
            "on_disk mesh locator space exceeds int32; host fallback"
        )
    sc_shapes = None
    if use_scalar:
        shapes = {
            (tuple(np.asarray(s.scalar_state.thresholds).shape),
             int(np.asarray(s.scalar_codes).shape[1]))
            for s in all_segs
        }
        if len(shapes) != 1:
            raise ValueError("mesh path requires identical scalar shapes")
        sc_shapes = next(iter(shapes))  # (thresholds shape, code width B)
    cb_shape = None
    if use_nvq:
        if not use_pq:
            raise ValueError("NVQ segments must carry an aux PQ (nvq+pq)")
        nsubs = {int(np.asarray(s.nvq.params).shape[1]) for s in all_segs}
        if len(nsubs) != 1:
            raise ValueError("mesh path requires identical NVQ subvectors")
    if use_pq:
        shapes = {tuple(np.asarray(s.pqv.pq.codebooks).shape)
                  for s in all_segs}
        if len(shapes) != 1:
            raise ValueError("mesh path requires identical codebook shapes")
        cb_shape = next(iter(shapes))
    mode = dict(
        g_max=g_max, n=n, use_pq=use_pq, use_nvq=use_nvq, cb_shape=cb_shape,
        use_scalar=use_scalar, sc_shapes=sc_shapes, use_disk=use_disk,
        dim=all_segs[0].config.dim,
        m_deg=np.asarray(all_segs[0].graph.adjacency).shape[1],
        nvq_nsub=(int(np.asarray(all_segs[0].nvq.params).shape[1])
                  if use_nvq else 0),
    )
    return shard_lists, mode


def _shard_grid(lst, mode):
    """Stack ONE shard's segments (+ empty pad slots) -> dict of np arrays
    with a leading [G] axis (keys match ShardedEngineState fields)."""
    n, g_max = mode["n"], mode["g_max"]
    use_pq, use_nvq = mode["use_pq"], mode["use_nvq"]
    dim, m_deg = mode["dim"], mode["m_deg"]

    def seg_rows(s):
        cap = s.capacity()
        pad = n - cap
        adj = np.asarray(s.graph.adjacency)
        adj = np.pad(adj, ((0, pad), (0, 0)), constant_values=-1) if pad \
            else adj
        live = np.asarray(s.graph.live)
        live = np.pad(live, (0, pad)) if pad else live
        o2d = np.asarray(s.docmap.ord_to_doc)
        if o2d.size and o2d.max(initial=-1) > np.iinfo(np.int32).max:
            raise ValueError("doc ids exceed int32 (mesh path)")
        o2d = o2d.astype(np.int32)
        # the docmap covers used ordinals only (< capacity bucket): pad
        # from its OWN length to the common width
        dpad = n - o2d.shape[0]
        o2d = np.pad(o2d, (0, dpad), constant_values=-1) if dpad else o2d
        if use_nvq or mode["use_disk"]:
            # dummy fp32 row (NVQ rerank decodes codes; on_disk reranks
            # host-paged rows outside the mesh program)
            v = np.zeros((1, dim), np.float32)
            if use_nvq:
                nb = np.asarray(s.nvq.bytes_, np.uint8)
                npar = np.asarray(s.nvq.params, np.float32)
                if pad:
                    nb = np.pad(nb, ((0, pad), (0, 0)))
                    npar = np.pad(npar, ((0, pad), (0, 0), (0, 0)))
        else:
            v = np.asarray(s.vectors, np.float32)
            v = np.pad(v, ((0, pad), (0, 0))) if pad else v
        row = dict(adj=adj, live=live, ent=int(s.graph.entry), o2d=o2d, v=v)
        if use_nvq:
            row["nvq_b"] = nb
            row["nvq_p"] = npar
            row["nvq_m"] = np.asarray(s.nvq.global_mean, np.float32)
        if use_pq:
            c = np.asarray(s.pqv.codes, np.int32)
            row["codes"] = np.pad(c, ((0, pad), (0, 0))) if pad else c
            row["books"] = np.asarray(s.pqv.pq.codebooks, np.float32)
            row["center"] = np.asarray(s.pqv.pq.center, np.float32)
        if mode["use_scalar"]:
            sc = np.asarray(s.scalar_codes, np.uint8)
            row["sc_c"] = np.pad(sc, ((0, pad), (0, 0))) if pad else sc
            row["sc_t"] = np.asarray(s.scalar_state.thresholds, np.float32)
        return row

    def empty_row():
        row = dict(
            adj=np.full((n, m_deg), -1, np.int32),
            live=np.zeros((n,), bool),
            ent=0,
            o2d=np.full((n,), -1, np.int32),
            v=np.zeros(
                (1, dim) if (use_nvq or mode["use_disk"]) else (n, dim),
                np.float32,
            ),
        )
        if use_nvq:
            row["nvq_b"] = np.zeros((n, dim), np.uint8)
            row["nvq_p"] = np.zeros((n, mode["nvq_nsub"], 4), np.float32)
            row["nvq_m"] = np.zeros((dim,), np.float32)
        if use_pq:
            cb_shape = mode["cb_shape"]
            row["codes"] = np.zeros((n, cb_shape[0]), np.int32)
            row["books"] = np.zeros(cb_shape, np.float32)
            row["center"] = np.zeros((dim,), np.float32)
        if mode["use_scalar"]:
            thr_shape, b_width = mode["sc_shapes"]
            row["sc_c"] = np.zeros((n, b_width), np.uint8)
            row["sc_t"] = np.zeros(thr_shape, np.float32)
        return row

    rows = [seg_rows(s) for s in lst]
    rows += [empty_row() for _ in range(g_max - len(rows))]
    out = {}
    for key in ("adj", "live", "ent", "o2d", "v",
                "codes", "books", "center", "nvq_b", "nvq_p", "nvq_m",
                "sc_c", "sc_t"):
        if rows[0].get(key) is None:
            out[key] = None
        elif key == "ent":
            out[key] = np.asarray([r[key] for r in rows], np.int32)
        else:
            out[key] = np.stack([r[key] for r in rows])
    return out


# grid key -> ShardedEngineState field
_GRID_FIELDS = dict(
    adj="adjacency", live="live", ent="entries", o2d="ord_to_doc",
    v="vectors", codes="pq_codes", books="pq_codebooks", center="pq_center",
    nvq_b="nvq_bytes", nvq_p="nvq_params", nvq_m="nvq_mean",
    sc_c="scalar_codes", sc_t="scalar_thresholds",
)


@jax.jit
def _slice_set(arr, idx, new):
    # donate_argnums would force a copy anyway on backends without aliasing;
    # XLA fuses the scatter either way and the copy stays device-side
    return arr.at[idx].set(new)


def restack_engine_state(prev_state: ShardedEngineState, prev_names,
                         segments, names, mesh: Mesh | None = None):
    """Incremental re-stack: rebuild only shards whose segment-name list
    changed, writing their [G, ...] slices into the previous state's device
    arrays (device-side copies — no full-corpus host re-upload).

    Falls back to a full `stack_engine_state` when the stacked global
    shape parameters (segment slots, capacity, quantization mode, degree,
    codebook/NVQ shapes) differ from the previous state's.

    Returns (state, rebuilt_shards) where rebuilt_shards == n_shards means
    a full restack.
    """
    shard_lists, mode = _stack_mode(segments)
    d_sh = len(shard_lists)
    state = prev_state
    full = prev_state is None or prev_names is None
    if not full:
        cb = (tuple(prev_state.pq_codebooks.shape[2:])
              if prev_state.use_pq else None)
        full = (
            d_sh != prev_state.n_shards
            or len(prev_names) != d_sh
            or mode["g_max"] != prev_state.n_segments
            or mode["n"] != prev_state.n_local
            or mode["use_pq"] != prev_state.use_pq
            or mode["use_nvq"] != prev_state.use_nvq
            or mode["m_deg"] != prev_state.adjacency.shape[3]
            or mode["dim"] != prev_state.vectors.shape[-1]
            or (mode["use_pq"] and mode["cb_shape"] != cb)
            or (mode["use_nvq"]
                and mode["nvq_nsub"] != prev_state.nvq_params.shape[-2])
            or mode["use_disk"] != prev_state.approx_only
            or mode["use_scalar"] != prev_state.use_scalar
            or (mode["use_scalar"] and (
                tuple(prev_state.scalar_thresholds.shape[2:])
                != mode["sc_shapes"][0]
                or prev_state.scalar_codes.shape[-1]
                != mode["sc_shapes"][1]))
        )
    if full:
        return stack_engine_state(segments, mesh), d_sh
    changed = [d for d in range(d_sh) if names[d] != prev_names[d]]
    if not changed:
        return prev_state, 0
    if len(changed) == d_sh:
        return stack_engine_state(segments, mesh), d_sh
    grids = [_shard_grid(shard_lists[d], mode) for d in changed]
    idx = jnp.asarray(np.asarray(changed, np.int32))
    updates = {}
    for key, field in _GRID_FIELDS.items():
        if grids[0][key] is None:
            continue
        cur = getattr(state, field)
        new = jnp.asarray(np.stack([g[key] for g in grids]))
        updates[field] = _slice_set(cur, idx, new)
    return dataclasses.replace(state, **updates), len(changed)


def _full_local_search(adj, live, entry, o2d, accept, queries,
                       vectors, codes, codebooks, center,
                       nvq_b, nvq_p, nvq_m, sc_c, sc_t,
                       params: SearchParams, simf: SimilarityFunction,
                       use_pq: bool, use_nvq: bool, use_scalar: bool):
    """Complete two-phase search on ONE shard (inside shard_map).

    Mirrors models/searcher._make_search_fn (LUT build -> beam -> rerank ->
    threshold) but maps graph ordinals to doc ids at the end so the mesh
    merge operates directly in doc-id space.
    """
    qn = queries.shape[0]
    if use_pq:
        centered = queries - center[None, :]
        if simf is SimilarityFunction.COSINE:
            centered = centered * jax.lax.rsqrt(
                jnp.sum(centered * centered, -1, keepdims=True) + 1e-30
            )
        qstate = centered
        ctx = {"codes": codes, "codebooks": codebooks}
        provider = searcher_mod.make_pq_provider(simf.value)
    elif use_scalar:
        # Hamming approximate phase over per-segment thresholds (XOR +
        # popcount, same composition as the host searcher's scalar mode)
        qstate = searcher_mod._encode_scalar_queries(queries, sc_t)
        ctx = {"codes": sc_c}
        provider = searcher_mod.make_hamming_provider()
    else:
        qstate, ctx = queries, {"vectors": vectors}
        provider = searcher_mod.make_exact_provider(simf.value)

    r = max(params.k * params.overquery_factor, params.k)
    ef = max(params.ef_search, r)
    e = params.expansions_per_iter
    iters = params.resolved_iters(ef)
    res_ids, res_scores, visited, expanded = searcher_mod.beam_search(
        adj, live, entry, qstate, ctx, accept, provider,
        L=ef, E=e, R=r, max_iters=iters, vma_axis=AXIS,
    )

    if use_pq or use_scalar:  # exact rerank of the overqueried survivors
        qualify = res_ids >= 0
        if params.rerank_floor > 0.0:
            qualify &= res_scores >= params.rerank_floor
        safe = jnp.clip(res_ids, 0)
        if use_nvq:
            # decode the candidates' inline NVQ codes (rerank source —
            # same as the host searcher's lazy NVQ row decode)
            from opensearch_jvector_tpu.ops import nvq as nvq_ops

            b = nvq_b[safe]  # [Q, r, d] u8
            p = nvq_p[safe]  # [Q, r, Mn, 4]
            mn = p.shape[-2]
            cand = nvq_ops.nvq_decode(
                b.reshape(-1, b.shape[-1]),
                p.reshape(-1, mn, 4),
                nvq_m, mn,
            ).reshape(b.shape)
        else:
            cand = vectors[safe]
        exact = batched_candidate_scores(queries, cand, simf)
        exact = jnp.where(qualify, exact, -jnp.inf)
        reranked = jnp.sum(qualify, axis=1).astype(jnp.int32)
        scores, ids = topk_scores(exact, res_ids, params.k)
    else:
        reranked = jnp.zeros((qn,), jnp.int32)
        scores, ids = topk_scores(res_scores, res_ids, params.k)

    keep = scores > -jnp.inf
    if params.threshold > 0.0:
        keep &= scores >= params.threshold
    docs = o2d[jnp.clip(ids, 0)]
    keep &= (ids >= 0) & (docs >= 0)
    docs = jnp.where(keep, docs, -1)
    scores = jnp.where(keep, scores, -jnp.inf)
    return docs, scores, visited, expanded, reranked


def sharded_engine_search(
    mesh: Mesh,
    state: ShardedEngineState,
    queries: jax.Array,  # [Q, d] (replicated)
    params: SearchParams,
    simf: SimilarityFunction,
    accept: jax.Array | None = None,  # [D, n] ordinal accept masks
):
    """Full-engine scatter-gather over the mesh.

    Returns (doc_ids [Q, k] int32, scores [Q, k] f32,
             counters [D, 3] int32 = per-shard [visited, expanded, reranked]).
    """
    assert not state.approx_only, (
        "approx_only (on_disk) states have no on-device rerank rows; use "
        "sharded_engine_search_approx + a paged rerank"
    )
    if accept is None:
        accept = state.live
    use_pq = state.use_pq
    use_nvq = state.use_nvq
    # dummy PQ/NVQ operands keep one code path; XLA drops unused inputs
    d_sh, g = state.n_shards, state.n_segments
    cod = state.pq_codes if use_pq else jnp.zeros((d_sh, g, 1, 1), jnp.int32)
    cb = (state.pq_codebooks if use_pq
          else jnp.zeros((d_sh, g, 1, 1, 1), jnp.float32))
    ctr = (state.pq_center if use_pq
           else jnp.zeros((d_sh, g, 1), jnp.float32))
    nvq_b = (state.nvq_bytes if use_nvq
             else jnp.zeros((d_sh, g, 1, 1), jnp.uint8))
    nvq_p = (state.nvq_params if use_nvq
             else jnp.zeros((d_sh, g, 1, 1, 4), jnp.float32))
    nvq_m = (state.nvq_mean if use_nvq
             else jnp.zeros((d_sh, g, 1), jnp.float32))
    use_scalar = state.use_scalar
    sc_c = (state.scalar_codes if use_scalar
            else jnp.zeros((d_sh, g, 1, 1), jnp.uint8))
    sc_t = (state.scalar_thresholds if use_scalar
            else jnp.zeros((d_sh, g, 1, 1), jnp.float32))
    run = _make_engine_fn(mesh, params, simf, use_pq, use_nvq, use_scalar)
    return run(state.adjacency, state.live, state.entries, state.ord_to_doc,
               state.vectors, accept, cod, cb, ctr, nvq_b, nvq_p, nvq_m,
               sc_c, sc_t, queries)


@functools.lru_cache(maxsize=None)
def _make_engine_fn(mesh: Mesh, params: SearchParams,
                    simf: SimilarityFunction, use_pq: bool,
                    use_nvq: bool = False, use_scalar: bool = False):
    """Cached jitted program for sharded_engine_search."""

    def shard_fn(adj, liv, ent, o2d, vec, acc, cod, cb, ctr,
                 nvq_b, nvq_p, nvq_m, sc_c, sc_t, q):
        # leading shard axis sliced by shard_map -> [G, ...] per device;
        # the shard's segments run via vmap (one fused program per device),
        # then a LOCAL top-k merges the segment lists before the
        # cross-shard merge — shards are whole (multi-segment) indexes.
        adj, liv, o2d, vec, acc = adj[0], liv[0], o2d[0], vec[0], acc[0]
        ent, cod, cb, ctr = ent[0], cod[0], cb[0], ctr[0]
        nvq_b, nvq_p, nvq_m = nvq_b[0], nvq_p[0], nvq_m[0]
        sc_c, sc_t = sc_c[0], sc_t[0]

        def one_segment(adj_g, liv_g, ent_g, o2d_g, acc_g, vec_g,
                        cod_g, cb_g, ctr_g, nb_g, np_g, nm_g,
                        scc_g, sct_g):
            return _full_local_search(
                adj_g, liv_g, ent_g, o2d_g, acc_g, q, vec_g,
                cod_g if use_pq else None,
                cb_g if use_pq else None,
                ctr_g if use_pq else None,
                nb_g if use_nvq else None,
                np_g if use_nvq else None,
                nm_g if use_nvq else None,
                scc_g if use_scalar else None,
                sct_g if use_scalar else None,
                params, simf, use_pq, use_nvq, use_scalar,
            )

        docs_g, scores_g, visited, expanded, reranked = jax.vmap(
            one_segment
        )(adj, liv, ent, o2d, acc, vec, cod, cb, ctr,
          nvq_b, nvq_p, nvq_m, sc_c, sc_t)  # [G, Q, k]

        qn = q.shape[0]
        flat_docs = jnp.transpose(docs_g, (1, 0, 2)).reshape(qn, -1)
        flat_scores = jnp.transpose(scores_g, (1, 0, 2)).reshape(qn, -1)
        scores, docs = topk_scores(flat_scores, flat_docs, params.k)
        docs = jnp.where(scores > -jnp.inf, docs, -1)
        counters = jnp.stack(
            [jnp.sum(visited), jnp.sum(expanded), jnp.sum(reranked)]
        ).astype(jnp.int32)
        return docs[None], scores[None], counters[None]  # [1, Q, k]/[1, 3]

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS),
                  P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS),
                  P(AXIS), P(AXIS), P()),
        out_specs=(P(AXIS), P(AXIS), P(AXIS)),
    )

    # Global merge under the same jit: the per-shard [Q, k] doc/score lists
    # stay device-resident and XLA inserts the gather collective for the
    # final top-k. (NOT check_vma=False + a manual all_gather: with VMA
    # checking off this JAX version treats every value as unvarying and
    # all_gather silently returns only the local shard.)
    @jax.jit
    def run(adjacency, live, entries, o2d, vectors, accept, cod, cb, ctr,
            nvq_b, nvq_p, nvq_m, sc_c, sc_t, queries):
        all_docs, all_scores, counters = fn(
            adjacency, live, entries, o2d, vectors, accept, cod, cb, ctr,
            nvq_b, nvq_p, nvq_m, sc_c, sc_t, queries,
        )  # [D, Q, k], [D, Q, k], [D, 3]
        qn = queries.shape[0]
        flat_docs = jnp.transpose(all_docs, (1, 0, 2)).reshape(qn, -1)
        flat_scores = jnp.transpose(all_scores, (1, 0, 2)).reshape(qn, -1)
        top_s, top_d = topk_scores(flat_scores, flat_docs, params.k)
        top_d = jnp.where(top_s > -jnp.inf, top_d, -1)
        return top_d, top_s, counters

    return run


def sharded_engine_search_approx(
    mesh: Mesh,
    state: ShardedEngineState,
    queries: jax.Array,  # [Q, d] (replicated)
    params: SearchParams,
    simf: SimilarityFunction,
    accept: jax.Array | None = None,  # [D, G, n]
):
    """Approximate phase of the on_disk mesh search (approx_only states).

    Runs the PQ/ADC beam over every shard's HBM-resident codes and merges
    the per-shard candidate lists globally by APPROXIMATE score — rows stay
    in each segment's host store. Returns
      (docs [Q, R] int32, locators [Q, R] int32, approx_scores [Q, R] f32,
       counters [D, 3])
    with R = k * overquery_factor and locator = shard*(G*n) + seg*n + ord
    (-1 for empty slots); the caller pages the rows and reranks exactly
    (reference two-phase split: approximate traversal vs rerank source,
    JVectorReader.java:353-366 — here the split crosses the mesh boundary).
    """
    assert state.approx_only and state.use_pq
    if accept is None:
        accept = state.live
    run = _make_approx_fn(mesh, params, simf)
    return run(state.adjacency, state.live, state.entries, state.ord_to_doc,
               accept, state.pq_codes, state.pq_codebooks, state.pq_center,
               queries)


@functools.lru_cache(maxsize=None)
def _make_approx_fn(mesh: Mesh, params: SearchParams,
                    simf: SimilarityFunction):
    """Cached jitted program for sharded_engine_search_approx."""
    r = max(params.k * params.overquery_factor, params.k)
    ef = max(params.ef_search, r)
    e = params.expansions_per_iter
    iters = params.resolved_iters(ef)

    def shard_fn(adj, liv, ent, o2d, acc, cod, cb, ctr, q):
        adj, liv, o2d, acc = adj[0], liv[0], o2d[0], acc[0]
        ent, cod, cb, ctr = ent[0], cod[0], cb[0], ctr[0]
        g, n = adj.shape[0], adj.shape[1]
        shard_idx = jax.lax.axis_index(AXIS)

        def one_segment(adj_g, liv_g, ent_g, o2d_g, acc_g, cod_g, cb_g,
                        ctr_g):
            centered = q - ctr_g[None, :]
            if simf is SimilarityFunction.COSINE:
                centered = centered * jax.lax.rsqrt(
                    jnp.sum(centered * centered, -1, keepdims=True) + 1e-30
                )
            ids, scores, visited, expanded = searcher_mod.beam_search(
                adj_g, liv_g, ent_g, centered,
                {"codes": cod_g, "codebooks": cb_g}, acc_g,
                searcher_mod.make_pq_provider(simf.value),
                L=ef, E=e, R=r, max_iters=iters, vma_axis=AXIS,
            )
            qualify = ids >= 0
            if params.rerank_floor > 0.0:
                qualify &= scores >= params.rerank_floor
            docs = o2d_g[jnp.clip(ids, 0)]
            qualify &= docs >= 0
            return (
                jnp.where(qualify, ids, -1),
                jnp.where(qualify, docs, -1),
                jnp.where(qualify, scores, -jnp.inf),
                visited, expanded,
            )

        ords_g, docs_g, scores_g, visited, expanded = jax.vmap(one_segment)(
            adj, liv, ent, o2d, acc, cod, cb, ctr
        )  # [G, Q, r]
        seg_base = (shard_idx * g + jnp.arange(g, dtype=jnp.int32)) * n
        locs_g = jnp.where(
            ords_g >= 0, seg_base[:, None, None] + ords_g, -1
        )
        qn = q.shape[0]
        flat_scores = jnp.transpose(scores_g, (1, 0, 2)).reshape(qn, -1)
        flat_locs = jnp.transpose(locs_g, (1, 0, 2)).reshape(qn, -1)
        flat_docs = jnp.transpose(docs_g, (1, 0, 2)).reshape(qn, -1)
        top_s, idx = jax.lax.top_k(flat_scores, r)
        top_l = jnp.take_along_axis(flat_locs, idx, axis=1)
        top_d = jnp.take_along_axis(flat_docs, idx, axis=1)
        counters = jnp.stack(
            [jnp.sum(visited), jnp.sum(expanded), jnp.zeros((), jnp.int32)]
        ).astype(jnp.int32)
        return top_d[None], top_l[None], top_s[None], counters[None]

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(AXIS),) * 8 + (P(),),
        out_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
    )

    @jax.jit
    def run(adjacency, live, entries, o2d, accept, cod, cb, ctr, queries):
        all_d, all_l, all_s, counters = fn(
            adjacency, live, entries, o2d, accept, cod, cb, ctr, queries,
        )  # [D, Q, r] x3, [D, 3]
        qn = queries.shape[0]
        flat_s = jnp.transpose(all_s, (1, 0, 2)).reshape(qn, -1)
        flat_l = jnp.transpose(all_l, (1, 0, 2)).reshape(qn, -1)
        flat_d = jnp.transpose(all_d, (1, 0, 2)).reshape(qn, -1)
        top_s, idx = jax.lax.top_k(flat_s, r)
        top_l = jnp.take_along_axis(flat_l, idx, axis=1)
        top_d = jnp.take_along_axis(flat_d, idx, axis=1)
        keep = top_s > -jnp.inf
        return (jnp.where(keep, top_d, -1), jnp.where(keep, top_l, -1),
                top_s, counters)

    return run


@functools.lru_cache(maxsize=None)
def _make_paged_rerank_fn(k: int, threshold: float,
                          simf: SimilarityFunction):
    """Cached exact-rerank program for host-paged candidate rows."""

    @jax.jit
    def run(queries, cand, docs):
        # cand [Q, R, d] fp32 rows paged from the host stores; invalid
        # slots carry doc -1 and zero rows
        exact = batched_candidate_scores(queries, cand, simf)
        valid = docs >= 0
        exact = jnp.where(valid, exact, -jnp.inf)
        if threshold > 0.0:
            exact = jnp.where(exact >= threshold, exact, -jnp.inf)
        top_s, idx = jax.lax.top_k(exact, k)
        top_d = jnp.take_along_axis(docs, idx, axis=1)
        top_d = jnp.where(top_s > -jnp.inf, top_d, -1)
        return top_d, top_s, jnp.sum(valid, axis=1).astype(jnp.int32)

    return run
