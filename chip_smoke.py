"""Smoke test: the vector engine's main path on one GPU, at real size.

    python chip_smoke.py                 # phases a-e on one GPU
    python chip_smoke.py --multi-gpu     # the mesh-sharded path on 4 GPUs

Data is generated from `--seed` with the latent-16 "SIFT-like" generator
(the geometry of ann-benchmarks `sift-128-euclidean`: 128-d float32,
euclidean, effective dimension ~16). The index uses the `disk_ann`
defaults: m=32, ef_construction=100, alpha 1.2, PQ with 64 subspaces.

Phases (single GPU):
  a. device report: JAX devices, device kind, JAX version, card name and
     power limit; fails unless JAX runs on a GPU;
  b. kernel check at real widths: every scoring kernel of the path,
     compiled for the card, against a NumPy float64 reference, each with
     its own tolerance;
  c. `VectorIndex.add_batch` + `flush()` of a 1,048,576-vector segment
     (graph tier) and a 200,000-vector segment (PQ ADC scan tier); 1,024
     queries at k=10, ef_search=100; recall@10 against the exact oracle;
  d. REST: `KnnService` on the same root, 8 `POST /{index}/_search`
     requests whose hits must equal `VectorIndex.search`;
  e. an `on_disk` PQ index of 262,144 vectors, reranked through the host
     row store.

`--multi-gpu` runs only the sharded path: a 4-shard `ShardedVectorIndex`
searched over a 4-GPU mesh, compared with the host scatter-gather path
and the exact oracle.

Every phase raises on failure, so the script exits non-zero; the last
line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
DIM = 128
LATENT = 16
K = 10
EF_SEARCH = 100
RECALL_FLOOR = 0.95

# Tolerances of the kernel check (phase b), each with its reason.
# ADC scan: float32 sums of M nonnegative table entries, so the relative
# error is at most M * 2^-24 (3.8e-6 at M=64, 1.1e-5 at M=192); the bound
# is loose (rounding errors rarely add up), so 1e-5 holds for every M here.
ADC_RTOL = 1e-5
# (M, K) the ADC scan is also checked at, beyond sift-128's M=64, K=256:
# 960-d (M=192, padded to 256), 300-d (M=100), an odd M, and K < 256.
ADC_EXTRA_SHAPES = ((192, 256), (100, 256), (7, 256), (12, 16))
# decoded-bf16 scan: the query is cast to bf16 (2^-9 relative per element)
# against rows stored in bf16, so |error of q.x| <= 2^-9 |q||x|; the
# error is measured in units of 2|q||x| (the scale of ||q-x||^2), 2x margin.
DECODED_TOL = 2.0 ** -9
# float32 products at Precision.HIGHEST (beam providers, exact rerank, the
# recall oracle): f32 rounding over d=128 terms, in units of 2|q||x|.
EXACT_TOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_report() -> str:
    """`name, power.limit` of every card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


class SiftLike:
    """Latent-16 generator: rows = z @ A + 0.05 * noise, z ~ N(0, I_16).

    One mixing matrix per seed, so every batch drawn from one generator
    (corpus segments and queries) shares the same low-dimensional
    geometry."""

    def __init__(self, seed: int, dim: int = DIM):
        self.rng = np.random.default_rng(seed)
        self.dim = dim
        self.a = (self.rng.standard_normal((LATENT, dim)).astype(np.float32)
                  / np.float32(np.sqrt(LATENT)))

    def rows(self, n: int) -> np.ndarray:
        z = self.rng.standard_normal((n, LATENT), dtype=np.float32)
        noise = self.rng.standard_normal((n, self.dim), dtype=np.float32)
        return z @ self.a + np.float32(0.05) * noise


def knn_mapping(mode: str = "in_memory") -> dict:
    return {
        "type": "knn_vector", "dimension": DIM, "space_type": "l2",
        "mode": mode,
        "method": {"name": "disk_ann", "engine": "jvector",
                   "parameters": {"m": 32, "ef_construction": 100}},
    }


# ---------------------------------------------------------------------------
# phase a
# ---------------------------------------------------------------------------


def phase_device(require_platform: str = "gpu", min_devices: int = 1):
    import jax

    devs = jax.devices()
    log(f"[a] jax {jax.__version__} devices={devs}")
    log(f"[a] device_kind={devs[0].device_kind} count={len(devs)}")
    if devs[0].platform != require_platform:
        raise SystemExit(
            f"chip_smoke: needs a {require_platform} device, JAX runs on "
            f"{devs[0].platform}")
    if len(devs) < min_devices:
        raise SystemExit(
            f"chip_smoke: needs {min_devices} devices, found {len(devs)}")
    if require_platform == "gpu":
        log(f"[a] card: {card_report()}")
    return devs


# ---------------------------------------------------------------------------
# phase b
# ---------------------------------------------------------------------------


def _check(name: str, err: float, tol: float) -> None:
    log(f"[b] {name}: max error {err:.3e} (tolerance {tol:.1e})")
    if not np.isfinite(err) or err > tol:
        raise AssertionError(f"{name}: error {err:.3e} over {tol:.1e}")


def _check_adc(rng, q: int, n: int, m: int, k: int, ref_q) -> None:
    """`ops/adc.lookup_scan` at [q, n], M=m, K=k vs float64; on the GPU it
    must have compiled the Triton kernel."""
    import jax
    import jax.numpy as jnp

    from opensearch_jvector_tpu.ops import adc as adc_ops

    # nonnegative tables, as euclidean subspace distances are
    luts = rng.random((q, m, k), dtype=np.float32)
    codes = rng.integers(0, k, (n, m), dtype=np.uint8)
    luts_dev, codes_dev = jnp.asarray(luts), jnp.asarray(codes)
    t0 = time.perf_counter()
    vals = adc_ops.lookup_scan(luts_dev, codes_dev)
    vals = np.asarray(vals.block_until_ready())
    hlo = adc_ops.lookup_scan.lower(luts_dev, codes_dev).compile().as_text()
    kernel = "Pallas Triton kernel" if "triton" in hlo else "XLA gather form"
    log(f"[b] ADC scan [{q}, {n}] M={m} K={k} ({kernel}): shape "
        f"{vals.shape}, first call {time.perf_counter() - t0:.3f}s incl. "
        f"compile")
    if jax.devices()[0].platform == "gpu" and "triton" not in hlo:
        raise AssertionError("the GPU scan did not compile the Triton kernel")
    assert vals.shape == (q, n) and np.isfinite(vals).all()
    sub = np.arange(m)[None, :]
    err = 0.0
    for qi in ref_q:
        ref = luts[qi].astype(np.float64)[sub, codes].sum(-1)  # [n]
        err = max(err, float(np.max(np.abs(vals[qi] - ref) / ref)))
    _check(f"ADC scan M={m} K={k} (relative)", err, ADC_RTOL)


def phase_kernels(seed: int, q: int = 512, n: int = 262_144, m: int = 64,
                  k: int = 256, ref_queries: int = 16, extra_n: int = 65_536):
    """Every scoring kernel of the main path at real widths vs float64;
    the ADC scan also at the other (M, K) of the PQ schedule."""
    import jax
    import jax.numpy as jnp

    from opensearch_jvector_tpu.index.reader import _decoded_scan_scores
    from opensearch_jvector_tpu.models import searcher
    from opensearch_jvector_tpu.ops.distances import (
        SimilarityFunction,
        batched_candidate_scores,
        pairwise_scores,
    )

    rng = np.random.default_rng(seed + 1)
    ref_q = np.sort(rng.choice(q, min(ref_queries, q), replace=False))
    for mi, ki, ni in ((m, k, n),) + tuple(
            (ms, ks, extra_n) for ms, ks in ADC_EXTRA_SHAPES):
        _check_adc(rng, q, ni, mi, ki, ref_q)

    # Decoded-bf16 scan (on_disk / NVQ scan tier).
    d = DIM
    dec = rng.standard_normal((n, d), dtype=np.float32).astype(jnp.bfloat16)
    dec_f64 = np.asarray(dec, np.float64)
    qv = rng.standard_normal((q, d), dtype=np.float32)
    dec_dev = jnp.asarray(dec)
    dec_sq = jnp.einsum("nd,nd->n", dec_dev, dec_dev,
                        preferred_element_type=jnp.float32)
    simf = SimilarityFunction.EUCLIDEAN
    scores = np.asarray(jax.jit(
        lambda a, b, c: _decoded_scan_scores(a, b, c, simf))(
            jnp.asarray(qv), dec_dev, dec_sq))
    assert scores.shape == (q, n) and np.isfinite(scores).all()
    d2_dev = 1.0 / scores.astype(np.float64) - 1.0
    err = 0.0
    xn = np.linalg.norm(dec_f64, axis=1)
    for qi in ref_q:
        qq = qv[qi].astype(np.float64)
        d2 = ((dec_f64 - qq) ** 2).sum(-1)
        scale = 2.0 * np.linalg.norm(qq) * xn
        err = max(err, float(np.max(np.abs(d2_dev[qi] - d2) / scale)))
    _check("decoded-bf16 scan (units of 2|q||x|)", err, DECODED_TOL)

    # Beam providers and the exact rerank: per-query candidate rows.
    c = 512  # E * M candidates per hop at the defaults (16 * 32)
    rows = rng.standard_normal((q, c, d), dtype=np.float32)
    ref_rows = rows[ref_q].astype(np.float64)
    ref_qv = qv[ref_q].astype(np.float64)
    ref_d2 = ((ref_rows - ref_qv[:, None, :]) ** 2).sum(-1)
    scale = 2.0 * (np.linalg.norm(ref_qv, axis=1)[:, None]
                   * np.linalg.norm(ref_rows, axis=2))
    s = np.asarray(jax.jit(lambda a, b: batched_candidate_scores(a, b, simf))(
        jnp.asarray(qv), jnp.asarray(rows)))
    err = float(np.max(np.abs((1.0 / s[ref_q].astype(np.float64) - 1.0)
                              - ref_d2) / scale))
    _check("exact rerank / exact beam provider", err, EXACT_TOL)

    # codes-only beam provider: decode-then-score over PQ codebooks
    dsub = d // m
    books = rng.standard_normal((m, k, dsub), dtype=np.float32)
    cand_codes = rng.integers(0, k, (n, m), dtype=np.uint8)
    ids = rng.integers(0, n, (q, c), dtype=np.int32)
    prov = searcher.make_pq_provider(simf.value)
    s = np.asarray(jax.jit(lambda a, i, cc, bb: prov(
        {"codes": cc, "codebooks": bb}, a, i))(
            jnp.asarray(qv), jnp.asarray(ids), jnp.asarray(cand_codes),
            jnp.asarray(books)))
    dec_rows = books[np.arange(m)[None, None, :],
                     cand_codes[ids[ref_q]]].reshape(len(ref_q), c, d)
    dec_rows = dec_rows.astype(np.float64)
    ref_d2 = ((dec_rows - ref_qv[:, None, :]) ** 2).sum(-1)
    scale = 2.0 * (np.linalg.norm(ref_qv, axis=1)[:, None]
                   * np.linalg.norm(dec_rows, axis=2))
    err = float(np.max(np.abs((1.0 / s[ref_q].astype(np.float64) - 1.0)
                              - ref_d2) / scale))
    _check("codes-only beam provider", err, EXACT_TOL)

    # recall oracle / flat exact scan
    corpus = rng.standard_normal((n, d), dtype=np.float32)
    s = np.asarray(jax.jit(lambda a, b: pairwise_scores(a, b, simf))(
        jnp.asarray(qv[ref_q]), jnp.asarray(corpus)))
    c64 = corpus.astype(np.float64)
    cn = np.linalg.norm(c64, axis=1)
    err = 0.0
    for j, qq in enumerate(ref_qv):
        ref_d2 = ((c64 - qq) ** 2).sum(-1)
        got = 1.0 / s[j].astype(np.float64) - 1.0
        err = max(err, float(np.max(np.abs(got - ref_d2)
                                    / (2.0 * np.linalg.norm(qq) * cn))))
    _check("oracle / exact scan", err, EXACT_TOL)


# ---------------------------------------------------------------------------
# phase c
# ---------------------------------------------------------------------------


def _oracle(queries, corpus, k=K) -> np.ndarray:
    """Exact top-k ids (float32 at Precision.HIGHEST, exact top-k)."""
    from opensearch_jvector_tpu.ops.distances import SimilarityFunction
    from opensearch_jvector_tpu.utils.ground_truth import ground_truth_topk

    return ground_truth_topk(queries, corpus, k, SimilarityFunction.EUCLIDEAN)


def _recall(result_ids, truth, k=K) -> float:
    from opensearch_jvector_tpu.utils.ground_truth import recall_at_k

    return recall_at_k(np.asarray(result_ids), truth, k)


def _timed_search(idx, queries, sc):
    idx.search(queries, sc)  # compile + first load of every segment
    t0 = time.perf_counter()
    res = idx.search(queries, sc)  # returns host arrays: the device is done
    return res, time.perf_counter() - t0


def phase_build_search(root: Path, seed: int, card: str,
                       n_graph: int = 1 << 20, n_scan: int = 200_000,
                       n_queries: int = 1024):
    """Two flushed segments (graph tier + scan tier), batched k-NN search."""
    from opensearch_jvector_tpu.api.config import SearchConfig
    from opensearch_jvector_tpu.api.mapping import parse_knn_vector_mapping
    from opensearch_jvector_tpu.index.index import VectorIndex
    from opensearch_jvector_tpu.index.scheduler import (
        ForceMergesOnlyMergePolicy,
    )

    gen = SiftLike(seed)
    cfg, _ = parse_knn_vector_mapping(knn_mapping())
    idx = VectorIndex(root / "sift" / "vec", cfg,
                      merge_policy=ForceMergesOnlyMergePolicy())
    parts = []
    for name, n in (("graph", n_graph), ("scan", n_scan)):
        base = sum(p.shape[0] for p in parts)
        v = gen.rows(n)
        parts.append(v)
        t0 = time.perf_counter()
        idx.add_batch(np.arange(base, base + n), v)
        seg = idx.flush()
        secs = time.perf_counter() - t0
        rd = idx._reader(seg)
        tier = "scan" if rd.seg.capacity() <= rd._scan_bound() else "graph"
        log(f"[c] flushed {seg}: {n} vectors, capacity "
            f"{rd.seg.capacity()}, {tier} tier, build {secs:.1f}s "
            f"({n / secs:.0f} vectors/s) [{card}]")
        if tier != name:
            raise AssertionError(f"segment {seg} serves the {tier} tier, "
                                 f"expected {name}")
    queries = gen.rows(n_queries)
    sc = SearchConfig(k=K, ef_search=EF_SEARCH)
    res, secs = _timed_search(idx, queries, sc)
    assert res.doc_ids.shape == (n_queries, K)
    assert np.isfinite(res.scores).all()
    corpus = np.concatenate(parts)
    recall = _recall(res.doc_ids, _oracle(queries, corpus))
    log(f"[c] search {n_queries} queries k={K} ef_search={EF_SEARCH}: "
        f"{secs * 1e3 / n_queries:.4f} ms/query batched, recall@{K} "
        f"{recall:.4f} [{card}]")
    if recall < RECALL_FLOOR:
        raise AssertionError(f"recall@{K} {recall:.4f} < {RECALL_FLOOR}")
    return idx, queries, sc


# ---------------------------------------------------------------------------
# phase d
# ---------------------------------------------------------------------------


def _post(port: int, path: str, body: dict) -> dict:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST" if path.endswith("_search") else "PUT", path,
                     json.dumps(body), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
    finally:
        conn.close()
    if resp.status != 200:
        raise AssertionError(f"{path}: HTTP {resp.status}: {raw[:500]!r}")
    return json.loads(raw)


def phase_rest(root: Path, idx, queries: np.ndarray, sc, n_requests=8):
    """`_search` over HTTP must return the library's hits."""
    from opensearch_jvector_tpu.service.http import KnnService

    lib = idx.search(queries[:n_requests], sc)
    svc = KnnService(root)
    svc.start()
    try:
        _post(svc.port, "/sift",
              {"mappings": {"properties": {"vec": knn_mapping()}}})
        for i in range(n_requests):
            body = {"size": sc.k, "query": {"knn": {"vec": {
                "vector": queries[i].tolist(), "k": sc.k,
                "method_parameters": {"ef_search": sc.ef_search},
            }}}}
            hits = _post(svc.port, "/sift/_search", body)["hits"]["hits"]
            got_ids = [h["_id"] for h in hits]
            want = [int(d) for d in lib.doc_ids[i] if d >= 0]
            if got_ids != want:
                raise AssertionError(
                    f"REST query {i}: ids {got_ids} != library {want}")
            np.testing.assert_allclose(
                [h["_score"] for h in hits], lib.scores[i][: len(want)],
                rtol=1e-6)
    finally:
        svc.stop()
    log(f"[d] REST: {n_requests} POST /sift/_search responses equal "
        f"VectorIndex.search")


# ---------------------------------------------------------------------------
# phase e
# ---------------------------------------------------------------------------


def phase_on_disk(root: Path, seed: int, card: str, n: int = 1 << 18,
                  n_queries: int = 1024):
    """on_disk PQ index: device ADC scan, exact rerank from host rows."""
    from opensearch_jvector_tpu.api.config import SearchConfig
    from opensearch_jvector_tpu.api.mapping import parse_knn_vector_mapping
    from opensearch_jvector_tpu.index.index import VectorIndex

    gen = SiftLike(seed + 2)
    cfg, _ = parse_knn_vector_mapping(knn_mapping("on_disk"))
    idx = VectorIndex(root / "disk" / "vec", cfg)
    v = gen.rows(n)
    t0 = time.perf_counter()
    idx.add_batch(np.arange(n), v)
    seg = idx.flush()
    secs = time.perf_counter() - t0
    store = idx._reader(seg).seg.row_store
    kind = "native store" if store.is_native else "numpy memmap fallback"
    log(f"[e] on_disk flush {n} vectors: {secs:.1f}s; host rows served by "
        f"the {kind} [{card}]")
    queries = gen.rows(n_queries)
    res, secs = _timed_search(idx, queries, SearchConfig(k=K,
                                                         ef_search=EF_SEARCH))
    assert res.reranked > 0, "on_disk search did not rerank host rows"
    recall = _recall(res.doc_ids, _oracle(queries, v))
    log(f"[e] on_disk search {n_queries} queries: "
        f"{secs * 1e3 / n_queries:.4f} ms/query batched, recall@{K} "
        f"{recall:.4f} [{card}]")
    if recall < RECALL_FLOOR:
        raise AssertionError(f"on_disk recall@{K} {recall:.4f} < "
                             f"{RECALL_FLOOR}")


# ---------------------------------------------------------------------------
# --multi-gpu
# ---------------------------------------------------------------------------


def phase_mesh(root: Path, seed: int, card: str, devices,
               n_per_shard: int = 1 << 20, n_queries: int = 1024):
    """4-shard index searched over a mesh vs the host scatter-gather."""
    from opensearch_jvector_tpu.api.config import SearchConfig
    from opensearch_jvector_tpu.api.mapping import parse_knn_vector_mapping
    from opensearch_jvector_tpu.parallel.distributed import (
        ShardedVectorIndex,
    )
    from opensearch_jvector_tpu.parallel.sharded import make_mesh

    n_shards = len(devices)
    gen = SiftLike(seed + 3)
    cfg, _ = parse_knn_vector_mapping(knn_mapping())
    mesh = make_mesh(devices)
    sidx = ShardedVectorIndex(root / "mesh", cfg, n_shards=n_shards,
                              mesh=mesh)
    n = n_per_shard * n_shards
    v = gen.rows(n)
    t0 = time.perf_counter()
    sidx.add_batch(np.arange(n), v)
    sidx.flush()
    log(f"[mesh] {n_shards} shards x {n_per_shard} vectors flushed in "
        f"{time.perf_counter() - t0:.1f}s [{card}]")
    queries = gen.rows(n_queries)
    sc = SearchConfig(k=K, ef_search=EF_SEARCH)
    mesh_res = sidx._search_on_mesh(queries, sc, None)  # compile
    if mesh_res is None:
        raise AssertionError("the mesh path refused the index")
    t0 = time.perf_counter()
    mesh_res = sidx._search_on_mesh(queries, sc, None)
    secs = time.perf_counter() - t0
    state = sidx._mesh_state
    placed = {s.device for s in state.adjacency.addressable_shards}
    log(f"[mesh] state shards on {len(placed)} devices: "
        f"{sorted(str(d) for d in placed)}")
    if len(placed) != n_shards:
        raise AssertionError(f"mesh state on {len(placed)} devices, "
                             f"expected {n_shards}")
    sidx.mesh = None  # same index, host scatter-gather path
    host_res = sidx.search(queries, sc)
    sidx.mesh = mesh
    agree = np.mean([
        len(set(a) & set(b)) / K
        for a, b in zip(mesh_res.doc_ids.tolist(), host_res.doc_ids.tolist())
    ])
    truth = _oracle(queries, v)
    r_mesh = _recall(mesh_res.doc_ids, truth)
    r_host = _recall(host_res.doc_ids, truth)
    log(f"[mesh] {n_queries} queries: {secs * 1e3 / n_queries:.4f} "
        f"ms/query on the mesh; recall@{K} mesh {r_mesh:.4f}, host "
        f"{r_host:.4f}; mesh/host top-{K} agreement {agree:.4f} [{card}]")
    for name, r in (("mesh", r_mesh), ("host", r_host),
                    ("mesh/host agreement", agree)):
        if r < RECALL_FLOOR:
            raise AssertionError(f"{name} {r:.4f} < {RECALL_FLOOR}")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multi-gpu", action="store_true",
                    help="run only the 4-GPU mesh-sharded path")
    args = ap.parse_args(argv)

    import jax

    from opensearch_jvector_tpu.utils.compile_cache import (
        configure_compile_cache,
    )

    configure_compile_cache()
    n_dev = 4 if args.multi_gpu else 1
    devs = phase_device("gpu", n_dev)
    card = card_report().splitlines()[0]
    data_dir = REPO / ".smoke_data"
    data_dir.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="run_", dir=data_dir))
    t0 = time.perf_counter()
    try:
        if args.multi_gpu:
            phase_mesh(root, args.seed, card, devs[:n_dev])
        else:
            phase_kernels(args.seed)
            idx, queries, sc = phase_build_search(root, args.seed, card)
            phase_rest(root, idx, queries, sc)
            phase_on_disk(root, args.seed, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"total {time.perf_counter() - t0:.1f}s")
    log(f"card: {card_report()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
