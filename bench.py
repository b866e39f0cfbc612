"""Headline benchmark: DiskANN search + build + merge on one GPU.

Mirrors the reference's JMH FormatBenchmarkQueryWithRandomVectors setup
(random vectors, dim 128; README.md:90-98) and its merge-time comparison
(README.md:163-174). Baseline: jvector fp32 at 100k docs = 0.451 ms/op
single-query (BASELINE.md).

Prints ONE JSON line on stdout (extras under "extra"). Delivery contract
(the r03 run was killed by the driver before its JSON emit — never again):
  * the headline record is kept up to date IN MEMORY as sections finish;
  * a watchdog thread force-emits it and exits 0 at BUDGET_S + grace,
    so a section overrun can cost that section, never the record;
  * SIGTERM (driver timeout) emits before dying;
  * sections are ordered by information value, and each is individually
    crash-guarded.

Every time is host wall-clock around work that ends in
`block_until_ready` (or in a host fetch of the results); the record names
the device it ran on. Restructuring this script into declared cells is
ROADMAP S1/D3.

Metrics emitted:
  * search_ms_per_query batched (batch=512)
  * 10M flat on_disk tier: build/search/recall/HBM-per-vector
  * per-codec cells: fp32, PQ (graph + scan), 1-bit scalar, NVQ
  * config-4 analog: aniso-PQ quantized build -> incremental merge ->
    codebook refine -> search (+ the plain-vs-aniso ADC comparison)
  * search_ms_per_op at batch=1 and batch=8 — the JMH-comparable numbers
  * build vectors/sec cold (includes XLA compile) and warm (steady state)
  * incremental (10k delta into 90k) vs full-rebuild merge seconds
"""

import json
import os
import signal
import sys
import threading
import time

import numpy as np

from opensearch_jvector_tpu.utils.compile_cache import configure_compile_cache

configure_compile_cache()

N = int(os.environ.get("BENCH_N", 100_000))
DIM = int(os.environ.get("BENCH_DIM", 128))
Q = int(os.environ.get("BENCH_Q", 512))
K = int(os.environ.get("BENCH_K", 10))
EF = int(os.environ.get("BENCH_EF", 100))
BATCH = int(os.environ.get("BENCH_BATCH", 16384))
FULL = os.environ.get("BENCH_FULL", "1") != "0"  # 0 -> headline only
# "sift": low-effective-dimension synthetic (latent 16 -> DIM linear map +
# noise), matching the geometry of real image-descriptor sets like
# SIFT-128 (effective dim ~15-20; real datasets unavailable offline).
# "gaussian": i.i.d. N(0,1) — the adversarial concentrated-distance case.
DATA = os.environ.get("BENCH_DATA", "sift")
BASELINE_MS = 0.451  # reference jvector fp32, 100k docs, dim 128 (README.md:92)
# Wall-clock budget. The r03 driver kill landed AFTER the 1M section's
# results printed — a cumulative section-cost reconstruction puts that at
# >= ~1,450s of bench wall — so 1,380s + 40s watchdog grace emits just
# inside the tightest driver timeout the evidence allows. Sections are
# skipped (cheapest-information first) once the budget is spent; the
# watchdog guarantees the JSON line regardless.
BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", 1380))
GRACE_S = 40.0
_T0 = time.time()

# ---------------------------------------------------------------------------
# single-emit machinery: exactly ONE JSON line, no matter how the run ends
# ---------------------------------------------------------------------------

extra: dict = {}
_record: dict = {
    "metric": "bench_incomplete (headline section did not finish)",
    "value": 0,
    "unit": "error",
    "vs_baseline": 0,
    "extra": extra,
}
_emit_lock = threading.Lock()
_emitted = False


def emit() -> None:
    global _emitted
    with _emit_lock:
        if _emitted:
            return
        _emitted = True
    try:
        sys.stdout.flush()
    except Exception:  # noqa: BLE001
        pass
    # fd-level write: not subject to Python stdout buffering, safe from
    # watchdog/signal context
    os.write(1, (json.dumps(_record) + "\n").encode())


def _watchdog() -> None:
    deadline = _T0 + BUDGET_S + GRACE_S
    while True:
        rem = deadline - time.time()
        if rem <= 0:
            break
        time.sleep(min(rem, 5.0))
        if _emitted:
            return
    log(f"watchdog: {BUDGET_S + GRACE_S:.0f}s deadline hit -> emitting "
        f"and exiting 0")
    extra.setdefault("watchdog_fired", True)
    emit()
    os._exit(0)


def _on_sigterm(signum, frame):  # driver timeout kills with TERM first
    log("SIGTERM -> emitting record and exiting")
    extra.setdefault("sigterm", True)
    emit()
    os._exit(0)


def over_budget(section: str) -> bool:
    if time.time() - _T0 > BUDGET_S:
        log(f"budget {BUDGET_S:.0f}s exceeded -> skipping {section}")
        extra.setdefault("skipped_sections", []).append(section)
        return True
    return False


def need(section: str, est_s: float) -> bool:
    """False (-> skip) when the remaining budget can't plausibly cover the
    section's estimated cost. Estimates are deliberately rough; the
    watchdog is the hard backstop."""
    remain = BUDGET_S - (time.time() - _T0)
    if remain < est_s:
        log(f"{section}: estimated {est_s:.0f}s exceeds remaining budget "
            f"{remain:.0f}s -> skipping")
        extra.setdefault("skipped_sections", []).append(section)
        return False
    return True


def log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


def make_data(rng, kind, n, q, dim=None):
    dim = dim or DIM
    if kind == "gaussian":
        return (rng.standard_normal((n, dim)).astype(np.float32),
                rng.standard_normal((q, dim)).astype(np.float32))
    latent = 16
    a = rng.standard_normal((latent, dim)).astype(np.float32) / np.sqrt(latent)
    vectors = (rng.standard_normal((n, latent)).astype(np.float32) @ a
               + 0.05 * rng.standard_normal((n, dim)).astype(np.float32))
    queries = (rng.standard_normal((q, latent)).astype(np.float32) @ a
               + 0.05 * rng.standard_normal((q, dim)).astype(np.float32))
    return vectors, queries


def make_device_corpus(n, seed, q_count, kind="latent", host_rows=True):
    """Corpus generated twice from the same counter-based keys: on the
    device (feeding GT/encode/build, no bulk upload) and on the host CPU
    backend (the row store). threefry is backend-deterministic and the
    latent matmul runs at precision='highest', so the two copies agree to
    ~1e-6 (logged as row drift by `join`).

    Returns a namespace: `dev_rows(lo, hi)` (the flush(device_rows=)
    provider), `gt_blocks()` (streamed GT source), `v_host` (numpy
    rows, filled by a background CPU thread), `queries`, and
    `join(tag)` (wait for host rows + record drift).
    """
    import types

    import jax
    import jax.numpy as jnp

    from opensearch_jvector_tpu.index.writer import DEVICE_ROWS_BLOCK
    B = DEVICE_ROWS_BLOCK  # generator block == writer provider stride
    latent = 16
    rngc = np.random.default_rng(seed)
    if kind == "latent":
        a_h = rngc.standard_normal((latent, DIM)).astype(np.float32)
        a_h /= np.sqrt(latent)
        q_h = (rngc.standard_normal((q_count, latent)).astype(
            np.float32) @ a_h
            + 0.05 * rngc.standard_normal((q_count, DIM)).astype(
                np.float32))
    else:  # i.i.d. gaussian (adversarial: no low-dim structure)
        a_h = None
        q_h = rngc.standard_normal((q_count, DIM)).astype(np.float32)

    key = jax.random.PRNGKey(seed)
    kn = jax.random.PRNGKey(seed + 70)

    @jax.jit
    def gen_block(i, a, noise):
        # fresh latent coords per block; ONE shared noise block per
        # backend (134M gaussians once — 5% amplitude, repetition
        # across slices is irrelevant to recall/latency)
        if a is None:
            return jax.random.normal(
                jax.random.fold_in(key, i), (B, DIM), jnp.float32
            )
        z = jax.random.normal(
            jax.random.fold_in(key, i), (B, latent), jnp.float32
        )
        return jnp.dot(z, a, precision="highest") + 0.05 * noise

    a_dev = None if a_h is None else jnp.asarray(a_h)
    noise_dev = (None if a_h is None
                 else jax.random.normal(kn, (B, DIM), jnp.float32))

    def dev_block(i):
        return gen_block(jnp.int32(i), a_dev, noise_dev)

    def dev_rows(lo, hi):
        i, off = divmod(lo, B)
        # single-block contract: the writer consumes providers at
        # DEVICE_ROWS_BLOCK stride (== B), so every request fits one
        # generated block; a block-crossing request would silently
        # return short rows via JAX's clamped OOB slicing
        assert off + (hi - lo) <= B, (lo, hi, B)
        return dev_block(i)[off: off + (hi - lo)]

    # host copy (row store + rerank source): same program on the CPU
    # backend, generated while the device runs the GT pass
    cpu_dev = jax.devices("cpu")[0]
    v_host = np.empty((n, DIM), np.float32)
    host_state = {}

    def fill_host_rows():
        with jax.default_device(cpu_dev):
            a_c = None if a_h is None else jnp.asarray(a_h)
            noise_c = (None if a_h is None
                       else jax.random.normal(kn, (B, DIM), jnp.float32))
            for i, lo in enumerate(range(0, n, B)):
                hi = min(lo + B, n)
                v_host[lo:hi] = np.asarray(
                    gen_block(jnp.int32(i), a_c, noise_c)[: hi - lo]
                )
        host_state["done"] = True

    host_thread = threading.Thread(target=fill_host_rows, daemon=True)
    if host_rows:
        host_thread.start()
    else:  # GT-only use: skip the CPU corpus fill (v_host stays garbage)
        host_state["done"] = True

    def gt_blocks():
        for i, lo in enumerate(range(0, n, B)):
            hi = min(lo + B, n)
            yield lo, dev_block(i)[: hi - lo]

    def join(tag):
        if host_thread.ident is not None:
            host_thread.join()
        drift = float(np.abs(
            np.asarray(dev_block(0)[:256]) - v_host[:256]).max())
        extra[f"{tag}_row_drift"] = drift
        return drift

    return types.SimpleNamespace(
        dev_rows=dev_rows, dev_block=dev_block, gt_blocks=gt_blocks,
        v_host=v_host, queries=q_h, join=join, host_state=host_state,
    )


# ---------------------------------------------------------------------------
# Graph-tier prep cache: the >=4M Vamana build is too expensive to pay
# inside the fixed bench budget. `BENCH_PREP_TIER1=1 python bench.py` builds the index ONCE through
# the production VectorIndex path and persists it — segments on disk plus a
# manifest carrying the measured build wall and the exact ground truth.
# sec_graph_tier then OPENS the persisted index (the production reopen
# path) and measures serving live; build_s in the record is the manifest's
# measured wall, labeled as prebuilt-this-round. Production indexes persist;
# re-paying a multi-hundred-second build per benchmark process would
# measure the harness, not the engine.
# ---------------------------------------------------------------------------

TIER1_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), ".bench_cache", "tier1"
)
TIER1_M, TIER1_SUB, TIER1_SEED = 32, 64, 47


def tier1_manifest() -> dict | None:
    """Validated manifest of the prepped graph-tier index, else None."""
    p = os.path.join(TIER1_DIR, "manifest.json")
    try:
        with open(p) as f:
            man = json.load(f)
        ok = (
            man["dim"] == DIM and man["kind"] == "latent"
            and man["k"] >= K and man["m"] == TIER1_M
            and man["num_pq_subspaces"] == TIER1_SUB
            and os.path.exists(os.path.join(TIER1_DIR, "gt.npz"))
            and os.path.exists(
                os.path.join(TIER1_DIR, "index", "commits.json"))
        )
        return man if ok else None
    except (OSError, KeyError, ValueError):
        return None


def prep_tier1() -> None:
    import shutil
    import subprocess

    from opensearch_jvector_tpu.api.config import DiskAnnConfig
    from opensearch_jvector_tpu.index.index import VectorIndex
    from opensearch_jvector_tpu.index.scheduler import (
        ForceMergesOnlyMergePolicy,
    )
    from opensearch_jvector_tpu.ops.distances import SimilarityFunction
    from opensearch_jvector_tpu.utils.ground_truth import (
        ground_truth_topk_stream,
    )

    n1 = int(os.environ.get("BENCH_N_TIER1", 1 << 22))
    log(f"prep_tier1: building {n1} x {DIM}d on_disk graph index "
        f"(m={TIER1_M}, pq{TIER1_SUB}) into {TIER1_DIR}")
    # resumable: keep a completed gt.npz; wipe only the index + manifest
    gt_path = os.path.join(TIER1_DIR, "gt.npz")
    shutil.rmtree(os.path.join(TIER1_DIR, "index"), ignore_errors=True)
    try:
        os.remove(os.path.join(TIER1_DIR, "manifest.json"))
    except OSError:
        pass
    os.makedirs(TIER1_DIR, exist_ok=True)

    simf = SimilarityFunction.EUCLIDEAN
    t_gen = time.time()
    corpus = make_device_corpus(n1, seed=TIER1_SEED, q_count=128)
    gt_k = max(K, 10)
    gt = None
    if os.path.exists(gt_path):
        old = np.load(gt_path)

        def _f(name):
            return int(old[name]) if name in old.files else -1

        if (_f("n") == n1 and _f("dim") == DIM and _f("seed") == TIER1_SEED
                and _f("k") >= gt_k):
            gt = old["gt"]
            log("prep_tier1: reusing persisted ground truth")
    t0 = time.time()
    if gt is None:
        gt = np.asarray(ground_truth_topk_stream(
            corpus.queries, corpus.gt_blocks(), gt_k, simf
        ))
        np.savez(gt_path, queries=corpus.queries, gt=gt,
                 n=n1, dim=DIM, seed=TIER1_SEED, k=gt_k)
    drift = corpus.join("tier1")
    log(f"prep_tier1: ground truth {time.time() - t0:.1f}s; host rows "
        f"{'done' if corpus.host_state.get('done') else 'late'}; "
        f"row drift {drift:.2e}; setup total {time.time() - t_gen:.1f}s")

    idx = VectorIndex(
        os.path.join(TIER1_DIR, "index"),
        DiskAnnConfig(dim=DIM, mode="on_disk", quantization_type="pq",
                      m=TIER1_M, num_pq_subspaces=TIER1_SUB),
        merge_policy=ForceMergesOnlyMergePolicy(),
    )
    bs = os.environ.get("BENCH_TIER1_BS")
    if bs:
        idx.writer.build_batch_size = int(bs)
    elif n1 >= (1 << 22):
        # at >=4M capacity a smaller insert round keeps the in-program
        # working set (corpus + decoded-bf16 score source + adjacency +
        # round temps) small; its size on the H100 is ROADMAP D4
        idx.writer.build_batch_size = 8192
    idx.add_batch(np.arange(n1), corpus.v_host)
    t0 = time.time()
    idx.flush(device_rows=corpus.dev_rows)
    build_s = time.time() - t0
    log(f"prep_tier1: on_disk GRAPH build (PQ train+encode + quantized "
        f"Vamana + store): {build_s:.1f}s ({n1 / build_s:.0f} vec/s)")
    idx.close()

    try:
        rev = subprocess.run(
            ["git", "-C", os.path.dirname(os.path.abspath(__file__)),
             "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip()
    except Exception:
        rev = "unknown"
    man = {
        "n": n1, "dim": DIM, "kind": "latent", "seed": TIER1_SEED,
        "k": gt_k, "m": TIER1_M, "num_pq_subspaces": TIER1_SUB,
        "build_s": round(build_s, 1),
        "build_vec_per_s": round(n1 / build_s, 0),
        "row_drift": drift,
        "built_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "git_rev": rev,
        "note": ("prebuilt via BENCH_PREP_TIER1=1; serving is measured "
                 "live by sec_graph_tier through the production reopen "
                 "path"),
    }
    with open(os.path.join(TIER1_DIR, "manifest.json"), "w") as f:
        json.dump(man, f, indent=1)
    log(f"prep_tier1: manifest written: {man}")


def prep_tier1_gt() -> None:
    """Regenerate the prepped graph-tier ground truth at BENCH_PREP_GT
    queries WITHOUT rebuilding the index (the corpus rows come from
    counter-based threefry keyed only by block index and seed, so the
    query count does not perturb them). More queries amortize the beam
    program's per-batch fixed cost in the serving cells."""
    from opensearch_jvector_tpu.ops.distances import SimilarityFunction
    from opensearch_jvector_tpu.utils.ground_truth import (
        ground_truth_topk_stream,
    )

    man = tier1_manifest()
    if man is None:
        raise SystemExit("no prepped tier1 index: run BENCH_PREP_TIER1=1")
    qn = int(os.environ.get("BENCH_PREP_GT", 512))
    n1 = int(man["n"])
    gt_k = max(K, 10)
    log(f"prep_tier1_gt: {qn} queries over the prepped {n1}-row corpus")
    corpus = make_device_corpus(n1, seed=TIER1_SEED, q_count=qn,
                                host_rows=False)
    t0 = time.time()
    gt = np.asarray(ground_truth_topk_stream(
        corpus.queries, corpus.gt_blocks(), gt_k,
        SimilarityFunction.EUCLIDEAN,
    ))
    np.savez(os.path.join(TIER1_DIR, "gt.npz"), queries=corpus.queries,
             gt=gt, n=n1, dim=DIM, seed=TIER1_SEED, k=gt_k)
    log(f"prep_tier1_gt: {qn}-query ground truth in {time.time() - t0:.1f}s")


def main():
    import jax
    import jax.numpy as jnp

    from opensearch_jvector_tpu.models import searcher
    from opensearch_jvector_tpu.models.builder import GraphIndexBuilder
    from opensearch_jvector_tpu.models.searcher import SearchParams
    from opensearch_jvector_tpu.ops.distances import SimilarityFunction
    from opensearch_jvector_tpu.utils.ground_truth import (
        ground_truth_topk,
        ground_truth_topk_stream,
        recall_at_k,
    )

    simf = SimilarityFunction.EUCLIDEAN
    rng = np.random.default_rng(7)
    v_np, q_np = make_data(rng, DATA, N, Q)
    vectors, queries = jnp.asarray(v_np), jnp.asarray(q_np)
    extra_pq_cache = {}

    def build(builder=None):
        builder = builder or GraphIndexBuilder(
            dim=DIM, max_degree=48, beam_width=100, batch_size=BATCH
        )
        return builder.build(vectors, simf)

    # ---------------- headline: cold/warm build + batched search ----------
    t0 = time.time()
    graph = build()
    build_cold = time.time() - t0
    log(f"build(cold, incl. compile): {N} vectors in {build_cold:.1f}s "
        f"({N / build_cold:.0f} vec/s)")
    extra["build_vec_per_s_cold"] = round(N / build_cold, 1)

    if FULL:
        t0 = time.time()
        graph = build()
        build_warm = time.time() - t0
        log(f"build(warm): {N} vectors in {build_warm:.1f}s "
            f"({N / build_warm:.0f} vec/s)")
        extra["build_vec_per_s_warm"] = round(N / build_warm, 1)
        extra["merge_full_rebuild_s"] = round(build_warm, 2)
        # Reference-side comparison, read off the reference's OWN published
        # chart (merge_times_comparison.png, README.md:163-174): the
        # "before incremental" line is a full graph rebuild per merge and
        # reaches ~160,000 ms at 50k sift-128 docs => ~312 vec/s end-to-end
        # rebuild rate on their (unspecified) hardware. The JMH
        # construction benchmark publishes no number; "near-perfect
        # multicore scaling" (README.md:33) is unquantified.
        extra["build_reference_baseline_vec_per_s"] = 312
        extra["build_reference_baseline_src"] = (
            "merge_times_comparison.png: full-rebuild merge ~160s @ 50k "
            "sift-128 docs"
        )
        extra["build_vs_reference_rebuild"] = round(
            (N / build_warm) / 312.0, 1)

    params = SearchParams(k=K, ef_search=EF, overquery_factor=5)

    def run(g, qs, vs):
        res = searcher.search(
            g.adjacency, g.live, g.entry, qs, params, simf, vectors=vs,
        )
        jax.block_until_ready(res.ids)
        return res

    def timed_ms_per_query(g, qs, vs, iters=5):
        """Host wall-clock ms per query of `iters` searches of `qs`, each
        ending in block_until_ready (after one warm-up compile)."""
        run(g, qs, vs)  # compile + warm
        t0 = time.time()
        for _ in range(iters):
            run(g, qs, vs)
        return (time.time() - t0) / iters / qs.shape[0] * 1000.0

    def timed_batched(fn, qs, *arrays, iters=8):
        """Host wall-clock ms per query of a batched search
        `fn(qs, *arrays) -> ids [Q, k]`: one warm-up compile, then
        `iters` calls, each ending in block_until_ready."""
        jax.block_until_ready(fn(qs, *arrays))  # compile + warm
        t0 = time.time()
        for _ in range(iters):
            jax.block_until_ready(fn(qs, *arrays))
        return (time.time() - t0) / iters / qs.shape[0] * 1000.0

    res = run(graph, queries, vectors)
    truth = ground_truth_topk(queries, vectors, K, simf)
    rec = recall_at_k(np.asarray(res.ids), truth, K)
    log(f"recall@{K} ({DATA}): {rec:.4f}")
    ms_batched = timed_batched(
        lambda qs, adj, live, ent, vec: searcher.search(
            adj, live, ent, qs, params, simf, vectors=vec,
        ).ids,
        queries, graph.adjacency, graph.live, graph.entry, vectors,
    )
    dev0 = jax.devices()[0]
    extra["device"] = f"{dev0.platform}:{dev0.device_kind}"
    log(f"batched (batch={Q}): {ms_batched:.4f} ms/query "
        f"({extra['device']})")
    # Reference's own OSB single-node throughput chart (throughput.png,
    # README.md:159-161, sift-128-euclidean-L2): jVector ~73 QPS
    # min/mean/median. Caveat recorded with the number: OSB measures the
    # full REST stack, this number is library QPS at batch=512.
    extra["reference_osb_qps_sift"] = 73
    extra["qps_batched"] = round(1000.0 / ms_batched, 0)

    # headline is now REAL: keep the record current from here on
    _record.update({
        "metric": f"search_ms_per_query_batched ({DATA} N={N}, d={DIM}, "
                  f"batch={Q}, recall@{K}={rec:.3f})",
        "value": round(ms_batched, 5),
        "unit": "ms/query",
        "vs_baseline": round(BASELINE_MS / ms_batched, 2),
    })

    # ------------------------------------------------------------------
    # FULL sections, ordered by information value (new numbers first).
    # Each runs in its own crash guard; over_budget/need gates decide
    # whether to start it at all.
    # ------------------------------------------------------------------

    def sec_10m_flat():
        # Larger-than-memory tier at 10M x 128d (BASELINE configs 4-5
        # scale): flat (graph-less) on_disk index — PQ codes + decoded-bf16
        # cache in device memory, fp32 rows in the native host store;
        # ingest is quantize + store (no graph build), search is the scan
        # tier + paged rerank, through the production VectorIndex path.
        import gc
        import shutil
        import tempfile

        from opensearch_jvector_tpu.api.config import (
            DiskAnnConfig,
            SearchConfig,
        )
        from opensearch_jvector_tpu.index.index import VectorIndex
        from opensearch_jvector_tpu.index.scheduler import (
            ForceMergesOnlyMergePolicy,
        )

        n10 = int(os.environ.get("BENCH_N_TIER2", 10_000_000))
        n_sub = 64  # PQ subspaces (code bytes per vector)
        t_gen = time.time()
        corpus = make_device_corpus(n10, seed=31, q_count=min(Q, 128))
        q10 = corpus.queries
        q10n = q10.shape[0]
        v10 = corpus.v_host

        root = tempfile.mkdtemp(prefix="bench10m_")
        try:
            # ground truth FIRST, while device memory is clean: its
            # [Q, block] score slabs then never sit next to the index's
            # resident codes + decoded cache
            t0 = time.time()
            t10 = ground_truth_topk_stream(q10, corpus.gt_blocks(), K, simf)
            drift = corpus.join("10M")
            log(f"10M device-gen ground truth: {time.time() - t0:.1f}s "
                f"(host rows in parallel: "
                f"{'done' if corpus.host_state.get('done') else 'late'}; "
                f"device/host row drift {drift:.2e}); "
                f"section setup total {time.time() - t_gen:.1f}s")
            idx10 = VectorIndex(
                root,
                DiskAnnConfig(dim=DIM, mode="on_disk", index_type="flat",
                              quantization_type="pq",
                              num_pq_subspaces=n_sub),
                merge_policy=ForceMergesOnlyMergePolicy(),
            )
            idx10.add_batch(np.arange(n10), v10)
            t0 = time.time()
            idx10.flush(device_rows=corpus.dev_rows)
            b10 = time.time() - t0
            log(f"10M flat on_disk ingest (PQ train+encode+store): "
                f"{b10:.1f}s ({n10 / b10:.0f} vec/s)")
            extra["10M_build_s"] = round(b10, 1)
            sc10 = SearchConfig(k=K, ef_search=EF)
            res10 = idx10.search(q10, sc10)
            t0 = time.time()
            for _ in range(3):
                idx10.search(q10, sc10)  # returns host arrays
            ms10 = (time.time() - t0) / 3 / q10n * 1000.0
            rec10 = recall_at_k(res10.doc_ids, t10, K)
            seg10 = idx10._reader(idx10.segment_names[0]).seg
            hbm_per_vec = (int(seg10.pqv.codes.shape[1])  # M bytes
                           + 2 * DIM)  # decoded-bf16 scan cache
            log(f"10M flat on_disk: {ms10:.4f} ms/query batched, "
                f"recall@{K}={rec10:.4f}, device {hbm_per_vec} B/vec "
                f"(fp32 rows on host: {4 * DIM} B/vec)")
            extra["10M_ms_per_query"] = round(ms10, 4)
            extra["10M_recall"] = round(float(rec10), 4)
            extra["10M_hbm_bytes_per_vector"] = hbm_per_vec
            del idx10, v10, q10, t10, seg10, corpus
            gc.collect()
        finally:
            shutil.rmtree(root, ignore_errors=True)

    def sec_scalar_nvq():
        # Per-codec comparison cells on the headline corpus — the
        # reference publishes exactly this kind of table (README.md:90-98).
        from opensearch_jvector_tpu.models import nvq as nvq_mod
        from opensearch_jvector_tpu.models import scalar as scalar_mod

        # ---- 1-bit scalar: Hamming beam over the fp32 graph + rerank ----
        # Measured in the mode's PRODUCTION configuration: x32 compression
        # carries a 3.0x default rescore oversample in the mapper
        # (api/mapping.py:160-167, mirroring CompressionLevel.java:57) —
        # the fetch pool is k*3 and the beam's exact-rerank pool widens
        # with it. 1-bit Hamming ordering is coarse, so a ladder finds the
        # (ef, overquery) where recall saturates; the recorded cell is the
        # first rung with recall >= 0.90, else the saturation point.
        t0 = time.time()
        state = scalar_mod.train_scalar_quantizer(v_np, bits=1)
        s_codes = jnp.asarray(scalar_mod.quantize_vectors(state, vectors))
        s_thr = jnp.asarray(state.thresholds)
        extra["scalar1b_train_encode_s"] = round(time.time() - t0, 2)
        s_best = None
        for s_ef, s_oq in ((EF, 3 * 5), (2 * EF, 30), (4 * EF, 60)):
            # overquery_factor multiplies k for the exact-rerank pool; the
            # 3.0x mapper oversample rides on top of the default 5
            s_params = SearchParams(k=K, ef_search=s_ef,
                                    overquery_factor=s_oq)
            s_res = searcher.search(
                graph.adjacency, graph.live, graph.entry, queries,
                s_params, simf,
                vectors=vectors, scalar_codes=s_codes,
                scalar_thresholds=s_thr,
            )
            s_rec = recall_at_k(np.asarray(s_res.ids), truth, K)
            log(f"scalar 1-bit ladder ef={s_ef} overquery={s_oq}: "
                f"recall@{K}={s_rec:.4f}")
            if s_best is None or s_rec > s_best[0] + 1e-6:
                s_best = (s_rec, s_ef, s_oq, s_params)
            if s_rec >= 0.90:
                break
        s_rec, s_ef, s_oq, s_params = s_best
        s_ms = timed_batched(
            lambda qs, adj, live, ent, vec, sc, st: searcher.search(
                adj, live, ent, qs, s_params, simf,
                vectors=vec, scalar_codes=sc, scalar_thresholds=st,
            ).ids,
            queries, graph.adjacency, graph.live, graph.entry, vectors,
            s_codes, s_thr,
        )
        log(f"scalar 1-bit (Hamming beam + fp32 rerank, production "
            f"rescore config ef={s_ef} overquery={s_oq}): {s_ms:.4f} "
            f"ms/query batched, recall@{K}={s_rec:.4f} "
            f"({s_codes.shape[1]} B/vec codes)")
        extra["scalar1b_ms_per_query_batched"] = round(s_ms, 4)
        extra["scalar1b_recall_at_k"] = round(float(s_rec), 4)
        extra["scalar1b_ef"] = s_ef
        extra["scalar1b_overquery"] = s_oq
        del s_codes, s_thr

        if over_budget("nvq cell"):
            return
        # ---- NVQ: production scan tier over the NVQ-decoded bf16 cache ---
        from opensearch_jvector_tpu.index.reader import (
            _decoded_scan_scores as _dscan_n,
        )

        t0 = time.time()
        nvqv = nvq_mod.train_nvq(vectors)
        n_dec = nvqv.decode().astype(jnp.bfloat16)
        n_sq = jnp.einsum("nd,nd->n", n_dec, n_dec,
                          preferred_element_type=jnp.float32)
        jax.block_until_ready(n_dec)
        extra["nvq_train_s"] = round(time.time() - t0, 2)

        @jax.jit
        def nvq_scan(qs, dec, sq):
            # L2: the scan's scores over the reconstruction ARE the exact
            # scores of the rerank source (reader skips the rerank too)
            scan = _dscan_n(qs, dec, sq, simf)
            return jax.lax.top_k(scan, K)[1]

        n_ids = nvq_scan(queries, n_dec, n_sq)
        n_rec = recall_at_k(np.asarray(n_ids), truth, K)
        n_ms = timed_batched(
            lambda qs, dec, sq: nvq_scan(qs, dec, sq),
            queries, n_dec, n_sq,
        )
        nbytes = int(np.asarray(nvqv.bytes_).shape[1])
        log(f"nvq scan tier: {n_ms:.4f} ms/query batched, "
            f"recall@{K}={n_rec:.4f} ({nbytes} B/vec codes)")
        extra["nvq_ms_per_query_batched"] = round(n_ms, 4)
        extra["nvq_recall_at_k"] = round(float(n_rec), 4)
        del nvqv, n_dec, n_sq

    def sec_config4():
        # BASELINE config-4 analog end-to-end (Deep10M is angular; scaled
        # to the budget): anisotropic-PQ QUANTIZED BUILD -> incremental
        # merge of a 10% delta -> codebook REFINEMENT -> re-encode ->
        # in-graph ADC search + fp32 rerank. Also settles plain-vs-aniso
        # PQ on the cosine corpus.
        from opensearch_jvector_tpu.models import pq as pq_mod

        cos = SimilarityFunction.COSINE
        rng4 = np.random.default_rng(53)
        # latent-64 angular corpus (Deep-like: high intrinsic dimension).
        # The latent-16 corpus used in r03 resolves eta=1.0 (the intrinsic-
        # dim formula correctly says "plain PQ" there), which made the
        # plain-vs-aniso cell degenerate — this corpus actually exercises
        # the anisotropic loss (eta ~4).
        lat4 = 64
        a4 = rng4.standard_normal((lat4, DIM)).astype(np.float32)
        a4 /= np.sqrt(lat4)
        dv_np = (rng4.standard_normal((N, lat4)).astype(np.float32) @ a4
                 + 0.05 * rng4.standard_normal((N, DIM)).astype(np.float32))
        dq_np = (rng4.standard_normal((Q, lat4)).astype(np.float32) @ a4
                 + 0.05 * rng4.standard_normal((Q, DIM)).astype(np.float32))
        dv = jnp.asarray(dv_np)
        dq = jnp.asarray(dq_np)
        d_truth = ground_truth_topk(dq, dv, K, cos)

        # --- plain vs aniso ADC-only ordering quality (same bytes/vec) ---
        t0 = time.time()
        plain_pq = pq_mod.train_pq(dv, cos, num_subspaces=64)
        plain_codes = pq_mod.encode(plain_pq, dv, cos)
        plain_dec = pq_mod.PQVectors(
            pq=plain_pq, codes=plain_codes).decode_bf16()
        plain_sq = jnp.einsum("nd,nd->n", plain_dec, plain_dec,
                              preferred_element_type=jnp.float32)
        plain_train_s = time.time() - t0
        from opensearch_jvector_tpu.index.reader import (
            _decoded_scan_scores as _dscan4,
        )

        @jax.jit
        def adc_only(qs, dec, sq):
            return jax.lax.top_k(_dscan4(qs, dec, sq, cos), K)[1]

        plain_adc = recall_at_k(
            np.asarray(adc_only(dq, plain_dec, plain_sq)), d_truth, K)

        t0 = time.time()
        eta = pq_mod.eta_for_threshold(
            0.25, pq_mod.estimate_intrinsic_dim(dv_np))
        a_pq = pq_mod.train_pq(dv, cos, num_subspaces=64,
                               anisotropic_eta=eta)
        a_codes = pq_mod.encode(a_pq, dv, cos)
        a_dec = pq_mod.PQVectors(pq=a_pq, codes=a_codes).decode_bf16()
        a_sq = jnp.einsum("nd,nd->n", a_dec, a_dec,
                          preferred_element_type=jnp.float32)
        a_train_s = time.time() - t0
        aniso_adc = recall_at_k(
            np.asarray(adc_only(dq, a_dec, a_sq)), d_truth, K)
        log(f"config4 plain-vs-aniso pq64 (eta={eta:.2f}, cosine): ADC-only "
            f"recall@{K} {plain_adc:.4f} vs {aniso_adc:.4f} "
            f"(train {plain_train_s:.1f}s / {a_train_s:.1f}s)")
        extra["deep_analog_adc_recall_plain"] = round(float(plain_adc), 4)
        extra["deep_analog_adc_recall_aniso"] = round(float(aniso_adc), 4)
        extra["deep_analog_aniso_eta"] = round(float(eta), 2)
        # pick the winner for the pipeline below
        use_aniso = aniso_adc > plain_adc
        pipe_pq, pipe_codes = (a_pq, a_codes) if use_aniso else (
            plain_pq, plain_codes)
        pipe_dec = a_dec if use_aniso else plain_dec
        del plain_dec, plain_sq, a_dec, a_sq

        if over_budget("config4 pipeline"):
            return
        # --- quantized build of 90%, incremental merge of 10% delta ------
        n_delta = N // 10
        builder4 = GraphIndexBuilder(
            dim=DIM, max_degree=48, beam_width=100, batch_size=BATCH
        )
        t0 = time.time()
        g4 = builder4.build(
            dv[: N - n_delta], cos,
            pq={"decoded": pipe_dec[: N - n_delta]}, capacity=N,
        )
        build4_s = time.time() - t0
        log(f"config4 quantized build ({N - n_delta} vecs, aniso-PQ "
            f"score source): {build4_s:.1f}s")
        extra["deep_analog_build_s"] = round(build4_s, 1)
        t0 = time.time()
        g4 = builder4.add_nodes(
            g4, dv, np.arange(N - n_delta, N), cos,
            pq={"decoded": pipe_dec},
        )
        merge4_s = time.time() - t0
        log(f"config4 incremental merge (delta {n_delta}): {merge4_s:.1f}s")
        extra["deep_analog_merge_s"] = round(merge4_s, 1)

        # warm re-measure: rebuild the 90% base and re-insert the same
        # delta with every program now compiled — separating the one-time
        # in-process compile wall from the steady-state costs (r04 weak
        # #2: the cold-only numbers read as "incremental merge costs more
        # than a fresh build", which is purely compile attribution)
        if not over_budget("config4 warm re-measure"):
            t0 = time.time()
            g4w = builder4.build(
                dv[: N - n_delta], cos,
                pq={"decoded": pipe_dec[: N - n_delta]}, capacity=N,
            )
            build4w_s = time.time() - t0
            t0 = time.time()
            g4w = builder4.add_nodes(
                g4w, dv, np.arange(N - n_delta, N), cos,
                pq={"decoded": pipe_dec},
            )
            merge4w_s = time.time() - t0
            del g4w
            log(f"config4 warm re-measure: build {build4w_s:.1f}s, "
                f"incremental merge {merge4w_s:.1f}s "
                f"({build4w_s / max(merge4w_s, 1e-9):.1f}x cheaper to "
                f"merge than rebuild)")
            extra["deep_analog_build_warm_s"] = round(build4w_s, 1)
            extra["deep_analog_merge_warm_s"] = round(merge4w_s, 1)

        # --- codebook refinement on the merged corpus + re-encode --------
        t0 = time.time()
        refined = pq_mod.refine_pq(pipe_pq, dv, cos)
        r_codes = pq_mod.encode(refined, dv, cos)
        r_dec = pq_mod.PQVectors(pq=refined, codes=r_codes).decode_bf16()
        r_sq = jnp.einsum("nd,nd->n", r_dec, r_dec,
                          preferred_element_type=jnp.float32)
        refine4_s = time.time() - t0
        refined_adc = recall_at_k(
            np.asarray(adc_only(dq, r_dec, r_sq)), d_truth, K)
        log(f"config4 codebook refine+re-encode: {refine4_s:.1f}s, "
            f"ADC-only recall {max(plain_adc, aniso_adc):.4f} -> "
            f"{refined_adc:.4f}")
        extra["deep_analog_refine_s"] = round(refine4_s, 1)
        extra["deep_analog_adc_recall_refined"] = round(float(refined_adc), 4)

        # --- end-to-end search: in-graph ADC + fp32 rerank ---------------
        res4 = searcher.search(
            g4.adjacency, g4.live, g4.entry, dq, params, cos,
            vectors=dv, pq_decoded=r_dec,
        )
        rec4 = recall_at_k(np.asarray(res4.ids), d_truth, K)
        ms4 = timed_batched(
            lambda qs, adj, live, ent, vec, dec: searcher.search(
                adj, live, ent, qs, params, cos,
                vectors=vec, pq_decoded=dec,
            ).ids,
            dq, g4.adjacency, g4.live, g4.entry, dv, r_dec,
        )
        log(f"config4 end-to-end (build->merge->refine->search): "
            f"{ms4:.4f} ms/query batched, recall@{K}={rec4:.4f}")
        extra["deep_analog_ms_per_query"] = round(ms4, 4)
        extra["deep_analog_recall"] = round(float(rec4), 4)

        # --- tuned point: the knob-turn that reaches the BASELINE north
        # star (recall@10 >= 0.95) on this config, and what it costs ----
        if float(rec4) < 0.95:
            for t_ef, t_oq in ((200, 10), (400, 20), (800, 40)):
                t_params = SearchParams(k=K, ef_search=t_ef,
                                        overquery_factor=t_oq)
                t_res = searcher.search(
                    g4.adjacency, g4.live, g4.entry, dq, t_params, cos,
                    vectors=dv, pq_decoded=r_dec,
                )
                t_rec = recall_at_k(np.asarray(t_res.ids), d_truth, K)
                log(f"config4 tuned ladder ef={t_ef} overquery={t_oq}: "
                    f"recall@{K}={t_rec:.4f}")
                if t_rec >= 0.95 or (t_ef, t_oq) == (800, 40):
                    t_ms = timed_batched(
                        lambda qs, adj, live, ent, vec, dec: searcher.search(
                            adj, live, ent, qs, t_params, cos,
                            vectors=vec, pq_decoded=dec,
                        ).ids,
                        dq, g4.adjacency, g4.live, g4.entry, dv, r_dec,
                    )
                    log(f"config4 tuned point (ef={t_ef}, oq={t_oq}): "
                        f"recall@{K}={t_rec:.4f}, {t_ms:.4f} ms/query")
                    extra["deep_analog_tuned_ef"] = t_ef
                    extra["deep_analog_tuned_overquery"] = t_oq
                    extra["deep_analog_tuned_recall"] = round(
                        float(t_rec), 4)
                    extra["deep_analog_tuned_ms_per_query"] = round(t_ms, 4)
                    break

    def sec_per_op():
        # Per-op latency: one query per dispatch, host wall-clock, each
        # search ending in block_until_ready — what a single client sees.
        ms_b8 = timed_ms_per_query(graph, queries[:8], vectors, iters=20)
        ms_b1 = timed_ms_per_query(graph, queries[:1], vectors, iters=20)
        log(f"graph tier batch=8: {ms_b8:.4f} ms/op ; batch=1: "
            f"{ms_b1:.4f} ms/op (reference jvector fp32 single-op: "
            f"{BASELINE_MS} ms)")
        extra["search_ms_per_op_batch8"] = round(ms_b8, 4)
        extra["search_ms_per_op_batch1"] = round(ms_b1, 4)

        # batch=1 on the scan tier: the reader's decoded-bf16 scan +
        # exact rerank (one matmul + top-k, no serial hop chain)
        from opensearch_jvector_tpu.index.reader import (
            _decoded_scan_scores as _dscan,
        )
        from opensearch_jvector_tpu.models import pq as pq_mod_b1
        from opensearch_jvector_tpu.ops.distances import (
            batched_candidate_scores as _bcs,
        )

        pq_b1 = pq_mod_b1.train_pq(vectors, simf)
        codes_b1 = pq_mod_b1.encode(pq_b1, vectors, simf)
        pqv_b1 = pq_mod_b1.PQVectors(pq=pq_b1, codes=codes_b1)
        dec_b1 = pqv_b1.decode_bf16()
        dec_sq_b1 = jnp.einsum("nd,nd->n", dec_b1, dec_b1,
                               preferred_element_type=jnp.float32)
        extra_pq_cache["pq"] = pq_b1
        extra_pq_cache["codes"] = codes_b1

        @jax.jit
        def scan_one(qq, vs, dec, dec_sq):
            scan = _dscan(qq, dec, dec_sq, simf)
            top_s, top_i = jax.lax.top_k(scan, K * 5)
            exact = _bcs(qq, vs[jnp.clip(top_i, 0)], simf)
            s, idx = jax.lax.top_k(exact, K)
            return jnp.take_along_axis(top_i, idx, axis=1)

        scan_b1_ms = timed_batched(scan_one, queries[:1], vectors, dec_b1,
                                   dec_sq_b1, iters=64)
        log(f"scan tier batch=1: {scan_b1_ms:.4f} ms/op -> "
            f"{BASELINE_MS / scan_b1_ms:.2f}x the reference single-op")
        extra["search_ms_per_op_batch1_scan"] = round(scan_b1_ms, 4)
        extra["vs_baseline_batch1_scan"] = round(BASELINE_MS / scan_b1_ms, 2)

    def sec_pq():
        # PQ/ADC quantized search on the same corpus: the reference's
        # quantized mode is its best number (0.194 ms/op @100k,
        # README.md:95). ADC approximate phase + fp32 rerank of the top
        # k*overquery survivors — the production PQ segment path.
        from opensearch_jvector_tpu.models import pq as pq_mod

        t0 = time.time()
        if extra_pq_cache:  # trained by the per-op section already
            pq, pq_codes = extra_pq_cache["pq"], extra_pq_cache["codes"]
        else:
            pq = pq_mod.train_pq(vectors, simf)
            pq_codes = pq_mod.encode(pq, vectors, simf)
        jax.block_until_ready(pq_codes)
        log(f"pq train+encode ({pq.num_subspaces} subspaces): "
            f"{time.time() - t0:.1f}s")
        extra["pq_train_encode_s"] = round(time.time() - t0, 2)

        # In-graph ADC tier (the production >256k on_disk beam path): beam
        # candidates scored from the decoded-bf16 cache (row gathers +
        # einsum; PQVectors.decode_bf16), fp32 rerank of the survivors.
        t0 = time.time()
        pq_dec = pq_mod.PQVectors(pq=pq, codes=pq_codes).decode_bf16()
        jax.block_until_ready(pq_dec)
        extra["pq_decode_cache_s"] = round(time.time() - t0, 2)

        pq_res = searcher.search(
            graph.adjacency, graph.live, graph.entry, queries, params, simf,
            vectors=vectors, pq_decoded=pq_dec,
        )
        pq_rec = recall_at_k(np.asarray(pq_res.ids), truth, K)
        pq_ms = timed_batched(
            lambda qs, adj, live, ent, vec, dec: searcher.search(
                adj, live, ent, qs, params, simf,
                vectors=vec, pq_decoded=dec,
            ).ids,
            queries, graph.adjacency, graph.live, graph.entry, vectors,
            pq_dec,
        )
        log(f"pq/adc graph-beam batched: {pq_ms:.4f} ms/query, "
            f"recall@{K}={pq_rec:.4f} (reference PQ single-op: 0.194 ms)")
        extra["pq_ms_per_query_batched"] = round(pq_ms, 4)
        extra["pq_recall_at_k"] = round(float(pq_rec), 4)

        # Decoded-bf16 full scan + exact rerank — the on_disk scan-tier
        # path for <=256k-code segments (reader._decoded_block_topr): ONE
        # [Q,d]x[d,N] bf16 matmul over the decoded cache.
        from opensearch_jvector_tpu.index.reader import (
            _decoded_scan_scores as _dscan_pq,
        )
        from opensearch_jvector_tpu.ops.distances import (
            batched_candidate_scores,
        )

        pq_dec_sq = jnp.einsum("nd,nd->n", pq_dec, pq_dec,
                               preferred_element_type=jnp.float32)

        @jax.jit
        def scan_search(qs, vs, dec, sq):
            scan = _dscan_pq(qs, dec, sq, simf)
            top_s, top_i = jax.lax.top_k(scan, K * 5)
            cand = vs[jnp.clip(top_i, 0)]
            exact = batched_candidate_scores(qs, cand, simf)
            s, idx = jax.lax.top_k(exact, K)
            return jnp.take_along_axis(top_i, idx, axis=1), s

        ids_scan, _ = scan_search(queries, vectors, pq_dec, pq_dec_sq)
        np.asarray(ids_scan)
        scan_ms = timed_batched(
            lambda qs, vs, dec, sq: scan_search(qs, vs, dec, sq)[0],
            queries, vectors, pq_dec, pq_dec_sq,
        )
        scan_rec = recall_at_k(np.asarray(ids_scan), truth, K)
        log(f"pq/adc full-scan+rerank batched: {scan_ms:.4f} ms/query, "
            f"recall@{K}={scan_rec:.4f}")
        extra["pq_scan_ms_per_query_batched"] = round(scan_ms, 4)
        extra["pq_scan_recall_at_k"] = round(float(scan_rec), 4)

    def sec_merge():
        # incremental (leading-segment) vs full-rebuild merge: delta-insert
        # the last 10% into a graph of the first 90% — same [N] program
        # family as the main build, so this measures steady-state insert.
        n_delta = N // 10
        boot_n = min(4096, N - n_delta)
        inc_builder = GraphIndexBuilder(
            dim=DIM, max_degree=48, beam_width=100, batch_size=BATCH
        )
        g90 = inc_builder.build(
            vectors[:boot_n], simf, capacity=N
        )
        if boot_n < N - n_delta:
            g90 = inc_builder.add_nodes(
                g90, vectors, np.arange(boot_n, N - n_delta), simf
            )
        # warm the delta's round-bucket program family on a THROWAWAY
        # functional insert (VamanaGraph is immutable, g90 unchanged)
        delta_ids = np.arange(N - n_delta, N)
        inc_builder.add_nodes(g90, vectors, delta_ids, simf)
        t0 = time.time()
        g_full = inc_builder.add_nodes(g90, vectors, delta_ids, simf)
        jax.block_until_ready(g_full.adjacency)
        merge_inc = time.time() - t0
        full_s = extra.get("merge_full_rebuild_s", build_cold)
        log(f"incremental merge (delta {n_delta} into {N - n_delta}): "
            f"{merge_inc:.1f}s vs full rebuild {full_s}s "
            f"({full_s / merge_inc:.1f}x)")
        extra["merge_incremental_s"] = round(merge_inc, 2)

    def sec_graph_tier():
        # The DiskANN-at-scale demonstration: the on_disk
        # GRAPH (Vamana beam) tier at >=4M codes through the production
        # VectorIndex path. Quantized build — the PQ build-score provider
        # over a device-resident row source (make_device_corpus).
        # Serving: beam traversal over
        # the decoded-bf16 ADC cache + paged exact rerank from the host
        # row store. The SAME segment is then re-served through the
        # exhaustive scan tier (dynamic scan_tier_max_codes raised above
        # N) so the sub-linear win is a same-corpus same-index comparison;
        # finally the breaker is forced low and the beam re-serves
        # codes-only — the memory-tight configuration at scale.
        #
        # Two paths in: the PREBUILT index (BENCH_PREP_TIER1 at
        # BENCH_N_TIER1; reopened from disk, build wall from its manifest,
        # serving measured live), else an in-process build at
        # BENCH_N_TIER1 (default 2^22). Either way this cell is the
        # at-scale regression canary for builder changes.
        import gc
        import shutil
        import tempfile

        from opensearch_jvector_tpu.api.config import (
            DiskAnnConfig,
            SearchConfig,
        )
        from opensearch_jvector_tpu.api.settings import GLOBAL_SETTINGS
        from opensearch_jvector_tpu.index.index import VectorIndex
        from opensearch_jvector_tpu.index.scheduler import (
            ForceMergesOnlyMergePolicy,
        )

        man = tier1_manifest()
        n1 = (int(man["n"]) if man
              else int(os.environ.get("BENCH_N_TIER1", 1 << 22)))
        m_graph, n_sub = TIER1_M, TIER1_SUB
        tag = f"{n1 / 1e6:.0f}M"
        root = None  # set only when this section owns a temp build
        if man:
            # production reopen path: the index was prebuilt by
            # `BENCH_PREP_TIER1=1 python bench.py`; the manifest carries
            # the measured build wall and the exact ground truth. Serving
            # below is measured live.
            t0 = time.time()
            npz = np.load(os.path.join(TIER1_DIR, "gt.npz"))
            q1 = npz["queries"]
            gt1 = npz["gt"]
            idx1 = VectorIndex(
                os.path.join(TIER1_DIR, "index"),
                merge_policy=ForceMergesOnlyMergePolicy(),
            )
            b1 = float(man["build_s"])
            log(f"{tag} on_disk GRAPH index: prebuilt "
                f"({man['built_at']}, rev {man['git_rev']}); build was "
                f"{b1:.1f}s ({man['build_vec_per_s']:.0f} vec/s, row "
                f"drift {man['row_drift']:.2e}); reopened for serving "
                f"in {time.time() - t0:.1f}s")
            extra[f"{tag}_graph_build_s"] = b1
            extra[f"{tag}_graph_build_vec_per_s"] = man["build_vec_per_s"]
            extra[f"{tag}_graph_build_note"] = man["note"]
            extra["graph_tier_n"] = n1
        else:
            t_gen = time.time()
            corpus = make_device_corpus(n1, seed=TIER1_SEED,
                                        q_count=min(Q, 128))
            q1 = corpus.queries

            root = tempfile.mkdtemp(prefix="benchgt_")
            # ground truth first, while device memory is clean
            t0 = time.time()
            gt1 = ground_truth_topk_stream(q1, corpus.gt_blocks(), K, simf)
            drift = corpus.join(f"{tag}_graph")
            log(f"{tag} graph-tier device-gen ground truth: "
                f"{time.time() - t0:.1f}s (host rows "
                f"{'done' if corpus.host_state.get('done') else 'late'}; "
                f"row drift {drift:.2e}); setup {time.time() - t_gen:.1f}s")

            idx1 = VectorIndex(
                root,
                DiskAnnConfig(dim=DIM, mode="on_disk",
                              quantization_type="pq", m=m_graph,
                              num_pq_subspaces=n_sub),
                merge_policy=ForceMergesOnlyMergePolicy(),
            )
            if n1 >= (1 << 22):
                # smaller insert rounds at >=4M capacity (ROADMAP D4)
                idx1.writer.build_batch_size = 8192
            idx1.add_batch(np.arange(n1), corpus.v_host)
            t0 = time.time()
            idx1.flush(device_rows=corpus.dev_rows)
            b1 = time.time() - t0
            log(f"{tag} on_disk GRAPH build (PQ train+encode + quantized "
                f"Vamana build + store): {b1:.1f}s ({n1 / b1:.0f} vec/s)")
            extra[f"{tag}_graph_build_s"] = round(b1, 1)
            extra[f"{tag}_graph_build_vec_per_s"] = round(n1 / b1, 0)
            extra["graph_tier_n"] = n1
            del corpus
        q1n = q1.shape[0]
        try:
            # search-effort ladder to the BASELINE north star (>=0.95)
            best = None
            for ef1 in (EF, 200, 400, 800):
                sc1 = SearchConfig(k=K, ef_search=ef1)
                res1 = idx1.search(q1, sc1)
                rec1 = recall_at_k(res1.doc_ids, gt1, K)
                log(f"{tag} graph beam ef={ef1}: recall@{K}={rec1:.4f}")
                best = (float(rec1), ef1, sc1)
                if rec1 >= 0.95 or over_budget("graph tier ladder"):
                    break
            rec1, ef1, sc1 = best
            # tuned low-latency points: a smaller rerank pool (oq=2)
            # halves the beam iterations (internal pool = k*oq bounds
            # ef from below); keep the cheapest config still at >=0.95
            sc_tuned = rec_tuned = None
            for ef_t, oq_t in ((150, 2), (200, 2)):
                if over_budget("graph tier tuned ladder"):
                    break
                sc_t = SearchConfig(k=K, ef_search=ef_t,
                                    overquery_factor=oq_t)
                rec_t = float(recall_at_k(
                    idx1.search(q1, sc_t).doc_ids, gt1, K))
                log(f"{tag} graph beam ef={ef_t} oq={oq_t}: "
                    f"recall@{K}={rec_t:.4f}")
                if rec_t >= 0.95:
                    sc_tuned, rec_tuned = sc_t, rec_t
                    break

            def timed_ms(cfg, reps=3):
                idx1.search(q1, cfg)  # compile + warm
                t0 = time.time()
                for _ in range(reps):
                    idx1.search(q1, cfg)  # returns host arrays
                return (time.time() - t0) / reps / q1n * 1000.0

            ms1 = timed_ms(sc1)
            seg1 = idx1._reader(idx1.segment_names[0]).seg
            # .shape on the device arrays (no host copy for a shape)
            slots_real = int(seg1.graph.adjacency.shape[1])
            code_b = int(seg1.pqv.codes.shape[1])
            hbm1 = code_b + 2 * DIM + slots_real * 4  # codes+decoded+adj
            log(f"{tag} on_disk graph tier (ef={ef1}): {ms1:.4f} ms/query "
                f"batched, recall@{K}={rec1:.4f}, device {hbm1} B/vec "
                f"(fp32 rows on host: {4 * DIM} B/vec)")
            extra[f"{tag}_graph_ms_per_query"] = round(ms1, 4)
            extra[f"{tag}_graph_recall"] = round(rec1, 4)
            extra[f"{tag}_graph_ef"] = ef1
            extra[f"{tag}_graph_hbm_bytes_per_vector"] = hbm1
            ms_t = None
            if sc_tuned is not None:
                ms_t = timed_ms(sc_tuned)
                log(f"{tag} graph tier TUNED (ef={sc_tuned.ef_search}, "
                    f"oq={sc_tuned.overquery_factor}): {ms_t:.4f} ms/query "
                    f"batched, recall@{K}={rec_tuned:.4f}")
                extra[f"{tag}_graph_tuned_ms_per_query"] = round(ms_t, 4)
                extra[f"{tag}_graph_tuned_recall"] = round(rec_tuned, 4)
                extra[f"{tag}_graph_tuned_ef"] = sc_tuned.ef_search
                extra[f"{tag}_graph_tuned_oq"] = sc_tuned.overquery_factor

            # same-segment exhaustive scan: the tier-routing comparison,
            # explicit. The beam visits a few thousand nodes per query
            # (~constant in N); the scan scores all N codes per query and
            # grows linearly — measured back-to-back with the beam cells.
            if not over_budget("graph tier scan comparison"):
                GLOBAL_SETTINGS.put(
                    "index.knn.advanced.scan_tier_max_codes", n1 + 1)
                try:
                    res_s = idx1.search(q1, SearchConfig(k=K, ef_search=EF))
                    ms_s = timed_ms(SearchConfig(k=K, ef_search=EF))
                finally:
                    GLOBAL_SETTINGS.put(
                        "index.knn.advanced.scan_tier_max_codes", -1)
                rec_s = recall_at_k(res_s.doc_ids, gt1, K)
                ms_best = min(ms1, ms_t) if ms_t is not None else ms1
                log(f"{tag} same-segment SCAN tier: {ms_s:.4f} ms/query "
                    f"batched, recall@{K}={rec_s:.4f} -> best >=0.95 beam "
                    f"point is {ms_s / ms_best:.2f}x the scan's speed at "
                    f"this N (scan cost grows linearly with N, beam ~flat)")
                extra[f"{tag}_scan_ms_per_query"] = round(ms_s, 4)
                extra[f"{tag}_scan_recall"] = round(float(rec_s), 4)
                extra[f"{tag}_beam_vs_scan_speedup"] = round(
                    ms_s / ms_best, 2)

            # memory-tight at scale: force the breaker low -> the beam
            # degrades to codes-only PQ scoring (no decoded cache), device
            # memory drops to codes + adjacency
            if not over_budget("graph tier breaker cell"):
                from opensearch_jvector_tpu.utils import (
                    circuit_breaker as cb,
                )

                rd1 = idx1._reader(idx1.segment_names[0])
                rd1._pq_decoded = None
                rd1._pq_decoded_sq = None
                orig_mem = cb.BREAKER.device_memory_bytes
                orig_use = cb.BREAKER.device_memory_in_use
                cb.BREAKER.device_memory_bytes = lambda device=None: 1
                cb.BREAKER.device_memory_in_use = lambda device=None: 0
                try:
                    res_c = idx1.search(q1, sc1)
                    ms_c = timed_ms(sc1)
                finally:
                    cb.BREAKER.device_memory_bytes = orig_mem
                    cb.BREAKER.device_memory_in_use = orig_use
                rec_c = recall_at_k(res_c.doc_ids, gt1, K)
                assert rd1._pq_decoded is None  # cache never rebuilt
                hbm_c = code_b + slots_real * 4
                log(f"{tag} graph tier, breaker-forced codes-only: "
                    f"{ms_c:.4f} ms/query batched, recall@{K}={rec_c:.4f}, "
                    f"device {hbm_c} B/vec")
                extra[f"{tag}_graph_codes_only_ms_per_query"] = round(
                    ms_c, 4)
                extra[f"{tag}_graph_codes_only_recall"] = round(
                    float(rec_c), 4)
                extra[f"{tag}_graph_codes_only_hbm_bytes_per_vec"] = hbm_c

        finally:
            idx1.close()
            del idx1, gt1
            gc.collect()
            if root is not None:
                shutil.rmtree(root, ignore_errors=True)

    def sec_gaussian_scan():
        # The adversarial corpus ABOVE the default scan bound: 512k i.i.d.
        # gaussian codes route to the beam tier by default (256k bound),
        # where distance concentration caps graph recall; the operator's
        # answer is the dynamic setting — raise
        # index.knn.advanced.scan_tier_max_codes and serve the exhaustive
        # scan. This cell records the setting's payoff
        # on one segment: beam-tier recall/latency vs scan-tier
        # recall/latency, same index, same queries.
        import gc
        import shutil
        import tempfile

        from opensearch_jvector_tpu.api.config import (
            DiskAnnConfig,
            SearchConfig,
        )
        from opensearch_jvector_tpu.api.settings import GLOBAL_SETTINGS
        from opensearch_jvector_tpu.index.index import VectorIndex
        from opensearch_jvector_tpu.index.scheduler import (
            ForceMergesOnlyMergePolicy,
        )

        n_g = int(os.environ.get("BENCH_N_GAUSS", 1 << 19))  # 524,288
        m_graph, n_sub = 32, 64
        corpus = make_device_corpus(n_g, seed=59, q_count=min(Q, 128),
                                    kind="gaussian")
        qg = corpus.queries
        qgn = qg.shape[0]
        t0 = time.time()
        gtg = ground_truth_topk_stream(qg, corpus.gt_blocks(), K, simf)
        corpus.join("gauss512k")
        log(f"gaussian 512k ground truth: {time.time() - t0:.1f}s")

        root = tempfile.mkdtemp(prefix="benchgs_")
        try:
            idxg = VectorIndex(
                root,
                DiskAnnConfig(dim=DIM, mode="on_disk",
                              quantization_type="pq", m=m_graph,
                              num_pq_subspaces=n_sub),
                merge_policy=ForceMergesOnlyMergePolicy(),
            )
            idxg.add_batch(np.arange(n_g), corpus.v_host)
            t0 = time.time()
            idxg.flush(device_rows=corpus.dev_rows)
            log(f"gaussian 512k on_disk graph build: {time.time() - t0:.1f}s")

            # default routing (N > 256k bound): beam tier — distance
            # concentration caps recall even at high search effort
            scg = SearchConfig(k=K, ef_search=600, overquery_factor=20)
            res_b = idxg.search(qg, scg)
            t0 = time.time()
            for _ in range(3):
                idxg.search(qg, scg)  # returns host arrays
            ms_b = (time.time() - t0) / 3 / qgn * 1000.0
            rec_b = recall_at_k(res_b.doc_ids, gtg, K)

            # operator raises the bound -> exhaustive scan + rerank
            GLOBAL_SETTINGS.put(
                "index.knn.advanced.scan_tier_max_codes", n_g + 1)
            try:
                scs = SearchConfig(k=K, ef_search=EF)
                res_s = idxg.search(qg, scs)
                t0 = time.time()
                for _ in range(3):
                    idxg.search(qg, scs)
                ms_s = (time.time() - t0) / 3 / qgn * 1000.0
            finally:
                GLOBAL_SETTINGS.put(
                    "index.knn.advanced.scan_tier_max_codes", -1)
            rec_s = recall_at_k(res_s.doc_ids, gtg, K)
            log(f"gaussian 512k: beam(ef=600,oq=20) {ms_b:.4f} ms/q "
                f"recall@{K}={rec_b:.4f} vs scan(bound raised) "
                f"{ms_s:.4f} ms/q recall@{K}={rec_s:.4f} — the "
                f"scan_tier_max_codes setting's payoff on i.i.d. data")
            extra["gauss512k_beam_ms_per_query"] = round(ms_b, 4)
            extra["gauss512k_beam_recall"] = round(float(rec_b), 4)
            extra["gauss512k_scan_ms_per_query"] = round(ms_s, 4)
            extra["gauss512k_scan_recall"] = round(float(rec_s), 4)
            del idxg, gtg, corpus
            gc.collect()
        finally:
            shutil.rmtree(root, ignore_errors=True)

    def sec_rest_qps():
        # End-to-end REST-stack QPS on the headline corpus, against the
        # reference's published single-node OSB throughput (~73 QPS at
        # sift, README.md:159-161 throughput.png). Drives service/http.py
        # on localhost with CONCURRENT single-vector _search clients; the
        # MicroBatcher coalesces them into shared device dispatches (the
        # device-serving analog of the reference's per-thread CPU
        # queries). The clients share the host's cores with the server.
        import http.client
        import shutil
        import tempfile

        from opensearch_jvector_tpu.api.mapping import (
            parse_knn_vector_mapping,
        )
        from opensearch_jvector_tpu.index.index import VectorIndex
        from opensearch_jvector_tpu.service.http import KnnService

        mapping = {
            "type": "knn_vector", "dimension": DIM,
            "method": {
                "name": "disk_ann", "engine": "jvector",
                "parameters": {"m": 48, "ef_construction": EF},
            },
        }
        cfg_r, _ = parse_knn_vector_mapping(mapping)
        root = tempfile.mkdtemp(prefix="benchrest_")
        try:
            # pre-build the index through the library path (warm program
            # family — same geometry as the headline build), then attach
            # the service to the same directory
            import os.path as _osp
            idx_r = VectorIndex(_osp.join(root, "bq", "vec"), cfg_r)
            idx_r.add_batch(np.arange(N), v_np)
            idx_r.flush()
            del idx_r
            svc = KnnService(root)
            svc.start()
            try:
                conn0 = http.client.HTTPConnection(
                    "127.0.0.1", svc.port, timeout=300)
                conn0.request("PUT", "/bq", json.dumps({
                    "mappings": {"properties": {"vec": mapping}},
                }), {"Content-Type": "application/json"})
                r0 = conn0.getresponse()
                assert r0.status == 200, r0.read()
                r0.read()

                n_cli = 32
                # warm the coalesced pow2 batch shapes (8..64) before
                # timing: each distinct padded Q-shape compiles once
                def one_req(conn, vec):
                    conn.request("POST", "/bq/_search", json.dumps({
                        "query": {"knn": {"vec": {
                            "vector": vec, "k": K,
                        }}},
                    }), {"Content-Type": "application/json"})
                    r = conn.getresponse()
                    body = r.read()
                    return r.status, body

                for w in range(3):  # serial warmups (batch=1 shape)
                    one_req(conn0, q_np[w].tolist())
                # deterministic bucket warm: 32 clients coalesce into
                # pow2-padded dispatches of 8/16/32 (reader.search
                # buckets Q, min 8); the msearch-style 2-D vector body
                # compiles each bucket OUTSIDE the timed window
                for bw in (8, 16, 32):
                    s, b = one_req(conn0, q_np[:bw].tolist())
                    assert s == 200, b

                state = {"stop": time.time() + 8.0}
                counts = np.zeros(n_cli, np.int64)

                def client(ti):
                    conn = http.client.HTTPConnection(
                        "127.0.0.1", svc.port, timeout=300)
                    qi = ti
                    while time.time() < state["stop"]:
                        try:
                            s, _ = one_req(conn, q_np[qi % Q].tolist())
                        except (ConnectionError, OSError,
                                http.client.HTTPException):
                            # transient socket teardown (server-side close
                            # race): reconnect and retry, as any real load
                            # generator does; the failed attempt counts 0
                            conn.close()
                            conn = http.client.HTTPConnection(
                                "127.0.0.1", svc.port, timeout=300)
                            continue
                        if s == 200:
                            counts[ti] += 1
                        qi += n_cli
                    conn.close()

                # warm concurrent pass (compiles the coalesced shapes)
                warm_threads = [threading.Thread(target=client, args=(i,))
                                for i in range(n_cli)]
                state["stop"] = time.time() + 4.0
                for t in warm_threads:
                    t.start()
                for t in warm_threads:
                    t.join()
                counts[:] = 0
                dur = 8.0
                state["stop"] = time.time() + dur
                t0 = time.time()
                threads = [threading.Thread(target=client, args=(i,))
                           for i in range(n_cli)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                wall = time.time() - t0
                qps = float(counts.sum()) / wall
                log(f"REST stack: {qps:.0f} QPS ({n_cli} concurrent "
                    f"clients, {counts.sum()} reqs / {wall:.1f}s, "
                    f"micro-batched) vs reference OSB ~73 QPS")
                extra["rest_qps"] = round(qps, 1)
                extra["rest_qps_clients"] = n_cli
                extra["rest_qps_note"] = (
                    "localhost REST, closed-loop clients on the same host; "
                    "reference: single-node OSB ~73 QPS (README.md:159)"
                )
            finally:
                svc.stop()
        finally:
            shutil.rmtree(root, ignore_errors=True)

    def sec_gist():
        # High-dim angular cell (BASELINE config 3: GIST1M 960-d PQ64 +
        # fused ADC + fp32 rerank; scaled to 100k for the bench budget).
        from opensearch_jvector_tpu.models import pq as pq_mod_g
        from opensearch_jvector_tpu.ops.distances import (
            batched_candidate_scores as _bcsg,
        )

        gdim, glat, gn = 960, 32, N
        grng = np.random.default_rng(41)
        ga = grng.standard_normal((glat, gdim)).astype(np.float32)
        ga /= np.sqrt(glat)
        gv = (grng.standard_normal((gn, glat)).astype(np.float32) @ ga
              + 0.05 * grng.standard_normal((gn, gdim)).astype(np.float32))
        gq = (grng.standard_normal((Q, glat)).astype(np.float32) @ ga
              + 0.05 * grng.standard_normal((Q, gdim)).astype(np.float32))
        gv_d, gq_d = jnp.asarray(gv), jnp.asarray(gq)
        cos = SimilarityFunction.COSINE
        t0 = time.time()
        gist_pq = pq_mod_g.train_pq(gv_d, cos, num_subspaces=64)
        gist_codes = pq_mod_g.encode(gist_pq, gv_d, cos)
        gist_pqv = pq_mod_g.PQVectors(pq=gist_pq, codes=gist_codes)
        gist_dec = gist_pqv.decode_bf16()
        gist_sq = jnp.einsum("nd,nd->n", gist_dec, gist_dec,
                             preferred_element_type=jnp.float32)
        jax.block_until_ready(gist_dec)
        log(f"gist-analog pq64 train+encode+decode (960d): "
            f"{time.time() - t0:.1f}s")

        from opensearch_jvector_tpu.index.reader import (
            _decoded_scan_scores as _dsg,
        )

        @jax.jit
        def gist_scan(qs, vs, dec, sq):
            scan = _dsg(qs, dec, sq, cos)
            top_s, top_i = jax.lax.top_k(scan, K * 5)
            cand = vs[jnp.clip(top_i, 0)]
            exact = _bcsg(qs, cand, cos)
            s, idx = jax.lax.top_k(exact, K)
            return jnp.take_along_axis(top_i, idx, axis=1), s

        gist_ids, _ = gist_scan(gq_d, gv_d, gist_dec, gist_sq)
        np.asarray(gist_ids)
        gist_ms = timed_batched(
            lambda qs, vs, dec, sq: gist_scan(qs, vs, dec, sq)[0],
            gq_d, gv_d, gist_dec, gist_sq,
        )
        gist_truth = ground_truth_topk(gq_d, gv_d, K, cos)
        gist_rec = recall_at_k(np.asarray(gist_ids), gist_truth, K)
        log(f"gist-analog 960d angular pq64 scan+rerank: {gist_ms:.4f} "
            f"ms/query batched, recall@{K}={gist_rec:.4f}")
        extra["gist960_ms_per_query_batched"] = round(gist_ms, 4)
        extra["gist960_recall_at_k"] = round(float(gist_rec), 4)

        # codes-only memory-tight cell: at 960d the decoded cache costs
        # 2*d = 1920 B/vec vs M = 64 B of codes; the scan then scores the
        # raw codes through per-query lookup tables (ops/adc.lookup_scan,
        # the Triton kernel on a GPU)
        gq5 = (grng.standard_normal((512, glat)).astype(np.float32) @ ga
               + 0.05 * grng.standard_normal((512, gdim)).astype(np.float32))

        @jax.jit
        def lut_codes_scan(qs, codes):
            pqv = pq_mod_g.PQVectors(pq=gist_pq, codes=codes)
            return jax.lax.top_k(pqv.score_scan(qs, cos), K)[1]

        lut_ms = timed_batched(lut_codes_scan, jnp.asarray(gq5), gist_codes)
        log(f"gist-analog codes-only LUT-ADC scan (Q=512): {lut_ms:.4f} "
            f"ms/query, device {gist_codes.shape[1]} B/vec (vs {2 * gdim} "
            f"B/vec decoded cache)")
        extra["gist960_codes_only_lut_ms_per_query"] = round(lut_ms, 4)
        extra["gist960_codes_only_bytes_per_vec"] = int(
            gist_codes.shape[1])

    def sec_gaussian():
        # adversarial i.i.d. gaussian corpus — same shapes, no new compiles
        gv_np, gq_np = make_data(np.random.default_rng(11), "gaussian", N, Q)
        g_vectors, g_queries = jnp.asarray(gv_np), jnp.asarray(gq_np)
        t0 = time.time()
        g_graph = GraphIndexBuilder(
            dim=DIM, max_degree=48, beam_width=100, batch_size=BATCH
        ).build(g_vectors, simf)
        log(f"gaussian build(warm): {time.time() - t0:.1f}s")
        g_res = run(g_graph, g_queries, g_vectors)
        g_truth = ground_truth_topk(g_queries, g_vectors, K, simf)
        g_rec = recall_at_k(np.asarray(g_res.ids), g_truth, K)
        g_ms = timed_batched(
            lambda qs, adj, live, ent, vec: searcher.search(
                adj, live, ent, qs, params, simf, vectors=vec,
            ).ids,
            g_queries, g_graph.adjacency, g_graph.live, g_graph.entry,
            g_vectors,
        )
        log(f"gaussian graph tier: recall@{K}={g_rec:.4f}, "
            f"{g_ms:.4f} ms/query batched (distance concentration caps "
            f"graph recall on i.i.d. gaussian; production routes this "
            f"config through the scan tier below)")
        extra["gaussian_graph_recall_at_k"] = round(float(g_rec), 4)
        extra["gaussian_graph_ms_per_query"] = round(g_ms, 4)

        # tuned graph-tier point: the search-effort (ef, overquery)
        # ladder — record the first config reaching recall >= 0.95
        for t_ef, t_oq in ((300, 10), (600, 20), (1200, 40)):
            if over_budget("gaussian tuned ladder"):
                break
            t_params = SearchParams(k=K, ef_search=t_ef,
                                    overquery_factor=t_oq)
            t_res = searcher.search(
                g_graph.adjacency, g_graph.live, g_graph.entry,
                g_queries, t_params, simf, vectors=g_vectors,
            )
            t_rec = recall_at_k(np.asarray(t_res.ids), g_truth, K)
            if t_rec >= 0.95 or (t_ef, t_oq) == (1200, 40):
                t_ms = timed_batched(
                    lambda qs, adj, live, ent, vec: searcher.search(
                        adj, live, ent, qs, t_params, simf, vectors=vec,
                    ).ids,
                    g_queries, g_graph.adjacency, g_graph.live,
                    g_graph.entry, g_vectors,
                )
                log(f"gaussian graph tier tuned (ef={t_ef}, "
                    f"overquery={t_oq}): recall@{K}={t_rec:.4f}, "
                    f"{t_ms:.4f} ms/query batched")
                extra["gaussian_graph_tuned_ef"] = t_ef
                extra["gaussian_graph_tuned_overquery"] = t_oq
                extra["gaussian_graph_tuned_recall_at_k"] = round(
                    float(t_rec), 4)
                extra["gaussian_graph_tuned_ms_per_query"] = round(t_ms, 4)
                break

        # scan-tier form for this config: decoded-bf16 scan + exact
        # rerank.
        from opensearch_jvector_tpu.index.reader import (
            _decoded_scan_scores as _dscan_g,
        )
        from opensearch_jvector_tpu.models import pq as pq_mod
        from opensearch_jvector_tpu.ops.distances import (
            batched_candidate_scores,
        )

        g_pq = pq_mod.train_pq(g_vectors, simf)
        g_codes = pq_mod.encode(g_pq, g_vectors, simf)
        g_pqv = pq_mod.PQVectors(pq=g_pq, codes=g_codes)
        g_dec = g_pqv.decode_bf16()
        g_sq = jnp.einsum("nd,nd->n", g_dec, g_dec,
                          preferred_element_type=jnp.float32)

        @jax.jit
        def g_scan_search(qs, vs, dec, sq):
            scan = _dscan_g(qs, dec, sq, simf)
            top_s, top_i = jax.lax.top_k(scan, K * 5)
            cand = vs[jnp.clip(top_i, 0)]
            exact = batched_candidate_scores(qs, cand, simf)
            s, idx = jax.lax.top_k(exact, K)
            return jnp.take_along_axis(top_i, idx, axis=1), s

        g_ids, _ = g_scan_search(g_queries, g_vectors, g_dec, g_sq)
        np.asarray(g_ids)
        gs_ms = timed_batched(
            lambda qs, vs, dec, sq: g_scan_search(qs, vs, dec, sq)[0],
            g_queries, g_vectors, g_dec, g_sq,
        )
        gs_rec = recall_at_k(np.asarray(g_ids), g_truth, K)
        log(f"gaussian production (scan tier): recall@{K}={gs_rec:.4f}, "
            f"{gs_ms:.4f} ms/query batched")
        extra["gaussian_recall_at_k"] = round(float(gs_rec), 4)
        extra["gaussian_ms_per_query_batched"] = round(gs_ms, 4)

    # (section, estimated cost in seconds, env gate). Ordered by
    # information value: the >=4M graph tier first (the at-scale
    # regression canary), sections with older recorded numbers last.
    # Estimates: builds at the measured warm rate plus fixed
    # gen/GT/search costs.
    warm_rate = extra.get("build_vec_per_s_warm") or (N / build_cold)
    if tier1_manifest():
        est_graph = 150  # prebuilt: reopen + compiles + serving passes
    else:
        n1_est = int(os.environ.get("BENCH_N_TIER1", 1 << 22))
        est_graph = n1_est / warm_rate * 1.15 + 140
    n10_est = int(os.environ.get("BENCH_N_TIER2", 10_000_000))
    est_10m = n10_est / 1e6 * 57 + 60
    sections = [
        ("graph tier", sec_graph_tier, est_graph,
         int(os.environ.get("BENCH_N_TIER1", 1)) > 0),
        ("scalar+nvq cells", sec_scalar_nvq, 90, True),
        ("config4 deep-analog", sec_config4, 200, True),
        ("rest qps", sec_rest_qps, 75, True),
        ("gaussian scan-bound", sec_gaussian_scan, 170, True),
        ("per-op", sec_per_op, 110, True),
        ("pq", sec_pq, 60, True),
        ("merge", sec_merge, 60, True),
        ("10M flat on_disk", sec_10m_flat, est_10m,
         int(os.environ.get("BENCH_N_TIER2", 1)) > 0),
        ("gist-analog 960d", sec_gist, 110,
         int(os.environ.get("BENCH_GIST", 1)) > 0),
        ("gaussian", sec_gaussian, 280, True),
    ]
    # BENCH_ONLY="graph tier,rest qps": run exactly the named sections
    # (dev/validation harness — skips the need() affordability gate but
    # keeps over_budget and crash guards)
    only = {s.strip() for s in os.environ.get("BENCH_ONLY", "").split(",")
            if s.strip()}
    if FULL:
        for name, fn, est, enabled in sections:
            if only:
                if name not in only:
                    continue
            elif not enabled or over_budget(name) or not need(name, est):
                continue
            t_sec = time.time()
            try:
                fn()
            except Exception:
                import traceback
                tb = traceback.format_exc()
                log(f"SECTION CRASH [{name}] (continuing): {tb[-700:]}")
                extra.setdefault("section_crashes", {})[name] = (
                    tb.strip().split(chr(10))[-1][:200]
                )
            log(f"[section {name}: {time.time() - t_sec:.1f}s, "
                f"elapsed {time.time() - _T0:.0f}s]")

    emit()


if __name__ == "__main__":
    if os.environ.get("BENCH_PREP_TIER1") == "1":
        # offline prep (no watchdog, no budget, no JSON record): build +
        # persist the graph-tier index sec_graph_tier will serve from
        prep_tier1()
        raise SystemExit(0)
    if os.environ.get("BENCH_PREP_GT"):
        prep_tier1_gt()
        raise SystemExit(0)
    signal.signal(signal.SIGTERM, _on_sigterm)
    threading.Thread(target=_watchdog, daemon=True).start()
    try:
        main()
    except BaseException:
        # Last resort: emit whatever record exists (headline if it
        # completed, the explicit incomplete-record otherwise).
        import traceback

        tb = traceback.format_exc()
        log(f"BENCH FAILED: {tb[-700:]}")
        extra["fatal_error"] = tb.strip().split(chr(10))[-1][:300]
        emit()
        raise SystemExit(1)
    emit()
