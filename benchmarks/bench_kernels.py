"""Kernel timings on the card: each scan-tier kernel form against the others.

    python benchmarks/bench_kernels.py [--rounds 7] [--out PATH]

1. ADC lookup-table scan at Q=512, N=262,144, M=64, K=256: the one-hot
   matmul form (`onehot_scan` below, as XLA compiles it), the XLA
   gather-and-sum form `ops/adc.lookup_scan_xla`, and the Pallas
   Triton-route kernel `ops/pallas/adc_gpu.adc_scan_triton` at several
   block shapes.
   `adc_shapes`: the Triton kernel against the XLA gather form at the
   other (M, K) the PQ schedule produces (`ADC_SHAPES`), same Q and N.
2. Top-k over [512, 2^20] f32 at k=50: `lax.approx_max_k`, `lax.top_k`
   and `ops/topk.exact_topk_wide`.
3. End to end: `VectorIndex.search` of 1,024 queries (k=10) on a
   200,000-vector in_memory PQ scan-tier segment, with each ADC form and
   top-k rule swapped into the reader's scan block.

Forms run in alternating order, round by round (A B C, C B A, ...), all in
this one process; each time is host wall-clock around a call that ends in
`block_until_ready` (or returns host arrays). Prints one JSON object per
line; the card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def emit(rec: dict, out) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if out is not None:
        out.write(line + "\n")
        out.flush()


def alternate(fns: dict, rounds: int) -> dict:
    """{name: callable} -> {name: [seconds per round]}, order alternating."""
    names = list(fns)
    times = {n: [] for n in names}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            t0 = time.perf_counter()
            fns[n]()
            times[n].append(time.perf_counter() - t0)
    return times


def summarize(times: dict) -> dict:
    return {n: {"median_ms": statistics.median(t) * 1e3,
                "min_ms": min(t) * 1e3, "rounds": len(t)}
            for n, t in times.items()}


def warm(fns: dict, out, section: str) -> dict:
    """Run each form once (compile); drop forms that fail to compile."""
    ok = {}
    for n, f in fns.items():
        t0 = time.perf_counter()
        try:
            f()
        except Exception as e:  # noqa: BLE001 — a refused config is a result
            emit({"section": section, "form": n,
                  "error": f"{type(e).__name__}: {str(e)[:400]}"}, out)
            continue
        emit({"section": section, "form": n,
              "first_call_s": time.perf_counter() - t0}, out)
        ok[n] = f
    return ok


def onehot_scan(luts, codes):
    """The scan as one-hot matmuls per subspace (f32 tables, the matrix
    unit accumulates): sum_m onehot(codes[:, m]) @ luts[:, m, :].T."""
    import jax
    import jax.numpy as jnp

    q, m, k = luts.shape
    codes = codes.astype(jnp.int32)

    def body(mi, acc):
        onehot = jax.nn.one_hot(codes[:, mi], k, dtype=jnp.float32)
        return acc + jax.lax.dot_general(
            luts[:, mi, :], onehot, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32)

    return jax.lax.fori_loop(0, m, body,
                             jnp.zeros((q, codes.shape[0]), jnp.float32))


TRITON_CONFIGS = ((4, 512, 4), (2, 512, 4), (2, 1024, 4), (4, 1024, 4),
                  (8, 512, 4), (4, 512, 8), (4, 256, 4), (1, 1024, 4),
                  (2, 256, 2), (4, 512, 2))


def adc_section(rounds: int, out) -> None:
    import jax
    import jax.numpy as jnp

    from opensearch_jvector_tpu.ops import adc as adc_ops
    from opensearch_jvector_tpu.ops.pallas.adc_gpu import adc_scan_triton

    q, n, m, k = 512, 262_144, 64, 256
    rng = np.random.default_rng(0)
    luts = jnp.asarray(rng.random((q, m, k), dtype=np.float32))
    codes = jnp.asarray(rng.integers(0, k, (n, m), dtype=np.uint8))
    onehot = jax.jit(onehot_scan)
    fns = {
        "onehot_matmul_xla": lambda: onehot(luts, codes),
        "gather_sum_xla": lambda: adc_ops.lookup_scan_xla(luts, codes),
    }
    for bq, bn, nw in TRITON_CONFIGS:
        fns[f"triton_bq{bq}_bn{bn}_w{nw}"] = (
            lambda bq=bq, bn=bn, nw=nw: adc_scan_triton(
                luts, codes, block_q=bq, block_n=bn, num_warps=nw))
    fns = {name: (lambda f=f: f().block_until_ready())
           for name, f in fns.items()}
    fns = warm(fns, out, "adc")
    ref = np.asarray(adc_ops.lookup_scan_xla(luts, codes))
    for name in list(fns):
        if name.startswith("triton"):
            got = np.asarray(adc_scan_triton(
                luts, codes, **_triton_kw(name)))
            err = float(np.max(np.abs(got - ref) / ref))
            emit({"section": "adc", "form": name,
                  "max_rel_err_vs_gather": err}, out)
    oh = np.asarray(onehot(luts, codes))
    emit({"section": "adc", "form": "onehot_matmul_xla",
          "max_rel_err_vs_gather": float(np.max(np.abs(oh - ref)
                                                / ref))}, out)
    del ref, oh
    emit({"section": "adc", "shape": [q, n, m, k],
          "times": summarize(alternate(fns, rounds))}, out)
    jax.clear_caches()


# (M, K) beyond the sift-128 default: 960-d (M=192, padded to 256), 300-d
# (M=100), 64-d (M=32), an odd M, and K < 256 (a small training set).
ADC_SHAPES = ((192, 256), (100, 256), (32, 256), (7, 256), (12, 16))


def adc_shapes_section(rounds: int, out) -> None:
    import jax
    import jax.numpy as jnp

    from opensearch_jvector_tpu.ops import adc as adc_ops
    from opensearch_jvector_tpu.ops.pallas.adc_gpu import adc_scan_triton

    q, n = 512, 262_144
    rng = np.random.default_rng(1)
    for m, k in ADC_SHAPES:
        luts = jnp.asarray(rng.random((q, m, k), dtype=np.float32))
        codes = jnp.asarray(rng.integers(0, k, (n, m), dtype=np.uint8))
        fns = {
            "gather_sum_xla": lambda: adc_ops.lookup_scan_xla(
                luts, codes).block_until_ready(),
            "triton": lambda: adc_scan_triton(luts, codes).block_until_ready(),
        }
        section = f"adc_m{m}_k{k}"
        fns = warm(fns, out, section)
        if "triton" in fns:
            ref = np.asarray(adc_ops.lookup_scan_xla(luts, codes))
            got = np.asarray(adc_scan_triton(luts, codes))
            emit({"section": section, "form": "triton",
                  "max_rel_err_vs_gather": float(np.max(np.abs(got - ref)
                                                        / ref))}, out)
            del ref, got
        emit({"section": section, "shape": [q, n, m, k],
              "times": summarize(alternate(fns, rounds))}, out)
        del luts, codes
        jax.clear_caches()


def _triton_kw(name: str) -> dict:
    parts = name.split("_")
    return {"block_q": int(parts[1][2:]), "block_n": int(parts[2][2:]),
            "num_warps": int(parts[3][1:])}


def topk_section(rounds: int, out) -> None:
    import jax
    import jax.numpy as jnp

    from opensearch_jvector_tpu.ops.topk import exact_topk_wide

    q, n, kk = 512, 1 << 20, 50
    x = jax.random.normal(jax.random.PRNGKey(0), (q, n), jnp.float32)
    forms = {
        "approx_max_k": jax.jit(
            lambda s: jax.lax.approx_max_k(s, kk, recall_target=0.99)),
        "lax_top_k": jax.jit(lambda s: jax.lax.top_k(s, kk)),
        "exact_topk_wide_4096": jax.jit(lambda s: exact_topk_wide(s, kk)),
        "exact_topk_wide_1024": jax.jit(
            lambda s: exact_topk_wide(s, kk, sub=1024)),
        "exact_topk_wide_16384": jax.jit(
            lambda s: exact_topk_wide(s, kk, sub=16384)),
    }
    fns = {name: (lambda f=f: jax.block_until_ready(f(x)))
           for name, f in forms.items()}
    fns = warm(fns, out, "topk")
    ref = np.sort(np.asarray(jax.lax.top_k(x, kk)[0]), axis=1)
    for name in fns:
        vals = np.sort(np.asarray(forms[name](x)[0]), axis=1)
        hit = np.mean([len(np.intersect1d(a, b)) / kk
                       for a, b in zip(vals, ref)])
        emit({"section": "topk", "form": name, "recall_vs_exact": hit}, out)
    emit({"section": "topk", "shape": [q, n, kk],
          "times": summarize(alternate(fns, rounds))}, out)
    del x
    jax.clear_caches()


def scan_tier_section(rounds: int, out, root: Path, n: int = 200_000,
                      nq: int = 1024) -> None:
    """End-to-end scan-tier search with each ADC form / top-k rule."""
    import functools
    import shutil

    import jax
    import jax.numpy as jnp

    from opensearch_jvector_tpu.api.config import DiskAnnConfig, SearchConfig
    from opensearch_jvector_tpu.index import reader as reader_mod
    from opensearch_jvector_tpu.index.index import VectorIndex
    from opensearch_jvector_tpu.ops import adc as adc_ops
    from opensearch_jvector_tpu.ops.distances import SimilarityFunction
    from opensearch_jvector_tpu.ops.pallas.adc_gpu import adc_scan_triton
    from opensearch_jvector_tpu.ops.topk import exact_topk_wide
    from opensearch_jvector_tpu.utils.ground_truth import (
        ground_truth_topk,
        recall_at_k,
    )

    import chip_smoke

    gen = chip_smoke.SiftLike(5)
    v = gen.rows(n)
    queries = gen.rows(nq)
    shutil.rmtree(root, ignore_errors=True)
    cfg = DiskAnnConfig(dim=128, similarity=SimilarityFunction.EUCLIDEAN,
                        index_type="flat", quantization_type="pq")
    idx = VectorIndex(root, cfg)
    idx.add_batch(np.arange(n), v)
    idx.flush()
    sc = SearchConfig(k=10, ef_search=100)
    truth = ground_truth_topk(queries, v, 10, SimilarityFunction.EUCLIDEAN)

    scans = {
        "onehot": onehot_scan,
        "gather": adc_ops.lookup_scan_xla,
        "triton": adc_scan_triton,
    }
    topks = {
        "exactwide4096": lambda s, r: exact_topk_wide(s, min(r, s.shape[1])),
        "exactwide1024": lambda s, r: exact_topk_wide(
            s, min(r, s.shape[1]), sub=1024),
        "laxtopk": lambda s, r: jax.lax.top_k(s, min(r, s.shape[1])),
    }

    def make_block(scan, topk):
        @functools.partial(jax.jit, static_argnames=("simf_id", "r"))
        def block(luts, codes, valid, simf_id, r):
            vals = scan(luts, codes)
            scores = adc_ops.adc_value_to_score(
                vals, SimilarityFunction(simf_id))
            scores = jnp.where(valid[None, :], scores, -jnp.inf)
            return topk(scores, r)
        return block

    original = reader_mod._adc_block_topr
    fns = {}
    for sn, scan in scans.items():
        for tn, topk in topks.items():
            block = make_block(scan, topk)

            def run(block=block):
                reader_mod._adc_block_topr = block
                try:
                    return idx.search(queries, sc)
                finally:
                    reader_mod._adc_block_topr = original
            fns[f"{sn}+{tn}"] = run
    fns = warm(fns, out, "scan_tier")
    for name, f in fns.items():
        emit({"section": "scan_tier", "form": name,
              "recall_at_10": recall_at_k(f().doc_ids, truth, 10)}, out)
    emit({"section": "scan_tier", "n": n, "queries": nq,
          "times": summarize(alternate(fns, rounds))}, out)
    idx.close()
    shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--out", default=str(REPO / "chiprun_out"
                                         / "bench_kernels.jsonl"))
    ap.add_argument("--sections", default="adc,adc_shapes,topk,scan_tier")
    args = ap.parse_args(argv)

    import jax

    from opensearch_jvector_tpu.utils.compile_cache import (
        configure_compile_cache,
    )

    configure_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench_kernels: needs a GPU, JAX runs on "
                         f"{dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as out:
        emit({"device": dev.device_kind, "platform": dev.platform,
              "card": card, "jax": jax.__version__}, out)
        sections = args.sections.split(",")
        if "adc" in sections:
            adc_section(args.rounds, out)
        if "adc_shapes" in sections:
            adc_shapes_section(args.rounds, out)
        if "topk" in sections:
            topk_section(args.rounds, out)
        if "scan_tier" in sections:
            scan_tier_section(args.rounds, out,
                              REPO / ".smoke_data" / "bench_kernels")
    return 0


if __name__ == "__main__":
    sys.exit(main())
