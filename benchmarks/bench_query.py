"""Query microbenchmark (JMH FormatBenchmarkQueryWithRandomVectors analog).

Parameter matrix mirrors the reference harness (@Param codecs
{jvector_not_quantized, jvector_quantized}, docs, dims —
FormatBenchmarkQueryWithRandomVectors.java:54-58) plus dataset kind.

  python benchmarks/bench_query.py --n 100000 --dim 128 --codec pq \
      --data sift --batch 512 --ef 100
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from opensearch_jvector_tpu.utils.compile_cache import configure_compile_cache

configure_compile_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--ef", type=int, default=100)
    ap.add_argument("--m", type=int, default=48)
    ap.add_argument("--codec", choices=["fp32", "pq"], default="fp32")
    ap.add_argument("--data", choices=["sift", "gaussian", "clustered"],
                    default="sift")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from benchmarks.datasets import make_dataset
    from opensearch_jvector_tpu.models import pq as pq_mod
    from opensearch_jvector_tpu.models import searcher
    from opensearch_jvector_tpu.models.builder import GraphIndexBuilder
    from opensearch_jvector_tpu.models.searcher import SearchParams
    from opensearch_jvector_tpu.ops.distances import SimilarityFunction
    from opensearch_jvector_tpu.utils.ground_truth import (
        ground_truth_topk, recall_at_k,
    )

    simf = SimilarityFunction.EUCLIDEAN
    v_np, q_np = make_dataset(args.data, args.n, args.dim, args.batch)
    v, q = jnp.asarray(v_np), jnp.asarray(q_np)

    t0 = time.time()
    builder = GraphIndexBuilder(dim=args.dim, max_degree=args.m,
                                beam_width=100, batch_size=1024)
    kwargs = {"vectors": v}
    build_pq = None
    if args.codec == "pq":
        pq = pq_mod.train_pq(v, simf)
        pqv = pq_mod.PQVectors(pq=pq, codes=pq_mod.encode(pq, v, simf))
        build_pq = {"codes": pqv.codes, "codebooks": pq.codebooks,
                    "center": pq.center}
        kwargs.update(pq_codes=pqv.codes, pq_codebooks=pq.codebooks,
                      pq_center=pq.center)
    graph = builder.build(v, simf, pq=build_pq)
    build_s = time.time() - t0

    params = SearchParams(k=args.k, ef_search=args.ef, expansions_per_iter=8)

    def run():
        res = searcher.search(graph.adjacency, graph.live, graph.entry, q,
                              params, simf, has_tombstones=False, **kwargs)
        jax.block_until_ready(res.ids)
        return res

    res = run()
    truth = ground_truth_topk(q, v, args.k, simf)
    rec = recall_at_k(np.asarray(res.ids), truth, args.k)

    t0 = time.time()
    for _ in range(args.iters):
        run()
    dt = (time.time() - t0) / args.iters
    print(json.dumps({
        "bench": "query",
        "codec": args.codec, "data": args.data, "n": args.n, "dim": args.dim,
        "batch": args.batch, "ef": args.ef,
        "build_s": round(build_s, 1),
        "ms_per_query": round(dt / args.batch * 1000, 4),
        "qps": round(args.batch / dt, 1),
        f"recall@{args.k}": round(rec, 4),
    }))


if __name__ == "__main__":
    main()
