"""Construction microbenchmark (FormatBenchmarkConstructionWithRandomVectors
analog) — index-build vectors/sec plus incremental-merge vs full-rebuild
timing (the reference's headline merge-time charts, README.md:163-174).

  python benchmarks/bench_construction.py --n 50000 --dim 128
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
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--m", type=int, default=32)
    ap.add_argument("--delta", type=int, default=5_000,
                    help="delta inserts for the incremental-merge timing")
    ap.add_argument("--data", default="sift")
    args = ap.parse_args()

    import jax.numpy as jnp

    from benchmarks.datasets import make_dataset
    from opensearch_jvector_tpu.models.builder import GraphIndexBuilder
    from opensearch_jvector_tpu.ops.distances import SimilarityFunction

    simf = SimilarityFunction.EUCLIDEAN
    v_np, _ = make_dataset(args.data, args.n + args.delta, args.dim, 1)
    base = jnp.asarray(v_np[: args.n])
    full = jnp.asarray(v_np)

    builder = GraphIndexBuilder(dim=args.dim, max_degree=args.m,
                                beam_width=100, batch_size=1024)
    t0 = time.time()
    graph = builder.build(base, simf, capacity=args.n + args.delta)
    build_s = time.time() - t0

    # incremental: delta-insert into the existing graph (leading-merge path)
    t0 = time.time()
    g2 = builder.add_nodes(
        graph, full, np.arange(args.n, args.n + args.delta), simf
    )
    g2 = builder.cleanup(g2, full, simf)
    incr_s = time.time() - t0

    # full rebuild over everything (what a non-incremental merge costs)
    builder2 = GraphIndexBuilder(dim=args.dim, max_degree=args.m,
                                 beam_width=100, batch_size=1024)
    t0 = time.time()
    builder2.build(full, simf)
    rebuild_s = time.time() - t0

    print(json.dumps({
        "bench": "construction",
        "n": args.n, "dim": args.dim, "delta": args.delta,
        "build_s": round(build_s, 1),
        "build_vectors_per_s": round(args.n / build_s, 1),
        "incremental_merge_s": round(incr_s, 1),
        "full_rebuild_s": round(rebuild_s, 1),
        "incremental_speedup": round(rebuild_s / max(incr_s, 1e-9), 2),
    }))


if __name__ == "__main__":
    main()
