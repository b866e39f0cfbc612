"""Build-throughput experiment matrix.

Sweeps the builder's overflow-phase levers. Which build phase dominates
on the H100 is not profiled yet.

Usage (each config builds the same corpus twice; the second, warm build is
the reported number):

    python benchmarks/throughput_probe.py [N] [DIM]

Prints one line per config: name, warm build seconds, vec/s, recall@10.
"""

from __future__ import annotations

import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax.numpy as jnp  # noqa: E402

from opensearch_jvector_tpu.models.builder import GraphIndexBuilder  # noqa: E402
from opensearch_jvector_tpu.models import searcher as searcher_mod  # noqa: E402
from opensearch_jvector_tpu.ops.distances import SimilarityFunction  # noqa: E402
from opensearch_jvector_tpu.utils.ground_truth import (  # noqa: E402
    ground_truth_topk,
    recall_at_k,
)


def make_sift_like(rng, n, d, latent=16):
    basis = rng.standard_normal((latent, d)).astype(np.float32)
    z = rng.standard_normal((n, latent)).astype(np.float32)
    return (z @ basis + 0.05 * rng.standard_normal((n, d))).astype(np.float32)


def run_config(name: str, vectors, queries, truth, **kwargs):
    simf = SimilarityFunction.EUCLIDEAN
    vdev = jnp.asarray(vectors)
    best = None
    for rep in range(2):  # rep 0 warms compiles; rep 1 is the number
        b = GraphIndexBuilder(vectors.shape[1], max_degree=32,
                              beam_width=100, **kwargs)
        t0 = time.time()
        g = b.build(vdev, simf)
        dt = time.time() - t0
        best = dt
    res = searcher_mod.search(
        g.adjacency, g.live, g.entry, jnp.asarray(queries),
        searcher_mod.SearchParams(k=10, ef_search=100),
        simf, vectors=vdev,
    )
    rec = recall_at_k(np.asarray(res.ids), truth, 10)
    n = vectors.shape[0]
    print(f"{name:40s} warm={best:7.1f}s  {n / best:7.0f} vec/s  "
          f"recall@10={rec:.4f}", flush=True)
    phases = getattr(b.counters, "phase_s", {})
    if phases:
        tot = sum(phases.values()) or 1.0
        print("   phases: " + "  ".join(
            f"{k}={v:.1f}s({100 * v / tot:.0f}%)"
            for k, v in sorted(phases.items(), key=lambda kv: -kv[1])
        ), flush=True)
    return best


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    d = int(sys.argv[2]) if len(sys.argv) > 2 else 128
    rng = np.random.default_rng(0)
    v = make_sift_like(rng, n, d)
    q = make_sift_like(rng, 64, d)
    truth = ground_truth_topk(q, v, 10, SimilarityFunction.EUCLIDEAN)

    run_config("baseline (auto batch)", v, q, truth)
    run_config("overflow_chunk=4x", v, q, truth, overflow_chunk=65536)
    run_config("batch=32768", v, q, truth, batch_size=32768)
    run_config("batch=32768 + overflow 2x", v, q, truth,
               batch_size=32768, overflow_chunk=65536)
    run_config("extra_width=16", v, q, truth, extra_width=16)
    run_config("E=16", v, q, truth, construction_expansions=16)


if __name__ == "__main__":
    main()
