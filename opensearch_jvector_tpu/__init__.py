"""opensearch_jvector_tpu — a DiskANN/Vamana vector search engine in JAX.

A brand-new JAX/XLA/Pallas implementation of the capability surface of the
OpenSearch jVector plugin (reference: opensearch-project/opensearch-jvector):
Vamana graph construction, PQ/NVQ quantization with fused-ADC search, two-phase
(approximate + rerank) beam search, incremental merge with codebook reuse,
filtered/exact/rescored/MMR search, stats, and mesh-sharded distributed search.

Layer map (mirrors SURVEY.md §7):
  ops/      — XLA and Pallas (GPU) kernels: distances, ADC, k-means, NVQ
              transcode, top-k
  models/   — Vamana graph + builder + searcher; PQ / NVQ / scalar quantizers
  index/    — segment store, writer/flush, reader/search, docmap, merge
  query/    — knn query DSL, filters, rescoring, exact scoring, MMR
  parallel/ — device-mesh sharding, distributed top-k, host pools
  api/      — settings, method schemas (disk_ann), stats/counters
  utils/    — ground truth, serialization helpers
"""

from opensearch_jvector_tpu.api.version import __version__

__all__ = [
    "__version__",
    "DiskAnnConfig",
    "SearchConfig",
    "SimilarityFunction",
    "VectorIndex",
    "ShardedVectorIndex",
    "KnnService",
    "parse_knn_query",
    "execute_knn_query",
]


def __getattr__(name):  # lazy: keep `import opensearch_jvector_tpu` light
    if name in ("DiskAnnConfig", "SearchConfig"):
        from opensearch_jvector_tpu.api import config as _c

        return getattr(_c, name)
    if name == "SimilarityFunction":
        from opensearch_jvector_tpu.ops.distances import SimilarityFunction

        return SimilarityFunction
    if name == "VectorIndex":
        from opensearch_jvector_tpu.index.index import VectorIndex

        return VectorIndex
    if name == "ShardedVectorIndex":
        from opensearch_jvector_tpu.parallel.distributed import (
            ShardedVectorIndex,
        )

        return ShardedVectorIndex
    if name == "KnnService":
        from opensearch_jvector_tpu.service.http import KnnService

        return KnnService
    if name == "parse_knn_query":
        from opensearch_jvector_tpu.query.builder import parse_knn_query

        return parse_knn_query
    if name == "execute_knn_query":
        from opensearch_jvector_tpu.query.knn import execute_knn_query

        return execute_knn_query
    raise AttributeError(name)
