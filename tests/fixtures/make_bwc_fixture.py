"""Freeze a BWC fixture segment at the CURRENT on-disk format version.

Run once per format bump, commit the output, never regenerate (the binary
IS the compatibility contract — mirrors the reference's qa/ upgrade suites
pinning released artifacts, qa/build.gradle:36-39):

    JAX_PLATFORMS=cpu python tests/fixtures/make_bwc_fixture.py

Writes tests/fixtures/bwc_v{FORMAT_VERSION}_segment_root/v{FORMAT_VERSION}seg
plus bwc_v{FORMAT_VERSION}_vectors.npy. test_bwc.py auto-discovers every
committed generation, so freezing vN the moment FORMAT_VERSION bumps gives
the eventual vN+1 two-hop coverage (v1->head AND vN->head) with no new test
code.

The v2 fixture uses 1-bit scalar quantization: the scalar state container
(scalar.jvtpu, quantization type bytes 3-5) is exactly what v2 added over
v1, so the fixture exercises the version-specific surface.
"""

from pathlib import Path

import numpy as np

from opensearch_jvector_tpu.api.config import DiskAnnConfig
from opensearch_jvector_tpu.api.version import FORMAT_VERSION
from opensearch_jvector_tpu.index.index import VectorIndex
from opensearch_jvector_tpu.index.scheduler import ForceMergesOnlyMergePolicy
from opensearch_jvector_tpu.ops.distances import SimilarityFunction


def main() -> None:
    fixtures = Path(__file__).parent
    root = fixtures / f"bwc_v{FORMAT_VERSION}_segment_root"
    seg_name = f"v{FORMAT_VERSION}seg"
    if (root / seg_name).exists():
        raise SystemExit(
            f"{root / seg_name} already frozen — a committed fixture must "
            "never be regenerated; bump FORMAT_VERSION first"
        )
    rng = np.random.default_rng(4242)
    vectors = rng.standard_normal((50, 8)).astype(np.float32)
    cfg = DiskAnnConfig(
        dim=8, similarity=SimilarityFunction.EUCLIDEAN, m=8,
        ef_construction=32, quantization_type="1bit",
        min_batch_size_for_quantization=16,
    )
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        idx = VectorIndex(tmp, cfg, merge_policy=ForceMergesOnlyMergePolicy())
        idx.add_batch(np.arange(50), vectors)
        flushed = idx.flush()
        import shutil

        root.mkdir(parents=True, exist_ok=True)
        shutil.copytree(Path(tmp) / flushed, root / seg_name)
    np.save(fixtures / f"bwc_v{FORMAT_VERSION}_vectors.npy", vectors)
    print(f"frozen: {root / seg_name}")


if __name__ == "__main__":
    main()
