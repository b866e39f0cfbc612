"""Test harness config: force an 8-device virtual CPU mesh.

Multi-chip hardware is unavailable in CI; sharding paths are validated on a
virtual host-platform mesh (same XLA collectives, same program). XLA_FLAGS
is read lazily at CPU-client creation, so setting it here (before the
first device use) still takes effect.

No test needs a GPU: the Pallas kernel runs in interpret mode here, and
`chip_smoke.py` checks the compiled kernels on the card.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

import pytest

from opensearch_jvector_tpu.utils.compile_cache import configure_compile_cache

# CPU compiles of the jitted search/build programs take 5-15s each; the
# persistent cache keeps them across test runs.
configure_compile_cache()
assert len(jax.devices()) >= 8, (
    f"test harness needs an 8-device CPU mesh, got {jax.devices()}"
)


def pytest_collection_modifyitems(config, items):
    """`slow` marker: reference-scale / torture cells skipped by default on
    the single-core CI host (RUN_SLOW=1 runs everything — the nightly/IT
    tier, like the reference's gradle integTest split)."""
    if os.environ.get("RUN_SLOW") == "1":
        return
    skip = pytest.mark.skip(reason="slow tier: set RUN_SLOW=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
