"""JAX persistent compilation cache location.

One rule for every entry point (tests, `chip_smoke.py`, the benchmarks):
when `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and nothing
else is configured here; otherwise the cache lives in `.jax_cache` at the
root of this checkout (listed in `.gitignore`). The path is derived from
this file's location, so every process of one checkout shares it and
compiled programs are found again across runs.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"
MIN_COMPILE_TIME_SECS = 1.0  # cache anything that took at least this long


def configure_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it.

    Call before the first compilation (importing jax first is fine)."""
    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        cache_dir = env_dir
    else:
        cache_dir = str(CHECKOUT_CACHE_DIR)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    if "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS" not in os.environ:
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          MIN_COMPILE_TIME_SECS)
    return cache_dir
