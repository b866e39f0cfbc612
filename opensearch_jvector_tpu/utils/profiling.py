"""Phase-scoped profiling + wall-clock tracing.

The reference has no tracing framework — wall-clock timing feeds
time-valued counters (SURVEY.md §5: JVectorWriter.java:195-206,
JVectorIndexQuantization.java:97-99, JVectorReader.java:152). This keeps
that counter set (api/stats.py) and adds a device layer: a jax
profiler trace per phase, toggled by env/setting, so device timelines can
be inspected in TensorBoard/Perfetto.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import jax

from opensearch_jvector_tpu.api.stats import STATS, Counter, StatsRegistry

TRACE_DIR_ENV = "JVECTOR_TPU_TRACE_DIR"


@contextmanager
def phase(
    name: str,
    counter: Counter | None = None,
    stats: StatsRegistry = STATS,
):
    """Time a phase; optionally feed a time counter and emit a device trace.

    With JVECTOR_TPU_TRACE_DIR set, the phase body runs under
    `jax.profiler.trace` (one trace directory per phase name) and is
    annotated with a TraceAnnotation so device ops group under the phase.
    """
    trace_dir = os.environ.get(TRACE_DIR_ENV)
    t0 = time.monotonic()
    if trace_dir:
        with jax.profiler.trace(os.path.join(trace_dir, name)):
            with jax.profiler.TraceAnnotation(name):
                yield
    else:
        with jax.profiler.TraceAnnotation(name):
            yield
    if counter is not None:
        stats.increment(counter, int((time.monotonic() - t0) * 1000))
