"""``repro_torch.obs`` — host-side observability: metrics, tracing,
exposition (counterpart of ``repro.obs``).

One hard rule everywhere: instrumentation is PURELY host-side — no torch
import in this package, no device op, no new device input, no new
readback — so served tokens are byte-identical with observability on or
off, and the engine makes as many host reads of the device either way.

* ``registry``   — :class:`MetricsRegistry` of counters / gauges /
                   O(1)-memory log-bucketed streaming histograms
                   (p50/p95/p99 without retaining samples);
* ``trace``      — request-lifecycle spans → Chrome trace-event JSON
                   (Perfetto-loadable), plus the phase stack;
* ``watch``      — the compile watch (CUDA-graph captures and nvcc
                   builds: count + wall time per phase);
* ``exposition`` — Prometheus text format + JSON snapshot writers (and
                   the strict parser the tests gate on);
* ``snapshot``   — the uniform ``repro.obs/v1`` engine-metrics schema.

Names, label sets and the snapshot schema are the reference's, so one
dashboard reads either package.  ``Observability`` bundles one engine's
registry and tracer; construct it with ``trace=True`` to record spans
(``serving.Engine(obs=…)``), default off.
"""
from __future__ import annotations

from typing import Optional

from .exposition import (parse_prometheus, to_prometheus, write_json_snapshot,
                         write_prometheus)
from .registry import (BUCKETS_PER_DECADE, GLOBAL, RESERVOIR_CAP, Counter,
                       Gauge, Histogram, LatencySeries, MetricsRegistry,
                       bucket_label, global_registry)
from .snapshot import engine_snapshot, stats_snapshot
from .trace import (NULL_SPAN, Span, Tracer, current_phase, phase_scope,
                    validate_trace)
from .watch import compile_stats, record_compile

__all__ = [
    "BUCKETS_PER_DECADE", "Counter", "GLOBAL", "Gauge", "Histogram",
    "LatencySeries", "MetricsRegistry", "NULL_SPAN", "Observability",
    "RESERVOIR_CAP", "Span", "Tracer", "bucket_label", "compile_stats",
    "current_phase", "engine_snapshot", "global_registry",
    "parse_prometheus", "phase_scope", "record_compile", "stats_snapshot",
    "to_prometheus", "validate_trace", "write_json_snapshot",
    "write_prometheus",
]


class Observability:
    """One serving engine's observability bundle: a private metrics
    registry (``EngineStats`` and the engine's ``BlockGraphs`` mount their
    counters and histograms there) and a tracer (disabled unless
    ``trace=True``).  It holds no reference to the engine, so it closes
    no cycle that could keep a dropped engine's cache alive."""

    def __init__(self, trace: bool = False,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer(enabled=trace)
