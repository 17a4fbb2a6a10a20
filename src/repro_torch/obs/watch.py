"""Compile watch: what the port compiles at run time, counted by phase.

Counterpart of ``repro.obs.watch``.  The port has no JIT; its
counterparts of a recompile are

* ``kind="cuda_graph"`` — a fused decode block captured as a CUDA graph
  (``serving.graphs.BlockGraphs``; warm-up included in its seconds);
* ``kind="nvcc"`` — a kernel source compiled by ``kernels.build``.

Each is attributed to the innermost active
:func:`~repro_torch.obs.trace.phase_scope` (``decode``, ``prefill``, …),
so a capture storm — a graph key that stops hashing stably, one capture
per block instead of one per shape — shows as captures growing with the
steps served.  Counters land in the GLOBAL registry:

* ``compiles_total{kind, phase}``         — captures / builds
* ``compile_seconds_total{kind, phase}``  — host wall seconds in them
"""
from __future__ import annotations

from typing import Optional

from .registry import GLOBAL, MetricsRegistry
from .trace import current_phase

KINDS = ("cuda_graph", "nvcc")


def record_compile(kind: str, seconds: float, n: int = 1,
                   registry: MetricsRegistry = GLOBAL) -> None:
    """Count ``n`` compiles of ``kind`` that took ``seconds`` of host wall
    time under the current phase."""
    if kind not in KINDS:
        raise ValueError(f"compile kind must be one of {KINDS}, got "
                         f"{kind!r}")
    phase = current_phase()
    registry.counter("compiles_total",
                     "run-time compiles (CUDA-graph captures, nvcc builds)",
                     kind=kind, phase=phase).inc(n)
    registry.counter("compile_seconds_total",
                     "host wall seconds spent in run-time compiles",
                     kind=kind, phase=phase).add(float(seconds))


def compile_stats(registry: MetricsRegistry = GLOBAL,
                  kind: Optional[str] = None) -> dict:
    """{phase: {"compiles": n, "seconds": s}} of the watch counters, summed
    over kinds (or of ``kind`` alone)."""
    out: dict = {}
    for m in registry.metrics():
        if m.name not in ("compiles_total", "compile_seconds_total") \
                or (kind is not None and m.labels.get("kind") != kind):
            continue
        row = out.setdefault(m.labels.get("phase", "other"),
                             {"compiles": 0, "seconds": 0.0})
        row["compiles" if m.name == "compiles_total" else "seconds"] \
            += m.value
    return out
