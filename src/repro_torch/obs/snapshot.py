"""Uniform serving-metrics snapshot schema.

Counterpart of ``repro.obs.snapshot``: the same keys, so a snapshot of
either package reads the same.  The serve CLI's periodic stats and the
smoke run embed this one dict shape for an engine's counters and latency
distributions.  The port's ``prefill_s``/``decode_s`` sums are not part
of the schema's fixed keys; a caller that wants them passes them as
``extra``.

Schema (``"schema": "repro.obs/v1"``): flat counters straight off
``EngineStats`` plus three latency blocks —

    {"mean_s": …, "p50_s": …, "p95_s": …, "p99_s": …, "count": n}

for ``ttft`` / ``ttft_queue`` / ``ttft_compute`` / ``itl``.  Quantiles
come from the O(1)-memory streaming histograms, so they are available
for any run length without retaining raw samples.
"""
from __future__ import annotations

from typing import Optional


def _latency_block(series) -> dict:
    h = series.hist
    return {"mean_s": h.mean, "p50_s": h.quantile(0.50),
            "p95_s": h.quantile(0.95), "p99_s": h.quantile(0.99),
            "count": h.count}


def engine_snapshot(eng, wall_s: Optional[float] = None,
                    **extra) -> dict:
    """The uniform metrics snapshot of one ``serving.Engine`` (or of a
    bare ``EngineStats`` via ``stats_snapshot``).  ``wall_s`` overrides
    the stats-accrued wall clock (benchmarks time their own window);
    ``extra`` keys are merged verbatim (a caller's own fields, e.g. the
    port's ``prefill_s``/``decode_s``).  The ``paged`` block reads the
    engine's ``serving.paged.PagedDKV``."""
    snap = stats_snapshot(eng.stats, wall_s=wall_s)
    pg = getattr(eng, "pager", None)
    if pg is not None:
        snap["paged"] = {
            "page": pg.page, "pool_pages": pg.num_pages,
            "tail_pool_pages": pg.num_tail_pages,
            "free_pages": pg.alloc.free_pages,
            "free_tail_pages": pg.talloc.free_pages,
            "prefix_entries": len(pg.prefix) if pg.prefix is not None
            else 0,
        }
    snap.update(extra)
    return snap


def stats_snapshot(s, wall_s: Optional[float] = None) -> dict:
    wall = s.wall_s if wall_s is None else wall_s
    return {
        "schema": "repro.obs/v1",
        "prefills": s.prefills,
        "prefill_batches": s.prefill_batches,
        "decode_steps": s.decode_steps,
        "blocks": s.blocks,
        "tokens_out": s.tokens_out,
        "tail_folds": s.tail_folds,
        "stopped_eos": s.stopped_eos,
        "stopped_budget": s.stopped_budget,
        "prefix_hits": s.prefix_hits,
        "prefix_misses": s.prefix_misses,
        "stalls": s.stalls,
        "prefill_inflight_peak": s.prefill_inflight_peak,
        "wall_s": wall,
        "tokens_per_s": s.tokens_out / max(wall, 1e-9),
        "ttft": _latency_block(s.ttft_s),
        "ttft_queue": _latency_block(s.ttft_queue_s),
        "ttft_compute": _latency_block(s.ttft_compute_s),
        "itl": _latency_block(s.itl_s),
    }
