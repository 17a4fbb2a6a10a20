"""Metrics registry: counters, gauges, and O(1)-memory streaming histograms.

Counterpart of ``repro.obs.registry``, with the same names, label sets
and arithmetic, so that one dashboard reads either package.  Everything
here is HOST-side Python arithmetic — no torch import, no device op, no
new device input, no readback.  That is the subsystem's one hard rule:
served tokens must stay byte-identical with observability on or off, so
instrumentation may only ever read host scalars the engine already has.

Histograms are log-bucketed: a sample ``v > 0`` lands in bucket
``floor(BUCKETS_PER_DECADE · log10 v)``, so the whole stream is a sparse
``{bucket: count}`` dict — O(number of distinct decades touched), never
O(samples) — and any quantile is answered by a cumulative walk with
relative error bounded by half a bucket width
(``10^(0.5/BUCKETS_PER_DECADE) − 1`` ≈ 5.9% at the default 20/decade).
A small capped reservoir of the most recent raw samples rides along for
the back-compat "give me the list" view (``EngineStats.itl_s`` et al.):
the reservoir is what iteration returns, while ``len()``, ``sum`` and the
quantiles come from the exact streaming state.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

#: log-bucket resolution: buckets per decade.  20 → quantile relative
#: error ≤ 10^(1/40) − 1 ≈ 5.9% (half a bucket either side).
BUCKETS_PER_DECADE = 20

#: default recent-sample reservoir capacity (per histogram)
RESERVOIR_CAP = 512

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Metric:
    """Base: a name, a help string, and one immutable label set."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels: Dict[str, str] = dict(labels or {})


class Counter(Metric):
    """Monotone-by-convention accumulator.  ``add`` accepts negative
    deltas (the serving cancel path unwinds dispatch-side counts), so this
    is a counter in the Prometheus-exposition sense, not an enforced one."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        super().__init__(name, help, labels)
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n

    add = inc

    def set(self, v) -> None:
        self.value = v


class Gauge(Metric):
    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        super().__init__(name, help, labels)
        self.value = 0

    def set(self, v) -> None:
        self.value = v

    def inc(self, n=1) -> None:
        self.value += n

    def max(self, v) -> None:
        """Ratchet: keep the high-water mark."""
        if v > self.value:
            self.value = v


class Histogram(Metric):
    """Streaming log-bucketed histogram with exact count/sum/min/max.

    Memory is O(buckets touched) + O(reservoir cap); observation is O(1).
    Non-positive samples (a 0.0 latency from two perf_counter calls in the
    same tick) land in a dedicated zero bucket ordered below every
    positive bucket, so quantiles stay well defined.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None,
                 reservoir: int = RESERVOIR_CAP):
        super().__init__(name, help, labels)
        self._buckets: Dict[int, int] = {}
        self._zero = 0                    # samples ≤ 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.recent: deque = deque(maxlen=max(1, int(reservoir)))

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= 0.0:
            self._zero += 1
        else:
            k = math.floor(BUCKETS_PER_DECADE * math.log10(v))
            self._buckets[k] = self._buckets.get(k, 0) + 1
        self.recent.append(v)

    def quantile(self, q: float) -> float:
        """The q-quantile (0 ≤ q ≤ 1) by cumulative bucket walk: the value
        returned is the geometric midpoint of the bucket holding the
        nearest-rank sample, clamped to the exact observed [min, max]."""
        if not self.count:
            return 0.0
        rank = max(1, math.ceil(q * self.count))   # nearest-rank
        if rank <= self._zero:
            return min(0.0, self.max)
        cum = self._zero
        for k in sorted(self._buckets):
            cum += self._buckets[k]
            if cum >= rank:
                mid = 10.0 ** ((k + 0.5) / BUCKETS_PER_DECADE)
                return float(min(max(mid, self.min), self.max))
        return float(self.max)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class LatencySeries:
    """Back-compat list view over a :class:`Histogram`.

    The pre-obs ``EngineStats`` kept every latency sample in an unbounded
    Python list; this keeps the list API — ``append``/``extend``,
    iteration, ``np.asarray``, truthiness — while the storage is the
    histogram's O(1) streaming state plus its capped recent-sample
    reservoir.  ``len()`` is the TOTAL observation count (the histogram
    counter), which is what preserves the ``len(itl_s) == tokens_out``
    invariant after the raw samples stop being retained; iteration yields
    only the most recent ``reservoir`` samples.
    """

    def __init__(self, hist: Histogram):
        self.hist = hist

    def append(self, v: float) -> None:
        self.hist.observe(v)

    def extend(self, vs: Iterable[float]) -> None:
        for v in vs:
            self.hist.observe(v)

    def __len__(self) -> int:
        return self.hist.count

    def __iter__(self) -> Iterator[float]:
        return iter(self.hist.recent)

    def __getitem__(self, i):
        return list(self.hist.recent)[i]

    def __array__(self, dtype=None, copy=None):
        import numpy as np
        return np.asarray(list(self.hist.recent), dtype=dtype)

    def __repr__(self) -> str:
        return (f"LatencySeries(n={self.hist.count}, "
                f"recent={len(self.hist.recent)})")

    # convenience passthroughs
    @property
    def mean(self) -> float:
        return self.hist.mean

    def quantile(self, q: float) -> float:
        return self.hist.quantile(q)


class MetricsRegistry:
    """Named metric store.  ``counter``/``gauge``/``histogram`` get or
    create the metric for (name, labels) — the same call site hits the
    same object every time, so hot-path instrumentation is one dict
    lookup.  Creation is locked (a metric may be created from another
    thread); mutation of a metric is plain arithmetic under the
    interpreter lock.
    """

    def __init__(self):
        self._metrics: Dict[Tuple[str, LabelKey], Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, labels: Dict[str, str],
             **kw) -> Metric:
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, help, labels, **kw)
                    self._metrics[key] = m
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, requested {cls.kind}")
        return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  reservoir: int = RESERVOIR_CAP, **labels) -> Histogram:
        return self._get(Histogram, name, help, labels,
                         reservoir=reservoir)

    def metrics(self) -> List[Metric]:
        return list(self._metrics.values())

    def __len__(self) -> int:
        return len(self._metrics)

    def snapshot(self) -> Dict[str, list]:
        """JSON-able view: ``{name: [{labels, ...fields}, ...]}``.
        Counters/gauges carry ``value``; histograms carry count/sum/
        min/max and the p50/p95/p99 quantiles."""
        out: Dict[str, list] = {}
        for m in self.metrics():
            if isinstance(m, Histogram):
                row = {"labels": dict(m.labels), "count": m.count,
                       "sum": m.sum,
                       "min": m.min if m.count else 0.0,
                       "max": m.max if m.count else 0.0,
                       "mean": m.mean,
                       "p50": m.quantile(0.50), "p95": m.quantile(0.95),
                       "p99": m.quantile(0.99)}
            else:
                row = {"labels": dict(m.labels), "value": m.value}
            out.setdefault(m.name, []).append(row)
        return out


#: process-global registry: decomposition telemetry, tuner counters and
#: the compile watch (CUDA-graph captures, nvcc builds) land here (they
#: are not tied to one serving engine); per-engine serving stats live in
#: each EngineStats' registry.  The port's own: it shares nothing with
#: the JAX package's.
GLOBAL = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    return GLOBAL


def bucket_label(*dims: int) -> str:
    """Power-of-two shape-bucket label (mirrors ``tune.shape_bucket``
    without importing the tuner): ``bucket_label(3, 24, 96) → "4x32x128"``.
    """
    def pow2(n: int) -> int:
        return 1 << max(0, int(n) - 1).bit_length()
    return "x".join(str(pow2(d)) for d in dims)
