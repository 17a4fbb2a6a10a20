"""Tuner orchestration: space → cost model → (optional) measurement → cache.

Counterpart of ``repro.tune.tuner``.  ``tune`` is the one entry point:

1. **cache** — a persistent entry for (device kind, kernel, shape bucket,
   dtype, pinned params) short-circuits everything, if its operating
   point is in the kernel's own space;
2. **model** — the cost model scores every candidate and either answers
   directly (``measure_candidates=False``: deterministic arithmetic,
   what the engine uses when it decomposes) or prunes the grid to the
   ``prune`` most promising points;
3. **measure** — the survivors are timed by ``measure.measure_candidate``
   at the bucketed shape on ``device``; the winner is persisted, so step
   1 hits next time.

``tuned_expansion`` and ``tuned_decode_block`` add the in-process lru
the engines resolve ``expansion="auto"`` and ``decode_block="auto"``
through.  The engine always pins its own backend
through ``fix``, so the tuner never swaps a backend under an engine.
``resolve_backend`` answers ``backend="auto"`` (a measured per-machine
winner of ``tune_backend``, else the platform's), once, when a
DecomposeEngine is built.

The tuner counts in ``obs.GLOBAL`` under the reference's names:
``tune_resolutions_total{kernel, source}``,
``tune_lru_lookups_total{kernel}``, ``tune_lru_misses_total{kernel}``;
:data:`stats` reads them since :func:`reset_stats`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

from ..obs import GLOBAL as _OBS
from ..platform import resolve_device
from . import cost_model, measure
from .cache import TuningCache, default_cache, entry_key, shape_bucket
from .space import TunableSpace, get_space, space_revision

#: Production prune width: how many model-ranked candidates a measured
#: tune benchmarks.  One constant, so the Fig. 12 A/B replays exactly the
#: pruning the tuner uses.
DEFAULT_PRUNE = 4


_SOURCES = ("cache", "model", "measured")


def _totals() -> Dict[str, int]:
    """The tuner's ``obs.GLOBAL`` counters, summed over their labels."""
    out = dict.fromkeys(("lru_lookups", "lru_misses") + _SOURCES, 0)
    for m in _OBS.metrics():
        if m.name == "tune_resolutions_total":
            out[m.labels["source"]] += m.value
        elif m.name in ("tune_lru_lookups_total", "tune_lru_misses_total"):
            out[m.name[len("tune_"):-len("_total")]] += m.value
    return out


class TunerStats:
    """The tuner's counts in this process since :func:`reset_stats`: a view
    of its ``obs.GLOBAL`` counters (``lru_lookups``, ``lru_misses``,
    ``answers`` by source)."""

    def __init__(self):
        self._base = _totals()

    def _since(self) -> Dict[str, int]:
        now = _totals()
        return {k: now[k] - self._base[k] for k in now}

    @property
    def lru_lookups(self) -> int:
        return self._since()["lru_lookups"]

    @property
    def lru_misses(self) -> int:
        return self._since()["lru_misses"]

    @property
    def answers(self) -> Dict[str, int]:
        since = self._since()
        return {k: since[k] for k in _SOURCES}


stats = TunerStats()


def reset_stats() -> None:
    stats.__init__()


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Outcome of one tuning query (also the shape of a cache entry)."""
    kernel: str
    shape: Tuple[int, ...]               # bucketed shape the entry covers
    dtype: str
    key: str
    best: Dict[str, Any]
    source: str                          # "cache" | "model" | "measured"
    predicted_s: float
    measured_s: Optional[float]
    #: full sweep: (candidate, predicted_s, measured_s-or-None)
    table: Tuple[Tuple[Dict[str, Any], float, Optional[float]], ...]

    def swept_optimum(self) -> Tuple[Dict[str, Any], float]:
        """(candidate, seconds) minimizing the measured column (predicted
        where no measurement exists)."""
        rows = [(c, m if m is not None else p) for c, p, m in self.table]
        return min(rows, key=lambda r: r[1])


def _answered(kernel: str, source: str) -> None:
    _OBS.counter("tune_resolutions_total", "tuner queries by answer source",
                 kernel=kernel, source=source).inc()


def _lru(kernel: str, event: str) -> None:
    """Count an lru ``event`` ("lookups" or "misses") of ``kernel``."""
    _OBS.counter(f"tune_lru_{event}_total", f"in-process tuner lru {event}",
                 kernel=kernel).inc()


def _variant(fix: Optional[Mapping[str, Any]]) -> str:
    if not fix:
        return "-"
    return ",".join(f"{k}={fix[k]}" for k in sorted(fix))


def _dtype_name(dtype: Any) -> str:
    return str(dtype).replace("torch.", "")


def candidates_for(kernel: str, fix: Optional[Mapping[str, Any]] = None
                   ) -> Tuple[Dict[str, Any], ...]:
    """Candidate grid of ``kernel`` with ``fix`` params pinned (pinned
    values need not be among the declared choices).  Every candidate is
    feasible in the port: ``"cuda"`` and ``"reference"`` both run on
    either device (the CUDA wrappers take their plain versions for host
    tensors)."""
    space: TunableSpace = get_space(kernel)
    fix = dict(fix or {})
    out, seen = [], set()
    for cand in space.candidates():
        cand.update(fix)
        key = tuple(sorted(cand.items()))
        if key not in seen:
            seen.add(key)
            out.append(cand)
    return tuple(out)


def _in_space(kernel: str, entry: Mapping[str, Any],
              fix: Optional[Mapping[str, Any]]) -> bool:
    """``entry`` was made under the kernel's current revision, and its
    best names every param of the kernel's own space with one of its
    choices (or the pinned value)."""
    fix = fix or {}
    best = entry.get("best", {})
    return entry.get("revision", 0) == space_revision(kernel) and all(
        p.name in best and (best[p.name] in p.choices
                            or fix.get(p.name) == best[p.name])
        for p in get_space(kernel).params)


def _from_entry(key: str, entry: Mapping[str, Any]) -> TuneResult:
    table = tuple((dict(r["params"]), float(r["predicted_s"]),
                   None if r.get("measured_s") is None
                   else float(r["measured_s"]))
                  for r in entry.get("table", ()))
    return TuneResult(kernel=entry["kernel"], shape=tuple(entry["shape"]),
                      dtype=entry["dtype"], key=key,
                      best=dict(entry["best"]), source="cache",
                      predicted_s=float(entry["predicted_s"]),
                      measured_s=entry.get("measured_s"), table=table)


def _to_entry(res: TuneResult) -> Dict[str, Any]:
    return {"kernel": res.kernel, "revision": space_revision(res.kernel),
            "shape": list(res.shape), "dtype": res.dtype,
            "best": dict(res.best),
            "source": res.source, "predicted_s": res.predicted_s,
            "measured_s": res.measured_s,
            "table": [{"params": dict(c), "predicted_s": p,
                       "measured_s": m} for c, p, m in res.table]}


def _bucket_floor(bucket: Sequence[int]) -> Tuple[int, ...]:
    """The least shape of a bucket (each dim one past the power of two
    below it): a candidate the kernel takes there it takes at every shape
    the bucket's entry answers."""
    return tuple(n // 2 + 1 if n > 1 else 1 for n in bucket)


def tune(kernel: str, shape: Sequence[int], dtype: Any = "float32", *,
         fix: Optional[Mapping[str, Any]] = None,
         measure_candidates: bool = False,
         prune: Optional[int] = DEFAULT_PRUNE, reps: int = 5,
         device: Any = "cuda", cache: Optional[TuningCache] = None,
         force: bool = False,
         persist: Optional[bool] = None,
         flush_l2: bool = False) -> TuneResult:
    """Pick the operating point of ``kernel`` for ``shape``/``dtype`` on
    ``device`` (``"cuda"`` by default; raises without a card unless
    ``"cpu"`` is asked for).

    ``measure_candidates=False`` answers from the cache or the device's
    cost model.  With ``measure_candidates=True``
    the model-ranked top ``prune`` candidates (None = all) are timed at
    the bucketed shape (``flush_l2`` flushes the L2 before each timed
    call) and the winner persisted.  ``fix`` pins params; ``force``
    ignores the cache.  A candidate the card's kernel does not take at
    some shape of the bucket (``cost_model.reaches``) is skipped, on
    either device."""
    cache = cache if cache is not None else default_cache()
    dev = cost_model.detect_device(device)
    bucket = shape_bucket(shape)
    dt = _dtype_name(dtype)
    key = entry_key(cost_model.device_kind(device), kernel, shape, dt) \
        + "/" + _variant(fix)

    if not force:
        entry = cache.get(key)
        if entry is not None and (entry.get("measured_s") is not None
                                  or not measure_candidates) \
                and _in_space(kernel, entry, fix):
            _answered(kernel, "cache")
            return _from_entry(key, entry)

    cands = [c for c in candidates_for(kernel, fix)
             if cost_model.reaches(kernel, _bucket_floor(bucket), c)]
    scored = sorted(((c, cost_model.predict(kernel, bucket, dt, c, dev))
                     for c in cands), key=lambda cp: cp[1])

    if measure_candidates:
        top = scored if prune is None else scored[:max(1, prune)]
        table = tuple(
            (c, p, measure.measure_candidate(kernel, bucket, dt, c,
                                             reps=reps, device=device,
                                             flush_l2=flush_l2))
            for c, p in top)
        best, pred, meas = min(table, key=lambda r: r[2])
        res = TuneResult(kernel, bucket, dt, key, dict(best), "measured",
                         pred, meas, table)
    else:
        best, pred = scored[0]
        table = tuple((c, p, None) for c, p in scored)
        res = TuneResult(kernel, bucket, dt, key, dict(best), "model",
                         pred, None, table)

    _answered(kernel, res.source)
    cache.put(key, _to_entry(res))
    if persist if persist is not None else measure_candidates:
        cache.save()
    return res


# ---------------------------------------------------------------------------
# Engine-facing resolution (the in-process lru layer)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tuned_expansion(kernel: str, bucket: Tuple[int, ...], dtype: str,
                     backend: Optional[str], device: str,
                     cache_path: str) -> int:
    # device: a resolved torch device string ("cuda", "cpu")
    _lru(kernel, "misses")
    fix = {"backend": backend} if backend is not None else None
    res = tune(kernel, bucket, dtype, fix=fix, device=device)
    return int(res.best["expansion"])


def tuned_expansion(shape: Sequence[int], dtype: Any = "float32",
                    backend: Optional[str] = None,
                    kernel: str = "lanczos_reorth",
                    device: Any = "cuda") -> int:
    """The expansion factor f the engine should run ``kernel`` at for this
    shape bucket on ``device`` — cache or model resolution behind an
    in-process lru (keyed on the cache path, so tests that point
    ``REPRO_TUNE_CACHE`` elsewhere see no stale answers)."""
    _lru(kernel, "lookups")
    return _tuned_expansion(kernel, shape_bucket(shape), _dtype_name(dtype),
                            backend, str(resolve_device(device)),
                            default_cache().path)


@functools.lru_cache(maxsize=None)
def _tuned_decode_block(bucket: Tuple[int, ...], dtype: str, device: str,
                        cache_path: str) -> int:
    _lru("decode_block", "misses")
    res = tune("decode_block", bucket, dtype, device=device)
    return int(res.best["block"])


def tuned_decode_block(shape: Sequence[int], dtype: Any = "float32",
                       device: Any = "cuda") -> int:
    """The fused decode block length the serving engine should run for
    this (slots, decode horizon, kv width) bucket on ``device`` — answers
    ``Engine(decode_block="auto")`` as :func:`tuned_expansion` answers
    ``expansion="auto"``."""
    _lru("decode_block", "lookups")
    return _tuned_decode_block(shape_bucket(shape), _dtype_name(dtype),
                               str(resolve_device(device)),
                               default_cache().path)


_BACKEND_KEY_SUFFIX = "engine_backend"


def _backend_key(device: Any) -> str:
    return f"{cost_model.device_kind(device)}/{_BACKEND_KEY_SUFFIX}"


def _default_device() -> str:
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


def resolve_backend(cache: Optional[TuningCache] = None,
                    device: Any = None) -> str:
    """Answer ``backend="auto"`` on ``device`` (default: the card if
    there is one, else the host): the winner :func:`tune_backend`
    persisted for this device kind when it names a registered backend,
    else ``"cuda"`` on a CUDA device and ``"reference"`` on the host,
    where the kernels cannot run."""
    from ..engine.backends import available_backends
    device = _default_device() if device is None else device
    cache = cache if cache is not None else default_cache()
    entry = cache.get(_backend_key(device))
    if entry:
        name = entry.get("best", {}).get("backend")
        if name in available_backends():
            return name
    return "cuda" if resolve_device(device).type == "cuda" else "reference"


def tune_backend(shape: Sequence[int] = (4, 256, 512),
                 dtype: Any = "float32", *, reps: int = 5,
                 cache: Optional[TuningCache] = None,
                 device: Any = "cuda") -> TuneResult:
    """Measure the re-orth step on ``device`` across every registered
    backend, each at its two model-best f (``prune=2``), and persist the
    winner as this device kind's ``backend="auto"`` answer.  The
    result's ``table`` holds one (best candidate, predicted s, measured
    s) row per backend."""
    from ..engine.backends import available_backends
    cache = cache if cache is not None else default_cache()
    rows = []
    for name in available_backends():
        res = tune("lanczos_reorth", shape, dtype, fix={"backend": name},
                   measure_candidates=True, prune=2, reps=reps, cache=cache,
                   force=True, persist=False, device=device)
        rows.append((res.best, res.predicted_s, res.measured_s))
    best, pred, meas = min(rows, key=lambda r: r[2])
    res = TuneResult("lanczos_reorth", shape_bucket(shape),
                     _dtype_name(dtype), _backend_key(device), dict(best),
                     "measured", pred, meas, tuple(rows))
    cache.put(res.key, _to_entry(res))
    cache.save()
    return res


def pretune(shapes: Mapping[str, Sequence[Sequence[int]]],
            dtype: Any = "float32", *,
            fix: Optional[Mapping[str, Any]] = None,
            measure_candidates: bool = False, device: Any = "cuda",
            cache: Optional[TuningCache] = None
            ) -> Dict[str, TuneResult]:
    """Warm the tuning cache for a known workload — the serving CLI
    pre-tunes its prefill decomposition shapes before the first request
    lands.  Returns {cache key: result}."""
    out: Dict[str, TuneResult] = {}
    for kernel, kshapes in shapes.items():
        for shape in kshapes:
            res = tune(kernel, shape, dtype, fix=fix,
                       measure_candidates=measure_candidates, device=device,
                       cache=cache)
            out[res.key] = res
    return out
