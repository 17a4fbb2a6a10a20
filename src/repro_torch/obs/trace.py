"""Request-lifecycle tracing: host-side spans → Chrome trace-event JSON.

Counterpart of ``repro.obs.trace`` (same span names, tracks and format).

Spans are wall-clock intervals (``time.perf_counter``) recorded as Chrome
trace-event ``"X"`` (complete) events, loadable in Perfetto / chrome://
tracing.  Tracks (one ``tid`` each, named via ``thread_name`` metadata
events) separate the concurrent stories serving interleaves:

* ``engine``   — the step loop: ``step`` spans containing ``admit`` /
  ``decode-step`` / ``decode-block`` / ``fold`` / ``splice`` /
  ``drain-pool`` children (nesting is time containment on one tid,
  which is exactly how Perfetto renders it);
* ``tickets``  — in-flight async ``PrefillTicket``s (dispatch → splice),
  on their own track so the P/D overlap is visible as spans running UNDER
  the engine's decode spans;
* ``req/<uid>`` — one track per request: a ``request`` span
  (submit → finish) containing ``queue`` (submit → dispatch),
  ``prefill`` (dispatch → first token) and ``decode`` (first → last
  token) child spans.

Everything is plain Python list-append on the host — a disabled tracer
(the default) reduces every call to one attribute check and shared no-op
objects, and an enabled tracer never touches device state, so tokens are
byte-identical either way.  A span takes the host clock and never waits
on the device: one that ends at a readback the engine already does (a
sampled token, a fused block's output) covers the device work before
it; any other covers the host's enqueue only (each such span says so
where it is opened).

The module also owns the PHASE stack used to attribute what the port
compiles at run time: ``phase_scope("decode")`` marks host-side sections
that launch device work, and the compile watch (``watch.py``) labels
every CUDA-graph capture and nvcc build with the innermost active phase.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

from ..ioutil import atomic_write_json


class Span:
    """One open interval on a track; ``end()`` records the event."""

    __slots__ = ("tracer", "name", "track", "args", "t0", "_done")

    def __init__(self, tracer: "Tracer", name: str, track: str,
                 args: Optional[Dict[str, Any]] = None):
        self.tracer = tracer
        self.name = name
        self.track = track
        self.args = dict(args or {})
        self.t0 = time.perf_counter()
        self._done = False

    def annotate(self, **kw) -> "Span":
        self.args.update(kw)
        return self

    def end(self, **kw) -> None:
        if self._done:                    # idempotent: double-end is a no-op
            return
        self._done = True
        if kw:
            self.args.update(kw)
        self.tracer._record(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


class _NullSpan:
    """Shared no-op span for a disabled tracer (zero allocation per call)."""

    __slots__ = ()

    def annotate(self, **kw) -> "_NullSpan":
        return self

    def end(self, **kw) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL_SPAN = _NullSpan()


class Tracer:
    """Span recorder.  ``enabled=False`` (the default engine state) makes
    ``begin``/``span``/``instant`` constant-time no-ops."""

    def __init__(self, enabled: bool = True, max_events: int = 200_000):
        self.enabled = enabled
        self.events: List[dict] = []
        self.max_events = max_events      # hard bound: tracing may never
        #                                   become the unbounded-memory bug
        #                                   it exists to prevent
        self.dropped = 0
        self._t0 = time.perf_counter()
        self._tids: Dict[str, int] = {}

    # -- recording --------------------------------------------------------
    def begin(self, name: str, track: str = "engine",
              args: Optional[Dict[str, Any]] = None):
        """Open a span; the caller ends it (possibly in another scope —
        request-lifecycle spans end steps later than they begin)."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, track, args)

    span = begin                          # context-manager idiom: with t.span(..)

    def instant(self, name: str, track: str = "engine",
                args: Optional[Dict[str, Any]] = None) -> None:
        if not self.enabled:
            return
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append({
            "name": name, "ph": "i", "s": "t",
            "ts": (time.perf_counter() - self._t0) * 1e6,
            "pid": 0, "tid": self._tid(track),
            "args": dict(args or {})})

    def _record(self, sp: Span) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        ts = (sp.t0 - self._t0) * 1e6
        self.events.append({
            "name": sp.name, "ph": "X", "ts": ts,
            "dur": (time.perf_counter() - self._t0) * 1e6 - ts,
            "pid": 0, "tid": self._tid(sp.track), "args": sp.args})

    def _tid(self, track: str) -> int:
        tid = self._tids.get(track)
        if tid is None:
            tid = len(self._tids) + 1
            self._tids[track] = tid
        return tid

    # -- export -----------------------------------------------------------
    def to_json(self) -> dict:
        """Chrome trace-event JSON object (Perfetto-loadable)."""
        meta = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                 "args": {"name": "repro.serving"}}]
        for track, tid in sorted(self._tids.items(), key=lambda kv: kv[1]):
            meta.append({"name": "thread_name", "ph": "M", "pid": 0,
                         "tid": tid, "args": {"name": track}})
        return {"traceEvents": meta + self.events,
                "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        atomic_write_json(path, self.to_json())


def validate_trace(obj) -> int:
    """Validate Chrome trace-event JSON (a dict, JSON text, or a path).

    Checks the structural contract Perfetto's JSON importer needs — a
    ``traceEvents`` list whose entries carry ``ph``/``ts``/``pid``/``tid``
    (``dur`` too for ``"X"`` events) — and returns the number of complete
    spans.  Raises ``ValueError`` on any malformed event.
    """
    if isinstance(obj, str):
        if "\n" not in obj and not obj.lstrip().startswith(("{", "[")):
            with open(obj) as f:
                obj = json.load(f)
        else:
            obj = json.loads(obj)
    if not isinstance(obj, dict) or not isinstance(
            obj.get("traceEvents"), list):
        raise ValueError("trace: expected {'traceEvents': [...]}")
    spans = 0
    for ev in obj["traceEvents"]:
        if not isinstance(ev, dict):
            raise ValueError(f"trace event is not an object: {ev!r}")
        for fld in ("ph", "pid", "tid"):
            if fld not in ev:
                raise ValueError(f"trace event missing {fld!r}: {ev!r}")
        if ev["ph"] == "M":
            continue
        if "ts" not in ev or not isinstance(ev["ts"], (int, float)):
            raise ValueError(f"trace event missing numeric ts: {ev!r}")
        if ev["ph"] == "X":
            if not isinstance(ev.get("dur"), (int, float)) \
                    or ev["dur"] < 0:
                raise ValueError(f"X event needs dur >= 0: {ev!r}")
            spans += 1
    return spans


# ---------------------------------------------------------------------------
# Phase stack (compile attribution)
# ---------------------------------------------------------------------------

_phase = threading.local()


def current_phase() -> str:
    stack = getattr(_phase, "stack", None)
    return stack[-1] if stack else "other"


class phase_scope:
    """Mark a host section that launches device work, so compiles
    (captures, builds) made while it is active are attributed to it (two
    list ops — always on, independent of any tracer)."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_phase, "stack", None)
        if stack is None:
            stack = _phase.stack = []
        stack.append(self.name)
        return self

    def __exit__(self, *exc):
        _phase.stack.pop()
