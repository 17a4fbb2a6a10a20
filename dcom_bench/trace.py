"""The traced part of a ``--trace 1`` run, reduced to what readers need.

A driver calls :meth:`TraceWindow.poll` between units of work (a
forward, an engine step).  The profiler (CPU and CUDA activities) starts
at the first poll ``after`` seconds into the window and stops at the
first poll ``seconds`` later, each after a synchronize; a marker range
at each end puts the window on the profiler's clock.  A traced run's
window runs on until the traced part has ended (:meth:`active`), and
its set-up starts and stops the profiler once (:meth:`prepare`).  The
reduction:

* ``busy_s``: the union of the device's operation intervals (kernels,
  copies, sets) inside the window, not their sum;
* ``window_s``: the marker-to-marker length;
* ``kernels``: {short name: [launches, device seconds]};
* ``device_ops``: the ten names that took the most device time;
* ``idle_gaps``: the ten longest gaps with no device operation, each
  named by the innermost host range open at its middle (the harness's
  ``step``/``forward`` ranges and the aten operator inside them).
"""
from __future__ import annotations

import re
import time
from typing import Dict, List, Optional

import numpy as np

MARK = "dcom_bench.mark"


def short_name(name: str) -> str:
    """A device operation's name without its template and argument
    lists or namespace (``(anonymous namespace)::lrmm_kernel<...>`` →
    ``lrmm_kernel``)."""
    m = re.search(r"\(anonymous namespace\)::(\w+)", name)
    if m:
        return m.group(1)
    s = re.sub(r"^void ", "", name)
    s = re.split(r"[<(]", s, maxsplit=1)[0].strip()
    s = s.split("::")[-1] if "::" in s and not s.startswith("aten") else s
    return (s or name)[:96]


class TraceWindow:
    """Profiles ``seconds`` of a window starting ``after`` seconds into
    it; disabled, every call is a no-op."""

    def __init__(self, enabled: bool, after: float = 0.0,
                 seconds: float = 3.0):
        self.enabled = enabled
        self.after, self.seconds = float(after), float(seconds)
        self.t0: Optional[float] = None
        self.prof = None
        self.done = False
        self.ranges = set()

    def prepare(self) -> None:
        """Start and stop the profiler once (set-up): its first start
        takes seconds, which would otherwise fall inside the window."""
        if not self.enabled:
            return
        from torch.profiler import profile
        with profile(activities=self._activities()):
            pass

    @staticmethod
    def _activities():
        import torch
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return acts

    def begin(self, t0: float) -> None:
        """The window starts at host time ``t0`` (perf_counter)."""
        self.t0 = t0

    def active(self) -> bool:
        """Whether the traced part has yet to end: a traced run's window
        runs on until it has (its end-to-end numbers are not reported)."""
        return self.enabled and not self.done

    def poll(self) -> None:
        if not self.enabled or self.done or self.t0 is None:
            return
        now = time.perf_counter()
        if self.prof is None and now >= self.t0 + self.after:
            self._start()
        elif self.prof is not None and now >= self.t_start + self.seconds:
            self.finish()

    def _start(self) -> None:
        import torch
        from torch.profiler import profile, record_function
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof = profile(activities=self._activities())
        self.prof.__enter__()
        with record_function(MARK):
            pass
        self.t_start = time.perf_counter()

    def finish(self) -> None:
        if not self.enabled or self.done or self.prof is None:
            self.done = True
            return
        import torch
        from torch.profiler import record_function
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        with record_function(MARK):
            pass
        self.prof.__exit__(None, None, None)
        self.done = True

    def range(self, name: str):
        """A host range the gaps can be named by (a no-op untraced)."""
        if self.prof is None or self.done:
            return _NULL
        from torch.profiler import record_function
        self.ranges.add(name)
        return record_function(name)

    def summary(self) -> Optional[Dict]:
        if self.prof is None:
            return None
        return reduce_events(_events(self.prof, self.ranges | {MARK}))


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _events(prof, ranges) -> List[tuple]:
    """(name, on_device, start_ns, end_ns) of every profiled event, read
    from the profiler's raw event list (building its event tree takes
    minutes for a serving window); the device's are its operations
    (kernels, copies, sets), not the copies of host ranges (``ranges``)
    the profiler draws on the device's timeline, and the host's leave out
    the profiler's own buffer requests."""
    out = []
    evs = prof.profiler.kineto_results.events()
    kind = getattr(type(evs[0]), "activity_type", None) if evs else None
    for e in evs:
        name = e.name()
        dev = e.device_type().name != "CPU"
        if "Activity Buffer" in name:
            continue
        if dev and (name in ranges or (kind is not None and "annotation"
                                       in str(e.activity_type()).lower())):
            continue
        s = int(e.start_ns())
        out.append((name, dev, s, s + int(e.duration_ns())))
    return out


def union_ns(starts: np.ndarray, ends: np.ndarray) -> int:
    """Length of the union of intervals [starts, ends)."""
    if not len(starts):
        return 0
    o = np.argsort(starts, kind="stable")
    s, e = starts[o], ends[o]
    run_end = np.maximum.accumulate(e)
    # a new run begins where an interval starts after every earlier end
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    run_starts = s[idx]
    run_ends = np.append(run_end[idx[1:] - 1], run_end[-1])
    return int((run_ends - run_starts).sum())


def gaps(starts: np.ndarray, ends: np.ndarray, lo: int, hi: int):
    """The idle intervals of [lo, hi) not covered by [starts, ends)."""
    if not len(starts):
        return [(lo, hi)]
    o = np.argsort(starts, kind="stable")
    s, e = starts[o], np.maximum.accumulate(ends[o])
    out = []
    if s[0] > lo:
        out.append((lo, int(s[0])))
    nxt = s[1:]
    prev_end = e[:-1]
    for i in np.flatnonzero(nxt > prev_end):
        out.append((int(prev_end[i]), int(nxt[i])))
    if e[-1] < hi:
        out.append((int(e[-1]), hi))
    return out


def reduce_events(events: List[tuple]) -> Dict:
    """The window's reduction (module docstring) from
    (name, on_device, start_ns, end_ns) tuples."""
    marks = sorted(s for n, d, s, _ in events if n == MARK and not d)
    lo, hi = (marks[0], marks[-1]) if len(marks) >= 2 else (
        min(s for _, _, s, _ in events), max(e for _, _, _, e in events))
    dev = [(n, max(s, lo), min(e, hi)) for n, d, s, e in events
           if d and e > lo and s < hi]
    st = np.array([s for _, s, _ in dev], np.int64)
    en = np.array([e for _, _, e in dev], np.int64)
    busy = union_ns(st, en)
    kernels: Dict[str, List[float]] = {}
    for n, s, e in dev:
        k = kernels.setdefault(short_name(n), [0, 0.0])
        k[0] += 1
        k[1] += (e - s) * 1e-9
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    idle = sorted(gaps(st, en, lo, hi), key=lambda g: g[0] - g[1])[:10]
    host = [(n, s, e) for n, d, s, e in events
            if not d and n != MARK and e > lo and s < hi]
    hs = np.array([s for _, s, _ in host], np.int64)
    he = np.array([e for _, _, e in host], np.int64)
    named = []
    for g0, g1 in idle:
        mid = (g0 + g1) // 2
        inside = np.flatnonzero((hs <= mid) & (he >= mid)) if len(hs) \
            else np.array([], np.int64)
        if len(inside):
            order = inside[np.argsort(he[inside] - hs[inside])]
            inner = host[order[0]][0]
            outer = host[order[-1]][0]
            name = inner if inner == outer else f"{outer}>{inner}"
        else:
            name = "no host range"
        named.append([name, (g1 - g0) * 1e-9])
    return {"busy_s": busy * 1e-9, "window_s": (hi - lo) * 1e-9,
            "kernels": kernels,
            "device_ops": [[n, v[1]] for n, v in top],
            "idle_gaps": named, "device_events": len(dev)}
