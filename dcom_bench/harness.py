"""One run of one cell: set-up, the measured window, the check, the
result line.

``measure`` is the run without the command line: ``run.py`` calls it on
the card after checking for one; the CPU tests call it on the host at a
reduced configuration (``overrides``), with the timed path broken where
a test asks (``sampler`` for the serving drivers, or any monkeypatch).
"""
from __future__ import annotations

import math
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from . import bench
from .trace import TraceWindow

Check = Tuple[str, float, float]


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, List[Check]]:
    """(correct, [(name, value, limit)]) for every number that has a
    limit: correct when each is finite and at most its limit, and no
    limit lacks its number."""
    checks = [(n, float(numbers.get(n, math.nan)), float(lim))
              for n, lim in sorted(limits.items())]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    return ok and bool(checks), checks


def measure(name: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", manifest: Optional[dict] = None,
            overrides: Optional[dict] = None, sampler=None,
            t_start: Optional[float] = None, base=bench.HERE
            ) -> Tuple[dict, List[Check], dict]:
    """Run cell ``name`` once → (result line, checks, readings); the
    cell's files lie under ``base`` (this folder)."""
    t_start = time.perf_counter() if t_start is None else t_start
    m = manifest if manifest is not None else bench.load_manifest()
    cell = bench.load_cell(name, seed, device, m, overrides, base)
    drv = bench.driver(cell.kind)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    st = drv.setup(cell, sampler) if sampler is not None \
        else drv.setup(cell)
    setup_s = time.perf_counter() - t_start
    tr = cell.traffic
    tw = TraceWindow(trace, after=float(tr.get("trace_after", 1.0)),
                     seconds=float(tr.get("trace_seconds", 3.0)))
    tw.prepare()
    win = drv.window(st, seconds, tw)
    win["trace"] = tw.summary()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    drv.release(st)
    t_check = time.perf_counter()
    numbers = drv.check(st, win)
    print(f"set-up {setup_s:.1f} s {getattr(st, 'phases', {})}; check "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    correct, checks = judge(numbers, cell.limits.get("numbers", {}))
    correct = correct and not win.get("failed")
    metrics = {}
    if not trace:
        e2e = dict(win["e2e"], setup_s=setup_s)
        for e in bench.e2e_of(m, name):
            v = e2e.get(e["name"])
            if v is None:
                raise RuntimeError(f"{name}: no value of {e['name']}")
            metrics[e["name"]] = {"value": v, "unit": e["unit"]}
    else:
        for p in bench.per_layer_of(m, name):
            v = bench.reader(p["name"], base)(cell, win)
            if v is not None:
                metrics[p["name"]] = {"value": v, "unit": p["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "host",
           "count": int(cell.entry.get("chips", 1)),
           "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(win["attempted"]),
           "failed": int(win["failed"]), "metrics": metrics, "device": dev}
    t = win["trace"]
    if trace and t is not None:
        dev["busy_s"] = t["busy_s"]
        dev["window_s"] = t["window_s"]
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
    if win.get("facts"):
        out["window"] = win["facts"]
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return out, checks, numbers


def loaded_forbidden() -> List[str]:
    return bench.forbidden_modules(list(sys.modules))
