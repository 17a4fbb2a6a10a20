"""Finding a cell's pieces by name, and the rules the manifest keeps.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.
Each is a file of its own (``configs/<file>``, ``traffic/<mix>.json``);
the mix names its driver kind (``drivers/<kind>.py``) and the cell its
limits (``limits/<cell>.json``); each per-layer metric has a reader
(``metrics/<name>.py``, else the reader of the part before the first
dot, ``metrics/<base>.py``, which then reads every split of the
quantity).  Adding a configuration, a mix, a cell or a metric adds files
and manifest entries and edits none.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
E2E_SOURCES = ("host_clock", "device_trace")

#: the top-level module names no process of the benchmark may load (the
#: port's own name, ``repro_torch``, begins with the last one: names are
#: compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules) -> List[str]:
    """The names in ``modules`` (e.g. ``sys.modules``) whose top-level
    part, before the first dot, is one of :data:`FORBIDDEN`."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def load_manifest(root: Path = ROOT) -> dict:
    """``BENCHMARK.json`` of the checkout at ``root``."""
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def check_manifest(m: dict, base: Path = HERE) -> List[str]:
    """The manifest's breaches of the rules the harness relies on (empty
    when it keeps them): names and units in the allowed characters, every
    cell's configuration and mix present, each per-layer metric's
    ``moves`` an end-to-end metric reported in every cell it lists."""
    errs: List[str] = []
    names = set()
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in m.get(sec, []):
            n = e.get("name", "")
            if not NAME.match(n):
                errs.append(f"{sec}: bad name {n!r}")
            if n in names and sec != "configs":
                errs.append(f"{sec}: duplicate name {n!r}")
            names.add(n)
            if "unit" in e and not UNIT.match(e["unit"]):
                errs.append(f"{n}: bad unit {e['unit']!r}")
            if sec in ("end_to_end", "per_layer"):
                if e.get("better") not in ("lower", "higher"):
                    errs.append(f"{n}: better must be lower or higher")
                ok = E2E_SOURCES if sec == "end_to_end" else SOURCES
                if e.get("source") not in ok:
                    errs.append(f"{n}: source {e.get('source')!r}")
    configs = {c["name"]: c for c in m.get("configs", [])}
    for c in configs.values():
        for k in c.get("reduced", []):
            if not NAME.match(k):
                errs.append(f"{c['name']}: bad reduced key {k!r}")
        if not (base.parent / c["file"]).is_file():
            errs.append(f"{c['name']}: no file {c['file']}")
    cells = {w["name"]: w for w in m.get("workloads", [])}
    pairs = set()
    for w in cells.values():
        if w["config"] not in configs:
            errs.append(f"{w['name']}: unknown config {w['config']!r}")
        if not NAME.match(w["traffic"]):
            errs.append(f"{w['name']}: bad traffic name")
        elif not (base / "traffic" / f"{w['traffic']}.json").is_file():
            errs.append(f"{w['name']}: no traffic file {w['traffic']}")
        if (w["config"], w["traffic"]) in pairs:
            errs.append(f"{w['name']}: pair used twice")
        pairs.add((w["config"], w["traffic"]))
        if w.get("chips") not in (1, 4):
            errs.append(f"{w['name']}: chips must be 1 or 4")
    e2e = {e["name"]: e for e in m.get("end_to_end", [])}
    if "setup_s" not in e2e:
        errs.append("end_to_end: no setup_s")
    for w in cells:
        if len(e2e_of(m, w)) < 2:
            errs.append(f"{w}: reports no end-to-end metric but setup_s")
        if not per_layer_of(m, w):
            errs.append(f"{w}: reports no per-layer metric")
    for p in m.get("per_layer", []):
        mv = p.get("moves")
        if mv not in e2e:
            errs.append(f"{p['name']}: moves unknown metric {mv!r}")
            continue
        for w in p.get("workloads", list(cells)):
            if w not in cells:
                errs.append(f"{p['name']}: unknown cell {w!r}")
            elif mv not in {e["name"] for e in e2e_of(m, w)}:
                errs.append(f"{p['name']}: {mv} is not reported in {w}")
        if reader_path(p["name"], base) is None:
            errs.append(f"{p['name']}: no reader in metrics/")
    return errs


def e2e_of(m: dict, cell: str) -> List[dict]:
    """The end-to-end metrics cell ``cell`` reports."""
    return [e for e in m["end_to_end"]
            if cell in e.get("workloads", [cell])]


def per_layer_of(m: dict, cell: str) -> List[dict]:
    """The per-layer metrics cell ``cell`` reports (those that list it, and
    those without a list whose ``moves`` it reports)."""
    mine = {e["name"] for e in e2e_of(m, cell)}
    out = []
    for p in m["per_layer"]:
        if "workloads" in p:
            if cell in p["workloads"]:
                out.append(p)
        elif p["moves"] in mine:
            out.append(p)
    return out


def reader_path(metric: str, base: Path = HERE) -> Optional[Path]:
    """``metrics/<metric>.py``, else ``metrics/<base>.py`` for the part of
    the name before its first dot."""
    for stem in (metric, metric.split(".", 1)[0]):
        p = base / "metrics" / f"{stem}.py"
        if p.is_file():
            return p
    return None


def reader(metric: str, base: Path = HERE) -> Callable:
    """The ``read(cell, window)`` function of a per-layer metric."""
    path = reader_path(metric, base)
    if path is None:
        raise KeyError(f"no reader for per-layer metric {metric!r}")
    spec = importlib.util.spec_from_file_location(
        f"dcom_bench.metrics.{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(kind: str):
    """The driver module of a traffic mix's ``driver`` kind."""
    if not NAME.match(kind) or "." in kind:
        raise ValueError(f"bad driver kind {kind!r}")
    return importlib.import_module(f"dcom_bench.drivers.{kind}")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """Everything one run of one cell reads: the manifest's entry, the
    configuration file, the port's ``ArchConfig`` built from it, the
    traffic mix and the limits."""
    name: str
    entry: dict
    config: dict
    arch: Any
    traffic: dict
    limits: dict
    seed: int
    device: Any = "cuda"
    base: Path = HERE

    @property
    def kind(self) -> str:
        return self.traffic["driver"]


def arch_of(config: dict):
    """The port's ``ArchConfig`` of a configuration file (its ``arch``
    object holds the fields as the port names them)."""
    from repro_torch.configs import ArchConfig
    return ArchConfig(**config["arch"])


def load_cell(name: str, seed: int, device="cuda",
              manifest: Optional[dict] = None,
              overrides: Optional[Dict[str, dict]] = None,
              base: Path = HERE) -> Cell:
    """The cell ``name`` of the manifest whose files lie under ``base``
    (this folder).  ``overrides`` (tests only) replaces keys of the
    ``arch``, ``traffic`` or ``limits`` objects."""
    m = manifest if manifest is not None else load_manifest()
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; cells: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in m["configs"]}[w["config"]]
    config = load_json(base.parent / conf["file"])
    traffic = load_json(base / "traffic" / f"{w['traffic']}.json")
    lim_path = base / "limits" / f"{name}.json"
    limits = load_json(lim_path) if lim_path.is_file() else {"numbers": {}}
    ov = overrides or {}
    config = dict(config, arch=dict(config["arch"], **ov.get("arch", {})))
    traffic = dict(traffic, **ov.get("traffic", {}))
    if "limits" in ov:
        limits = dict(limits, numbers=dict(limits["numbers"],
                                           **ov["limits"]))
    return Cell(name, w, config, arch_of(config), traffic, limits,
                int(seed), device, base)
