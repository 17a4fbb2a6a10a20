"""Exposition: Prometheus text format + JSON snapshots.

Counterpart of ``repro.obs.exposition``: the same text for the same
registry contents, and each package's parser reads the other's text.

``to_prometheus`` renders one or more registries as Prometheus text
exposition (format 0.0.4).  Histograms are exported as SUMMARY metrics —
``{quantile="0.5|0.95|0.99"}`` series plus ``_sum``/``_count`` — because
the log-bucketed quantiles are computed here, host-side, rather than by a
remote query engine.  ``parse_prometheus`` is the strict grammar check the
smoke run and the tests gate on (no client library is needed).
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Tuple

from ..ioutil import atomic_write_json, atomic_write_text
from .registry import Histogram, MetricsRegistry

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LINE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>[-+]?(?:[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?"
    r"|Inf|NaN))$")
_LABEL = re.compile(r'^(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:[^"\\]'
                    r'|\\.)*)"$')

#: default metric-name prefix (the reference's, so one dashboard reads
#: either package)
NAMESPACE = "repro"


def _sanitize(name: str) -> str:
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not _NAME_OK.match(out):
        out = "_" + out
    return out


def _escape(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{_sanitize(k)}="{_escape(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_val(v) -> str:
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(v) if v != int(v) else str(int(v))


def to_prometheus(*registries: MetricsRegistry,
                  namespace: str = NAMESPACE) -> str:
    """Render registries as Prometheus text exposition.  Later registries
    win nothing — names are expected disjoint per label set; duplicate
    (name, labels) pairs across registries are all emitted (Prometheus
    treats that as an error, so keep engine vs global metrics distinct)."""
    by_name: Dict[str, list] = {}
    kinds: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    for reg in registries:
        for m in reg.metrics():
            name = _sanitize(f"{namespace}_{m.name}" if namespace
                             else m.name)
            by_name.setdefault(name, []).append(m)
            kinds.setdefault(name, "summary" if isinstance(m, Histogram)
                             else m.kind)
            if m.help and name not in helps:
                helps[name] = m.help
    lines: List[str] = []
    for name in sorted(by_name):
        if name in helps:
            lines.append(f"# HELP {name} {helps[name]}")
        lines.append(f"# TYPE {name} {kinds[name]}")
        for m in by_name[name]:
            if isinstance(m, Histogram):
                for q in (0.5, 0.95, 0.99):
                    lb = dict(m.labels, quantile=str(q))
                    lines.append(f"{name}{_fmt_labels(lb)} "
                                 f"{_fmt_val(m.quantile(q))}")
                lines.append(f"{name}_sum{_fmt_labels(m.labels)} "
                             f"{_fmt_val(m.sum)}")
                lines.append(f"{name}_count{_fmt_labels(m.labels)} "
                             f"{_fmt_val(m.count)}")
            else:
                lines.append(f"{name}{_fmt_labels(m.labels)} "
                             f"{_fmt_val(m.value)}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> Dict[str, List[Tuple[Dict[str, str],
                                                        float]]]:
    """Strict parse of text exposition → ``{name: [(labels, value)]}``.
    Raises ``ValueError`` on any line that is neither a comment nor a
    well-formed sample."""
    out: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE.match(line)
        if not m:
            raise ValueError(f"prometheus line {ln} malformed: {raw!r}")
        labels: Dict[str, str] = {}
        body = m.group("labels")
        if body:
            for part in _split_labels(body, ln, raw):
                lm = _LABEL.match(part)
                if not lm:
                    raise ValueError(
                        f"prometheus line {ln} bad label {part!r}")
                labels[lm.group("k")] = lm.group("v")
        out.setdefault(m.group("name"), []).append(
            (labels, float(m.group("value"))))
    return out


def _split_labels(body: str, ln: int, raw: str) -> List[str]:
    """Split ``k="v",k2="v2"`` on commas outside quotes."""
    parts, cur, in_q, esc = [], [], False, False
    for ch in body:
        if esc:
            cur.append(ch)
            esc = False
        elif ch == "\\":
            cur.append(ch)
            esc = True
        elif ch == '"':
            cur.append(ch)
            in_q = not in_q
        elif ch == "," and not in_q:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if in_q:
        raise ValueError(f"prometheus line {ln} unterminated quote: {raw!r}")
    if cur:
        parts.append("".join(cur))
    return parts


def write_prometheus(path: str, *registries: MetricsRegistry,
                     namespace: str = NAMESPACE) -> str:
    text = to_prometheus(*registries, namespace=namespace)
    parse_prometheus(text)                # never write what we can't parse
    atomic_write_text(path, text)
    return text


def write_json_snapshot(path: str, *registries: MetricsRegistry) -> dict:
    snap: dict = {}
    for reg in registries:
        for name, rows in reg.snapshot().items():
            snap.setdefault(name, []).extend(rows)
    atomic_write_json(path, snap, indent=2)
    return snap
