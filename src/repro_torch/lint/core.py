"""dcomlint core for the port: findings, rule registry, suppressions,
file runner.

Counterpart of ``repro.lint.core``, with the same mechanics:

* a **rule** is a class with an ``id`` (``"D1"``), a human ``name``, a
  ``severity`` and a ``check(ctx)`` generator yielding :class:`Finding`s;
* :func:`register` adds it to the process-wide registry consumed by the
  CLI (``python -m repro_torch.lint``) and the tests;
* an inline ``# dcomlint: disable=D1[,D2|all]`` comment suppresses
  findings on that physical line; a ``# dcomlint: disable-file=D1``
  anywhere in the file suppresses the rule for the whole module.
  Suppressions are counted (they appear in the JSON report), so a pile
  of disables is visible.

Rules parse source text only (``ast``): the linter imports neither torch
nor the code it checks, and runs in milliseconds on any machine.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

SCHEMA = "repro_torch.lint/v1"

_SUPPRESS_RE = re.compile(
    r"#\s*dcomlint:\s*disable(?P<scope>-file)?=(?P<rules>[A-Za-z0-9_,\s]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""
    path: str
    line: int
    col: int
    rule: str
    severity: str
    message: str

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule} {self.severity}: {self.message}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class ModuleCtx:
    """A parsed module handed to every rule: its AST (each node knows its
    ``parent``), its lines, and its path's components for the rules
    scoped to a package."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                child.parent = node  # type: ignore[attr-defined]
        norm = path.replace(os.sep, "/")
        self.parts: Tuple[str, ...] = tuple(
            p for p in norm.split("/") if p not in ("", "."))

    def in_pkg(self, *names: str) -> bool:
        """Whether ``names`` appear as consecutive path components, e.g.
        ``ctx.in_pkg("repro_torch", "serving")`` for a module of the
        port's serving package (in the tree or in a test fixture's
        path)."""
        n = len(names)
        return any(self.parts[i:i + n] == names
                   for i in range(len(self.parts) - n + 1))

    def finding(self, rule: "Rule", node: ast.AST, message: str) -> Finding:
        return Finding(self.path, getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0) + 1,
                       rule.id, rule.severity, message)


class Rule:
    """Base class: subclasses set ``id``/``name`` and implement ``check``.
    A rule's docstring is its catalog entry (``--list-rules``) and names
    the defect it guards against."""
    id: str = ""
    name: str = ""
    severity: str = "error"

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        raise NotImplementedError

    @classmethod
    def doc(cls) -> str:
        return (cls.__doc__ or "").strip()


REGISTRY: Dict[str, Rule] = {}


def register(cls):
    """Class decorator adding one rule instance to the registry."""
    if not cls.id or cls.id in REGISTRY:
        raise ValueError(f"rule id {cls.id!r} missing or duplicate")
    REGISTRY[cls.id] = cls()
    return cls


def all_rules() -> List[Rule]:
    return [REGISTRY[k] for k in sorted(REGISTRY)]


def parse_suppressions(lines: Sequence[str]):
    """→ (``{lineno: {rule, ...}}``, ``{rule, ...}`` file-wide); ``all``
    suppresses every rule on that line or in that file."""
    per_line: Dict[int, set] = {}
    per_file: set = set()
    for i, raw in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(raw)
        if not m:
            continue
        rules = {r.strip() for r in m.group("rules").split(",") if r.strip()}
        if m.group("scope"):
            per_file |= rules
        else:
            per_line.setdefault(i, set()).update(rules)
    return per_line, per_file


def _suppressed(f: Finding, per_line, per_file) -> bool:
    if "all" in per_file or f.rule in per_file:
        return True
    rules = per_line.get(f.line, ())
    return "all" in rules or f.rule in rules


def iter_py_files(paths: Sequence[str]) -> Iterator[str]:
    """Every ``.py`` file of ``paths`` (files, or directories walked in
    sorted order, ``__pycache__`` and hidden directories skipped)."""
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
            continue
        if not os.path.isdir(p):
            raise OSError(f"no such file or directory: {p}")
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs
                             if d != "__pycache__" and not d.startswith("."))
            for fn in sorted(files):
                if fn.endswith(".py"):
                    yield os.path.join(root, fn)


def check_file(path: str, rules: Optional[Iterable[Rule]] = None,
               text: Optional[str] = None
               ) -> Tuple[List[Finding], List[Finding]]:
    """Lint one file → (active findings, suppressed findings).  A syntax
    error is itself a finding (rule ``E0``), so an unparsable file fails
    the run instead of being skipped."""
    if text is None:
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
    try:
        ctx = ModuleCtx(path, text)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 1, (e.offset or 0) + 1, "E0",
                        "error", f"syntax error: {e.msg}")], []
    per_line, per_file = parse_suppressions(ctx.lines)
    active: List[Finding] = []
    suppressed: List[Finding] = []
    for rule in (all_rules() if rules is None else rules):
        for f in rule.check(ctx):
            (suppressed if _suppressed(f, per_line, per_file)
             else active).append(f)
    key = (lambda f: (f.line, f.col, f.rule))
    return sorted(active, key=key), sorted(suppressed, key=key)


def run_paths(paths: Sequence[str], select: Optional[Sequence[str]] = None,
              ignore: Optional[Sequence[str]] = None):
    """Lint every ``.py`` under ``paths`` → (findings, suppressed, nfiles).
    ``select``/``ignore`` filter by rule id; an unknown id raises, so a
    typo cannot turn a gate off."""
    rules = all_rules()
    for rid in list(select or []) + list(ignore or []):
        if rid not in REGISTRY:
            raise ValueError(f"unknown rule id {rid!r} "
                             f"(have {sorted(REGISTRY)})")
    if select:
        rules = [r for r in rules if r.id in set(select)]
    if ignore:
        rules = [r for r in rules if r.id not in set(ignore)]
    findings: List[Finding] = []
    suppressed: List[Finding] = []
    nfiles = 0
    for path in iter_py_files(paths):
        nfiles += 1
        a, s = check_file(path, rules)
        findings.extend(a)
        suppressed.extend(s)
    return findings, suppressed, nfiles


def report_json(findings: Sequence[Finding], suppressed: Sequence[Finding],
                nfiles: int) -> dict:
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return {
        "schema": SCHEMA,
        "files": nfiles,
        "findings": [f.to_json() for f in findings],
        "suppressed": [f.to_json() for f in suppressed],
        "counts": counts,
        "ok": not findings,
    }


def render_human(findings: Sequence[Finding], suppressed: Sequence[Finding],
                 nfiles: int) -> str:
    out = [f.render() for f in findings]
    out.append(f"dcomlint: {len(findings)} finding"
               f"{'' if len(findings) == 1 else 's'} "
               f"({len(suppressed)} suppressed) in {nfiles} files")
    return "\n".join(out)


def dump_report(path: str, report: dict) -> None:
    """The JSON report, written atomically (rule D3)."""
    from ..ioutil import atomic_write_json
    atomic_write_json(path, report, indent=2, sort_keys=True)


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def ancestors(node: ast.AST):
    """``node``'s enclosing nodes, innermost first."""
    while hasattr(node, "parent"):
        node = node.parent  # type: ignore[attr-defined]
        yield node


def enclosing_def(node: ast.AST):
    """The innermost function definition holding ``node`` (None at module
    level)."""
    return next((a for a in ancestors(node)
                 if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef))),
                None)
