"""Determinism and durability rules: D1 (hash/id), D2 (clocks), D3 (atomic
writes), with ``repro.lint``'s semantics over the port's tree."""
from __future__ import annotations

import ast
from typing import Iterator, Optional

from .core import (Finding, ModuleCtx, Rule, ancestors, dotted_name,
                   register)

# keyword names that mark a value as persisted, seeding or addressable:
# an id() flowing into one is process-lifetime state
_SINK_KWARGS = {"seed", "key", "path", "filename", "name", "fname"}
_SINK_CALLS = {"join", "format", "PRNGKey", "fold_in", "prng_key",
               "manual_seed", "crc32", "md5", "sha1", "sha256", "dump",
               "dumps", "write", "save", "put"}


@register
class BuiltinHashRule(Rule):
    """D1 — builtin ``hash()``/``id()`` must not feed persisted keys,
    seeds, or cache filenames.

    ``hash(str)`` is salted per process by PYTHONHASHSEED and ``id()`` is
    an allocation address: both break determinism across processes once
    they reach anything persisted or seeded (the reference's PowerSGD
    once seeded its sketch with ``hash(str(path))``, and two hosts
    compressed with different bases; the port's ``distributed/
    compression.py`` and ``sampling.py`` hash with ``zlib.crc32``).
    ``hash()`` is flagged always; ``id()`` only where it flows into a
    formatting, seeding or path sink (identity-keyed host dicts are
    fine).
    """
    id = "D1"
    name = "builtin-hash-or-id"

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)):
                continue
            if node.func.id == "hash":
                yield ctx.finding(
                    self, node,
                    "builtin hash() is PYTHONHASHSEED-salted; use "
                    "zlib.crc32/hashlib for anything persisted or seeded")
            elif node.func.id == "id" and self._flows_to_sink(node):
                yield ctx.finding(
                    self, node,
                    "id() is an allocation address; it must not flow into "
                    "persisted keys, seeds, or filenames")

    @staticmethod
    def _flows_to_sink(node: ast.Call) -> bool:
        for anc in ancestors(node):
            if isinstance(anc, ast.stmt):
                return False
            if isinstance(anc, (ast.FormattedValue, ast.JoinedStr)):
                return True
            if isinstance(anc, ast.BinOp) and isinstance(anc.op, ast.Mod):
                return True        # "%s" % id(x)
            if isinstance(anc, ast.keyword) and anc.arg in _SINK_KWARGS:
                return True
            if isinstance(anc, ast.Call):
                fn = dotted_name(anc.func) or ""
                if fn.rsplit(".", 1)[-1] in _SINK_CALLS:
                    return True
        return False


@register
class WallClockRule(Rule):
    """D2 — no ``time.time()`` for latency or interval math; use
    ``time.perf_counter()`` (or ``monotonic``).

    ``time.time()`` is the wall clock: NTP slews and steps make its
    deltas lie.  The port's serving TTFT/ITL, tuner timings and compile
    watch use ``perf_counter``; a true epoch use (a checkpoint's age
    against file mtimes, ``checkpoint.gc_old``) carries an inline
    ``# dcomlint: disable=D2`` with its reason.
    """
    id = "D2"
    name = "wall-clock-interval"

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        from_time = {
            a.asname or a.name
            for node in ast.walk(ctx.tree)
            if isinstance(node, ast.ImportFrom) and node.module == "time"
            for a in node.names if a.name == "time"}
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = dotted_name(node.func)
            if fn == "time.time" or (fn in from_time if fn else False):
                yield ctx.finding(
                    self, node,
                    "time.time() is wall-clock; use time.perf_counter() "
                    "for intervals (suppress with a justification for "
                    "true epoch-time uses)")


@register
class AtomicWriteRule(Rule):
    """D3 — file writes use the temporary file + ``os.replace`` pattern.

    A bare ``open(path, "w")`` truncates the destination first: a crash
    or a concurrent reader mid-write sees an empty or partial file (the
    reference lost a serving run to a truncated threshold table).  A
    function that opens a file for writing must also call
    ``os.replace``/``os.rename`` in the same scope, or better write
    through ``repro_torch.ioutil.atomic_write_text/json``; the
    checkpoint writes its files into a temporary directory that one
    ``os.replace`` publishes.
    """
    id = "D3"
    name = "non-atomic-write"

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "open"):
                continue
            mode = self._mode(node)
            if mode is None or not any(c in mode for c in "wx"):
                continue
            if self._scope_has_replace(node):
                continue
            yield ctx.finding(
                self, node,
                f"open(..., {mode!r}) without os.replace in scope — write "
                "through repro_torch.ioutil.atomic_write_text/json (tmp + "
                "os.replace) so a crash never leaves a truncated file")

    @staticmethod
    def _mode(node: ast.Call) -> Optional[str]:
        if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant) \
                and isinstance(node.args[1].value, str):
            return node.args[1].value
        for kw in node.keywords:
            if kw.arg == "mode" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                return kw.value.value
        return None

    @staticmethod
    def _scope_has_replace(node: ast.AST) -> bool:
        scope: ast.AST = node
        for anc in ancestors(node):
            scope = anc
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Module)):
                break
        for n in ast.walk(scope):
            if isinstance(n, ast.Call):
                fn = dotted_name(n.func) or ""
                if fn in ("os.replace", "os.rename"):
                    return True
        return False
