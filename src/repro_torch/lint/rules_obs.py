"""Observability neutrality rule O1 over the port: obs stays host-side,
and no obs call sits in what a CUDA graph captures."""
from __future__ import annotations

import ast
from typing import Iterator, List, Set

from .core import (Finding, ModuleCtx, Rule, ancestors, dotted_name,
                   enclosing_def, register)

# attributes and names that reach the obs layer from serving code
_OBS_ATTRS = {"obs", "trace", "tracer", "stats"}
_OBS_GLOBALS = {"_OBS", "GLOBAL"}


def _is_graph_capture(expr: ast.AST) -> bool:
    """``torch.cuda.graph(...)`` (a capture context)."""
    return isinstance(expr, ast.Call) \
        and (dotted_name(expr.func) or "").endswith("cuda.graph")


def _defs_named(call: ast.AST, name: str) -> List[ast.AST]:
    """The function definitions named ``name`` in ``call``'s enclosing
    scope."""
    scope: ast.AST = call
    for anc in ancestors(call):
        scope = anc
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Module)):
            break
    return [n for n in ast.walk(scope)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n.name == name]


def captured_bodies(ctx: ModuleCtx) -> List[ast.AST]:
    """What a CUDA graph captures, as far as this module shows it: the
    body of a ``with torch.cuda.graph(...)`` block, a function handed to
    ``torch.cuda.make_graphed_callables``, and the ``body`` a fused
    decode block hands to ``BlockGraphs.run(key, body, feed, ...)``
    (captured on the card): a name resolved to the definitions of the
    calling scope, or, where it is a parameter of that scope, followed
    to the arguments of the module's calls of it."""
    out: List[ast.AST] = []
    calls = [n for n in ast.walk(ctx.tree) if isinstance(n, ast.Call)]
    pending = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                _is_graph_capture(it.context_expr) for it in node.items):
            out.extend(node.body)
    for node in calls:
        fn = dotted_name(node.func) or ""
        if fn.endswith("make_graphed_callables") and node.args:
            pending.append((node, node.args[0]))
        elif fn.endswith("graphs.run"):
            pending.append((node, _arg(node, 1, "body")))
    followed = set()
    while pending:
        call, arg = pending.pop()
        if isinstance(arg, ast.Lambda):
            out.append(arg)
        if not isinstance(arg, ast.Name):
            continue
        defs = _defs_named(call, arg.id)
        out.extend(defs)
        scope = enclosing_def(call)
        if defs or scope is None or (scope.name, arg.id) in followed:
            continue
        params = [a.arg for a in scope.args.args]
        if arg.id not in params:
            continue
        followed.add((scope.name, arg.id))
        i = params.index(arg.id)
        for c in calls:
            name = c.func.attr if isinstance(c.func, ast.Attribute) else (
                c.func.id if isinstance(c.func, ast.Name) else None)
            if name != scope.name:
                continue
            bound = isinstance(c.func, ast.Attribute) and params[0] in (
                "self", "cls")
            pending.append((c, _arg(c, i - bound, arg.id)))
    return out


def _arg(call: ast.Call, i: int, name: str):
    """``call``'s positional argument ``i``, or its keyword ``name``."""
    if 0 <= i < len(call.args):
        return call.args[i]
    return next((k.value for k in call.keywords if k.arg == name), None)


@register
class ObsNeutralityRule(Rule):
    """O1 — observability is host-side only: ``repro_torch/obs/`` imports
    no torch, and serving code makes no obs call inside what a CUDA
    graph captures.

    Tokens are the same with obs on or off (``tests/
    test_torch_obs_serving.py``).  That holds only if the obs layer
    never runs on the device (a torch op in a histogram adds device
    work and host reads) and no span or counter call lands in a captured
    body: a graph records the device work of one Python run, so an obs
    call there counts once at capture and never on replay.  This makes
    the runtime test's precondition a static check (as far as the
    captured body is visible in the module: ``captured_bodies``).
    """
    id = "O1"
    name = "obs-token-neutral"

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        if ctx.in_pkg("repro_torch", "obs"):
            yield from self._check_obs_purity(ctx)
        if ctx.in_pkg("repro_torch", "serving"):
            yield from self._check_no_obs_in_captured(ctx)

    def _check_obs_purity(self, ctx: ModuleCtx):
        for node in ast.walk(ctx.tree):
            mods: List[str] = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            for mod in mods:
                if mod.split(".")[0] == "torch":
                    yield ctx.finding(
                        self, node, f"repro_torch.obs must stay host-side: "
                        f"importing {mod} pulls device compute into the "
                        f"observability layer")

    def _check_no_obs_in_captured(self, ctx: ModuleCtx):
        names = self._obs_imports(ctx) | _OBS_GLOBALS
        seen: Set[int] = set()
        for body in captured_bodies(ctx):
            for n in ast.walk(body):
                if id(n) in seen or not isinstance(n, (ast.Name,
                                                       ast.Attribute)):
                    continue
                hit = (isinstance(n, ast.Name) and n.id in names) or (
                    isinstance(n, ast.Attribute) and n.attr in _OBS_ATTRS)
                if hit:
                    seen.update(id(c) for c in ast.walk(n))
                    yield ctx.finding(
                        self, n, f"obs API {dotted_name(n) or n!r} inside "
                        "a body a CUDA graph captures — instrumentation "
                        "runs on the host, outside the capture")

    @staticmethod
    def _obs_imports(ctx: ModuleCtx) -> Set[str]:
        names: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if mod == "obs" or mod.endswith(".obs") or ".obs." in mod \
                        or mod.startswith("obs."):
                    names.update(a.asname or a.name for a in node.names)
        return names
