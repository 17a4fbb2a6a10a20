"""The port's torch rules: J2 (host sync in the serving hot path) and K1
(every kernel launch checked and counted)."""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set

from .core import (Finding, ModuleCtx, Rule, dotted_name, enclosing_def,
                   register)

_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}


@register
class HostSyncHotPathRule(Rule):
    """J2 — no host-synchronizing call on device values in the serving
    hot path (modules under ``repro_torch/serving/``).

    ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
    ``torch.cuda.synchronize()`` and ``float()``/``int()`` of a torch
    call's result each block the host until the device catches up.  The
    engine keeps the card fed only while its dispatches are enqueued
    ahead of it (a fused decode block is one graph replay, an async
    prefill runs on its own stream); a stray sync in ``step()`` or a
    family's decode re-serializes it without any test failing.  The
    sanctioned reads are the one readback of a decode block's tokens
    and the sampler's (``BlockGraphs.run``, ``Engine._sample_host``),
    suppressed inline with their reasons.
    """
    id = "J2"
    name = "host-sync-hot-path"

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        if not ctx.in_pkg("repro_torch", "serving"):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = dotted_name(node.func) or ""
            if fn.endswith("cuda.synchronize"):
                yield ctx.finding(
                    self, node, f"{fn}() blocks the host on device work "
                    "inside the serving hot path")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _SYNC_METHODS \
                    and not node.args and not node.keywords:
                yield ctx.finding(
                    self, node, f".{node.func.attr}() forces a device→host "
                    "sync inside the serving hot path")
            elif fn in ("float", "int") and node.args \
                    and isinstance(node.args[0], ast.Call) \
                    and (dotted_name(node.args[0].func) or "").startswith(
                        "torch."):
                yield ctx.finding(
                    self, node, f"{fn}() of a torch result reads it back "
                    "to the host inside the serving hot path")


def _stream_names(fn: ast.AST) -> Set[str]:
    """Names bound in ``fn`` to a ``....cuda_stream`` handle."""
    out: Set[str] = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Attribute) \
                and n.value.attr == "cuda_stream":
            out.update(t.id for t in n.targets if isinstance(t, ast.Name))
    return out


def _is_launch(call: ast.Call, streams: Set[str]) -> bool:
    """A ctypes call into a kernel library: one that is handed a CUDA
    stream (queries of the library, like its shared-memory sizes, take
    none)."""
    if (dotted_name(call.func) or "").startswith("torch."):
        return False
    for a in call.args:
        if isinstance(a, ast.Attribute) and a.attr == "cuda_stream":
            return True
        if isinstance(a, ast.Name) and a.id in streams:
            return True
    return False


def _counted(fn: ast.AST, counters: Set[str]) -> bool:
    """Whether ``fn`` adds to a module kernel's ``launches`` counter."""
    for n in ast.walk(fn):
        if isinstance(n, ast.AugAssign) and isinstance(n.target,
                                                       ast.Attribute) \
                and n.target.attr == "launches" \
                and isinstance(n.target.value, ast.Name) \
                and n.target.value.id in counters:
            return True
    return False


def _checked(call: ast.Call, fn: ast.AST) -> bool:
    """Whether ``call``'s return code is tested: the call sits in an
    ``if`` test, or its value is bound to a name an ``if`` of ``fn``
    tests."""
    node = call
    while hasattr(node, "parent"):
        parent = node.parent  # type: ignore[attr-defined]
        if isinstance(parent, ast.If) and parent.test is node:
            return True
        if isinstance(parent, ast.stmt):
            break
        node = parent
    stmt = getattr(call, "parent", None)
    if not (isinstance(stmt, ast.Assign) and stmt.value is call):
        return False
    names = {t.id for t in stmt.targets if isinstance(t, ast.Name)}
    for n in ast.walk(fn):
        if isinstance(n, ast.If) and any(
                isinstance(m, ast.Name) and m.id in names
                for m in ast.walk(n.test)):
            return True
    return False


@register
class KernelLaunchRule(Rule):
    """K1 — every ctypes kernel launch in ``repro_torch/kernels/`` checks
    the error code it returns and counts itself in ``launch_counts()``.

    The port's stand-in for the reference's P1 (Pallas launch sites).  A
    launch whose ``cudaError`` is dropped fails later, on an unrelated
    op, or returns garbage; a launch that does not add to its kernel's
    ``launches`` counter (``kernels.ops.launch_counts``) is invisible to
    ``chip_smoke.py``'s proof that the main path went through the
    kernels, and to the graph capture's per-replay launch delta.  A
    launch is a call handed a ``cuda_stream``; the count is an
    ``X.launches += 1`` of a module function X whose counter the module
    initialises, in the launching function or in every function of the
    module that calls it.
    """
    id = "K1"
    name = "kernel-launch-checked-and-counted"

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        if not ctx.in_pkg("repro_torch", "kernels"):
            return
        counters = self._counters(ctx)
        callers = self._callers(ctx)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = enclosing_def(node)
            if fn is None or not _is_launch(node, _stream_names(fn)):
                continue
            if not _checked(node, fn):
                yield ctx.finding(
                    self, node, "kernel launch whose returned error code "
                    "is not checked")
            users = callers.get(fn.name, [])
            if not (_counted(fn, counters) or (
                    users and all(_counted(u, counters) for u in users))):
                yield ctx.finding(
                    self, node, "kernel launch that no `launches` counter "
                    "counts (launch_counts() cannot see it)")

    @staticmethod
    def _counters(ctx: ModuleCtx) -> Set[str]:
        """Module functions whose ``launches`` counter the module sets."""
        defs = {n.name for n in ctx.tree.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        out: Set[str] = set()
        for n in ctx.tree.body:
            if isinstance(n, ast.Assign):
                for t in n.targets:
                    if isinstance(t, ast.Attribute) \
                            and t.attr == "launches" \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id in defs:
                        out.add(t.value.id)
        return out

    @staticmethod
    def _callers(ctx: ModuleCtx) -> Dict[str, List[ast.AST]]:
        """Function name → the functions of the module that call it."""
        out: Dict[str, List[ast.AST]] = {}
        for n in ast.walk(ctx.tree):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name):
                caller: Optional[ast.AST] = enclosing_def(n)
                if caller is not None:
                    out.setdefault(n.func.id, []).append(caller)
        return out
