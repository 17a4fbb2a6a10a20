"""Family dispatch rule F1 (family-table-complete), over the port."""
from __future__ import annotations

import ast
from typing import Iterator, Optional

from .core import Finding, ModuleCtx, Rule, ancestors, register

# the registered dispatch points: the ModelFns table (models.api) and the
# ServingFamily registry (serving.families); a family key is resolved
# there, once, and everything downstream calls through the result
_DISPATCH_FNS = {"model_fns", "serving_family"}


def _is_family_key(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == "family") \
        or (isinstance(node, ast.Name) and node.id == "family")


@register
class FamilyDispatchRule(Rule):
    """F1 — no per-family comparison or table lookup in the serving
    engine or the model API outside the registered resolvers.

    Ad-hoc ``cfg.family`` branches drift: the reference's engine once
    grew a vlm/audio if-chain beside ``ModelFns.prefill_inputs``, and a
    new family fell through to the dense arm.  The extension points are
    the ``ModelFns`` registry (``models.api.model_fns``) and the
    ``ServingFamily`` registry (``serving.families.serving_family``):
    inside those a family-keyed lookup is the design; anywhere else in
    ``repro_torch/serving/`` or ``repro_torch/models/api.py`` a
    ``cfg.family`` comparison or subscript is a second table waiting to
    go stale.  An ``assert cfg.family == ...`` guard is a loud
    constraint, not a dispatch, and is exempt.
    """
    id = "F1"
    name = "family-table-complete"

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        if not (ctx.in_pkg("repro_torch", "serving")
                or (ctx.in_pkg("repro_torch", "models")
                    and ctx.parts[-1] == "api.py")):
            return
        for node in ast.walk(ctx.tree):
            use = self._family_dispatch(node)
            if use is None or self._exempt(node):
                continue
            yield ctx.finding(
                self, node,
                f"per-family {use} outside the registered dispatch "
                "tables — register a ServingFamily "
                "(serving.families) or extend the ModelFns entry "
                "(models.api) instead of branching on cfg.family")

    @staticmethod
    def _family_dispatch(node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Compare):
            if _is_family_key(node.left) \
                    or any(_is_family_key(c) for c in node.comparators):
                return "comparison"
        elif isinstance(node, ast.Subscript):
            if _is_family_key(node.slice):
                return "table lookup"
        return None

    @staticmethod
    def _exempt(node: ast.AST) -> bool:
        for anc in ancestors(node):
            if isinstance(anc, ast.Assert):
                return True          # a loud guard, not a silent dispatch
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and anc.name in _DISPATCH_FNS:
                return True          # inside a registered resolver
        return False
