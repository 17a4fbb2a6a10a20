"""Decomposed-execution step functions.

Counterpart of the decomposed half of ``repro.runtime.steps``: each
factory resolves ONE :class:`~repro_torch.engine.DecomposeEngine` (from an
engine or an ``EngineConfig`` that carries a policy) and threads it
through every block — no per-call rank or hook plumbing.  The returned
functions take tensors on the device the caller chose (the card by
default; the CPU tests pass host tensors).
"""
from __future__ import annotations

from typing import Callable, Union

from ..configs import ArchConfig
from ..engine import DecomposeEngine, EngineConfig
from ..models import decomposed as D

EngineLike = Union[DecomposeEngine, EngineConfig]


def _resolve_policy_engine(engine: EngineLike) -> DecomposeEngine:
    if isinstance(engine, EngineConfig):
        engine = DecomposeEngine(engine)
    if engine.config.policy is None:
        raise ValueError(
            "decomposed forward/quality steps need a DecompositionPolicy: "
            "pass a DecomposeEngine (or EngineConfig) whose policy is set")
    return engine


def make_decomposed_forward_step(cfg: ArchConfig,
                                 engine: EngineLike) -> Callable:
    """forward(params, tokens [B, S]) → logits [B, S, V] with
    policy-selected decomposed execution."""
    engine = _resolve_policy_engine(engine)

    def forward_step(params, tokens):
        return D.forward(params, cfg, tokens, engine)
    return forward_step


def make_decomposed_quality_step(cfg: ArchConfig,
                                 engine: EngineLike) -> Callable:
    """quality(params, tokens) → KL(dense ‖ decomposed) over the vocab."""
    engine = _resolve_policy_engine(engine)

    def quality_step(params, tokens):
        return D.logit_kl(params, cfg, tokens, engine)
    return quality_step
