"""The tokens of one model call split over the DP group.

A data-parallel train step splits its batch over the DP super-axis (the
rows, or at batch 1 the sequence's blocks), and a slot-sharded serving
engine decodes its block of the slots; either way rank i of the group
holds the i-th of D equal contiguous blocks of the call's flat token
order.  Most model functions do not care: each token's arithmetic is
its own.  The MoE family's default form does (``models.moe``): the
reference's GSPMD ``moe_ffn`` sizes capacity from, ranks slots in, and
balances the auxiliary loss over the WHOLE call's tokens, so the split
call must reproduce those statistics through the group (:func:`sum`,
:func:`offsets`).

:func:`use` makes a mesh's DP group current for the calls inside it
(process-wide, as ``tp.use`` and ``seq.use``: autograd's backward runs
on other threads).  The caller enters it exactly where the tokens are
split: not around a serving engine's prefill (every rank prefills the
whole admission batch) nor a batch-1 decode (the one token is on every
rank).  Each collective goes through ``sharding``'s counted helpers.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from . import sharding as sh
from .tp import group_sum


class Split(NamedTuple):
    """The group a call's tokens are split over."""
    group: object
    size: int
    rank: int


_CURRENT: list = [None]


def current() -> Optional[Split]:
    """The token split of the calls in flight (None: whole)."""
    return _CURRENT[0]


def of(mesh) -> Optional[Split]:
    """``mesh``'s DP group as a :class:`Split` (None: no mesh)."""
    if mesh is None:
        return None
    return Split(sh.dp_group(mesh), sh.dp_size(mesh), sh.dp_rank(mesh))


@contextlib.contextmanager
def use(mesh):
    """Run the body with its tokens split over ``mesh``'s DP group (a
    group of one rank included: the same collectives, each a copy);
    ``mesh`` None runs it whole."""
    prev = _CURRENT[0]
    _CURRENT[0] = of(mesh)
    try:
        yield _CURRENT[0]
    finally:
        _CURRENT[0] = prev


def total(x: torch.Tensor, split: Split, what: str) -> torch.Tensor:
    """The group's sum of ``x``, all-reduced in the backward too: every
    rank's loss reads every rank's ``x``.  A train step weighs each
    rank's loss by n_i·D/N before its backward (the weights sum to D),
    so the all-reduced gradient, averaged over the group, is the
    gradient of the whole call's statistic."""
    return group_sum(x, split.group, what)


def offsets(counts: torch.Tensor, split: Split, what: str) -> torch.Tensor:
    """The exclusive scan over the group of per-rank ``counts`` [n]
    (integers): the sum of the counts of the ranks before this one (one
    all-gather)."""
    allc = counts.new_empty((split.size * counts.shape[0],))
    sh.all_gather_into(allc, counts.contiguous(), split.group, what)
    return allc.reshape(split.size, -1)[:split.rank].sum(0)
