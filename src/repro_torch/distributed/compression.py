"""Low-rank gradient compression (PowerSGD-style) with error feedback.

Counterpart of ``repro.distributed.compression``.  Per gradient G
reshaped to [m, n] (all leading axes folded into m; 1-D tensors and
tensors of fewer than ``min_elems`` elements stay dense):

  1. G ← G + E (the error-feedback memory, float32)
  2. P = orthonormalize(G Q)          [one power step; all-reduced in DP]
  3. Q' = Gᵀ P                        [all-reduced in DP]
  4. Ĝ = P Q'ᵀ;  E ← G − Ĝ;  emit Ĝ in the gradient's dtype

This module holds the round trip a receiver would see and the state; the
training step wires it in as ``grad_transform``.  Compression ratio of a
matrix: m·n / (r·(m + n)).

Data parallelism.  Given the process group of the DP super-axis
(``group=``), ``compress_decompress`` runs the protocol's all-reduces:
P = G Q is all-reduced (mean) before it is orthonormalized, Q' = Gᵀ P is
all-reduced (mean), and a leaf that stays dense is all-reduced (mean);
the error-feedback memory stays per rank.  P and Q' are linear in G, so
the round trip every rank sees is the single-process round trip of the
ranks' mean gradient (with the mean error memory), up to the order of
the float sums.  The all-reduces sum and then divide by the group size
(gloo has no mean), which at one rank is exact.  :class:`PowerSGD` and
:func:`dp_mean` are the two ``grad_transform``s of a data-parallel train
step (``runtime.steps.make_train_step(mesh=)``); both carry
``dp_sync = True``, the mark such a step checks for.

The initial Q of a leaf is drawn from a ``torch.Generator`` seeded with
the config's seed and a digest of the leaf's path (``zlib.crc32``: every
process draws the same Q, where Python's ``hash`` is salted per
process).  Torch cannot replay ``jax.random``, so ``init_state`` also
takes explicit Q matrices (the reference's, in the parity tests), as the
Lanczos start vector is passed in.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from ..tree import named_leaves, rebuild
from . import sharding as sh

Tree = Any


def _path_seed(path: str) -> int:
    """A process-invariant seed of a leaf's path (crc32, 31 bits)."""
    return zlib.crc32(path.encode("utf-8")) % (2 ** 31)


@dataclasses.dataclass(frozen=True)
class PowerSGDConfig:
    rank: int = 4
    min_elems: int = 65_536       # don't compress tiny tensors
    seed: int = 17


def _compressed(p: torch.Tensor, cfg: PowerSGDConfig) -> bool:
    return p.numel() >= cfg.min_elems and p.dim() >= 2


def _shape2d(shape) -> Tuple[int, int]:
    m = 1
    for d in shape[:-1]:
        m *= d
    return m, shape[-1]


def init_state(params: Tree, cfg: PowerSGDConfig,
               q: Optional[Tree] = None) -> Tree:
    """Per leaf ``{"e": zeros float32, "q": Q [n, rank] float32}``, or
    ``{"e": None, "q": None}`` for a leaf that stays dense.  ``q`` (a
    tree of ``params``' structure) gives the initial Q matrices;
    otherwise each is N(0, 1) from a generator seeded by (``cfg.seed``,
    crc32 of the leaf's path), drawn on the CPU and moved to the
    parameter's device."""
    given = dict(named_leaves(q)) if q is not None else {}
    out = {}
    for name, p in named_leaves(params):
        if not _compressed(p, cfg):
            out[name] = {"e": None, "q": None}
            continue
        n = p.shape[-1]
        if name in given:
            qm = torch.as_tensor(given[name], dtype=torch.float32)
        else:
            gen = torch.Generator().manual_seed(
                cfg.seed * 2 ** 31 + _path_seed(name))
            qm = torch.randn(n, cfg.rank, generator=gen)
        if tuple(qm.shape) != (n, cfg.rank):
            raise ValueError(f"{name}: Q {tuple(qm.shape)} != "
                             f"({n}, {cfg.rank})")
        out[name] = {"e": torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device),
                     "q": qm.to(p.device)}
    return rebuild(params, out)


def _state_of(state: Tree, name: str):
    node = state
    for k in name.split("/"):
        node = node[k]
    return node


def _mean(t: torch.Tensor, group, what: str) -> torch.Tensor:
    """``t`` all-reduced to its mean over ``group``, in place (None: the
    tensor itself)."""
    if group is None:
        return t
    sh.all_reduce(t, group, what)
    return t.div_(dist.get_world_size(group))


def compress_decompress(grads: Tree, state: Tree, cfg: PowerSGDConfig,
                        group=None) -> Tuple[Tree, Tree]:
    """The PowerSGD round trip of every gradient (what the receiver sees)
    and the new state (error memory, Q); with a DP ``group``, P, Q' and
    the dense leaves are all-reduced (mean) over it, in leaf order."""
    new_state = {}

    def one(name, g):
        st = _state_of(state, name)
        if st["e"] is None:
            new_state[name] = st
            return _mean(g, group, "grads")
        g32 = g.float() + st["e"]
        g2 = g32.reshape(_shape2d(g32.shape))
        p, _ = torch.linalg.qr(_mean(g2 @ st["q"], group,
                                     "powersgd_p"))          # [m, r]
        q_new = _mean(g2.T @ p, group, "powersgd_q")         # [n, r]
        approx = (p @ q_new.T).reshape(g32.shape)
        new_state[name] = {"e": g32 - approx, "q": q_new}
        return approx.to(g.dtype)

    out = {name: one(name, g) for name, g in named_leaves(grads)}
    return rebuild(grads, out), rebuild(grads, new_state)


def compression_ratio(params: Tree, cfg: PowerSGDConfig) -> float:
    """Dense elements / sent elements over the whole gradient tree."""
    dense = comp = 0
    for _, p in named_leaves(params):
        n = p.numel()
        dense += n
        if not _compressed(p, cfg):
            comp += n
        else:
            m, k = _shape2d(tuple(p.shape))
            comp += cfg.rank * (m + k)
    return dense / comp


class PowerSGD:
    """PowerSGD as a train step's ``grad_transform``: holds the state
    (``init_state`` of ``params``, or the given ``q``) and replaces it
    with every call.  With a DP ``group`` the round trip runs the
    protocol's all-reduces (``dp_sync`` is then True)."""

    def __init__(self, params: Tree, cfg: PowerSGDConfig, group=None,
                 q: Optional[Tree] = None):
        self.cfg, self.group = cfg, group
        self.state = init_state(params, cfg, q)

    @property
    def dp_sync(self) -> bool:
        return self.group is not None

    def __call__(self, grads: Tree) -> Tree:
        out, self.state = compress_decompress(grads, self.state, self.cfg,
                                              self.group)
        return out


def dp_mean(group, skip=(), block=None):
    """The plain DP gradient sync: every leaf all-reduced to its mean
    over ``group``, in leaf order (a ``grad_transform``).  A leaf named
    in ``skip`` was summed over the group in the backward already (its
    all-gather's reduce-scatter) and is only divided; with ``block``
    ({name: dim or None}, ZeRO-1) a leaf with a dim is reduce-scattered
    along it instead, leaving this rank its block of the mean."""
    n = 1 if group is None else dist.get_world_size(group)

    def one(name, g):
        if name in skip:
            return g / n
        d = None if block is None else block[name]
        if d is None:
            return _mean(g, group, "grads")
        return sh.reduce_scatter(g, group, "grads", d).div_(n)

    def sync(grads: Tree) -> Tree:
        return rebuild(grads, {name: one(name, g)
                               for name, g in named_leaves(grads)})
    sync.dp_sync = True
    sync.whole = block is None
    return sync
