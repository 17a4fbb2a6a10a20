"""Optimizers of the training path: AdamW, Adafactor, the cosine
schedule and global-norm clipping.

Counterpart of ``repro.optim``.  They work as functions on the nested
dict trees of the port (the parameters, the gradients, the state), in
the reference's arithmetic order, and keep the reference's state names
and layout, so a checkpoint of either package restores in the other:
AdamW ``{"m", "v", "step"}`` (float32 moments shaped like each
parameter, an int32 step), Adafactor ``{"fac", "step"}`` with
``fac/<param path>/vr|vc`` (factored row and column second moments) or
``/v``.  The step and the learning rate stay on the parameters' device,
so an update reads nothing back to the host.

Unlike the reference's (JAX arrays are immutable), ``AdamW.update``
updates the parameters, m and v IN PLACE, one slice of at most
``CHUNK`` elements of a leaf at a time: the float32 temporaries of the
update then stay small (a whole float32 copy of granite-3-2b's stacked
``w_up`` [40, 2048, 8192] would be 2.7 GB, and the update makes several).
Elementwise arithmetic is the same in slices as whole.

On a mesh (``runtime.steps.make_train_step(mesh=, zero1=True)``)
:meth:`AdamW.update_zero1` is ZeRO-1: each DP rank holds and updates its
block of m, v and the parameter, and the updated blocks are all-gathered
back; :func:`clip_sharded` is the global clip over sharded gradients.
:meth:`Adafactor.update` with a layout is Adafactor's: each rank holds
the blocks of vr, vc and v that ``opt_state_sharding`` gives them and
updates its block of the parameter; the row and column statistics that
other ranks' blocks hold come from counted all-reduces.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch

from .tree import leaves, named_leaves, tree_map

Tree = Any

#: elements of a leaf one slice of the in-place AdamW update takes
CHUNK = 1 << 24


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """lr(step): linear warmup to ``base_lr`` over ``warmup`` steps, then a
    cosine decay to 0 at ``total``; float32 on the step's device."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)
    return lr


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scale every gradient by min(1, max_norm / ‖g‖) in float32 and cast
    back to the gradient's dtype → (clipped tree, ‖g‖); ‖g‖ sums the
    leaves' Σ g² in sorted-key order, as the reference does."""
    gn = torch.sqrt(sum((g.float() ** 2).sum() for g in leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def clip_sharded(grads: Tree, max_norm: float, weights: Dict[str, float],
                 reduce) -> Tuple[Tree, torch.Tensor]:
    """:func:`clip_by_global_norm` over sharded gradients: each leaf's Σ g²
    (in sorted-key order, as whole) times ``weights[name]`` (1 / the
    number of ranks that hold the same block, so a replicated block
    counts once), summed, then ``reduce(total)`` (its sum over the mesh)
    before the square root.  Where every weight is 1 and ``reduce`` is a
    one-rank sum, this is :func:`clip_by_global_norm` bit for bit."""
    def term(name, g):
        t = (g.float() ** 2).sum()
        w = weights[name]
        return t if w == 1 else t * w
    total = sum(term(name, g) for name, g in named_leaves(grads))
    gn = torch.sqrt(reduce(total))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def _row_slices(t: torch.Tensor):
    """Slices along ``t``'s first axis of at most :data:`CHUNK` elements
    (at least one row); the whole of a 0-d tensor."""
    if t.dim() == 0:
        yield ...
        return
    per_row = max(1, t[0].numel())
    rows = max(1, CHUNK // per_row)
    for r0 in range(0, t.shape[0], rows):
        yield slice(r0, r0 + rows)


def _check_tree(grads: Tree, params: Tree) -> None:
    pn = [n for n, _ in named_leaves(params)]
    gn = [n for n, _ in named_leaves(grads)]
    if pn != gn:
        raise ValueError(f"gradient tree does not match the parameters: "
                         f"{sorted(set(pn) ^ set(gn))[:5]}")


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params: Tree) -> Dict[str, Tree]:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa
                                      device=p.device)
        dev = leaves(params)[0].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(self, grads: Tree, state: Dict[str, Tree], params: Tree
               ) -> Tuple[Tree, Dict[str, Tree]]:
        """One step: the reference's arithmetic, leaf by leaf; params, m
        and v are updated IN PLACE and returned with the new step."""
        _check_tree(grads, params)
        step = state["step"] + 1
        lr = self.lr(step)
        stepf = step.float()
        b1c = 1.0 - self.b1 ** stepf
        b2c = 1.0 - self.b2 ** stepf
        for g, m, v, p in zip(leaves(grads), leaves(state["m"]),
                              leaves(state["v"]), leaves(params)):
            self._leaf(g, m, v, p, lr, b1c, b2c)
        return params, {"m": state["m"], "v": state["v"], "step": step}

    def _leaf(self, g, m, v, p, lr, b1c, b2c) -> None:
        b1, b2 = self.b1, self.b2
        for sl in _row_slices(p):
            g32 = g[sl].float()
            ms, vs, ps = m[sl], v[sl], p[sl]
            ms.mul_(b1).add_(g32 * (1 - b1))
            vs.mul_(b2).add_((g32 * (1 - b2)) * g32)
            u = (ms / b1c) / (torch.sqrt(vs / b2c) + self.eps)
            p32 = ps.float()
            u = u + self.weight_decay * p32
            ps.copy_(p32 - lr * u)

    def update_zero1(self, grads: Tree, state: Dict[str, Tree],
                     params: Tree, blocks: Dict[str, Any], gather
                     ) -> Tuple[Tree, Dict[str, Tree]]:
        """ZeRO-1: one step where ``state``'s m and v hold this DP rank's
        block of each leaf (``opt_state_sharding``), ``grads`` is the same
        block of the synced gradient, and ``blocks`` maps each leaf's name
        to the dim of its block (None: the leaf is whole on every rank).
        The reference's arithmetic runs on the rank's block of the
        parameter (in place), then ``gather(block, dim, name)`` gives the
        whole leaf back, which is copied into the parameter."""
        _check_tree(grads, params)
        step = state["step"] + 1
        lr = self.lr(step)
        stepf = step.float()
        b1c = 1.0 - self.b1 ** stepf
        b2c = 1.0 - self.b2 ** stepf
        for (name, p), g, m, v in zip(named_leaves(params), leaves(grads),
                                      leaves(state["m"]), leaves(state["v"])):
            dim = blocks[name]
            if dim is None:
                self._leaf(g, m, v, p, lr, b1c, b2c)
                continue
            n = m.shape[dim]
            i = gather.rank
            blk = p.narrow(dim, i * n, n)
            self._leaf(g, m, v, blk, lr, b1c, b2c)
            p.copy_(gather(blk, dim, name))
        return params, {"m": state["m"], "v": state["v"], "step": step}


# ---------------------------------------------------------------------------
# Adafactor (factored second moments; the 1T MoE's optimizer)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Adafactor:
    lr: Callable[[torch.Tensor], torch.Tensor]
    decay: float = 0.8          # beta2_t = 1 - step**-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    @staticmethod
    def _factored(shape) -> bool:
        return len(shape) >= 2

    def init(self, params: Tree) -> Dict[str, Tree]:
        def st(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,  # noqa
                                          device=p.device)
            if self._factored(p.shape):
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        dev = leaves(params)[0].device
        return {"fac": tree_map(st, params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(self, grads: Tree, state: Dict[str, Tree], params: Tree,
               lay=None) -> Tuple[Tree, Dict[str, Tree]]:
        """One step in the reference's arithmetic → (params, state), both
        updated IN PLACE; each leaf's update reads the whole leaf (its
        statistics and RMS clip).  On a mesh (tensor parallelism and/or
        ZeRO-1) the parameters, gradients and state are blocks, and
        ``lay`` (the train step's layout) says where each lies: the
        gradient ``g`` of a leaf is the rank's update block of it
        (``lay.region``), its state leaves the blocks ``lay.state`` names.
        Per leaf:

        * the row and column means of g² + eps over the rank's block: a
          mean over a dim no rank splits is the reference's own (bit for
          bit); over a split dim (``lay.split``: the spec names an axis,
          a one-rank one included) the ranks' sums, all-reduced over the
          axis that splits it (``lay.reduce``), divided;
        * the rank's state block takes the reference's moving average of
          them, IN PLACE (``lay.move``: the statistic's rows gathered
          over the axes that split them, where the state's block is
          another), and is all-gathered whole (``lay.gather``);
        * u over the rank's block; its RMS clip sums u² over the axes
          that split the block;
        * the rank updates its block of the parameter (ZeRO-1: then the
          DP group's blocks are all-gathered, ``lay.param_back``).

        Unfactored leaves (v) do the same with g² itself.  Without
        ``lay`` every leaf is whole (:class:`_Whole`)."""
        _check_tree(grads, params)
        lay = lay or _Whole(params)
        step = state["step"] + 1
        lr = self.lr(step)
        beta2 = 1.0 - step.float() ** (-self.decay)
        fac_of = dict(_param_states(state["fac"], params))
        for (name, p), g in zip(named_leaves(params), leaves(grads)):
            st, reg = fac_of[name], lay.region[name]
            whole = lay.whole[name]
            # contiguous: a reduce-scatter leaves a dim-moved view, and a
            # mean over a view may sum in another order than the
            # reference's over the whole gradient
            g32 = g.float().contiguous()
            g2 = g32 * g32 + self.eps

            def moment(key, dim, rows):
                if dim is None:
                    part = g2
                elif lay.split(reg[dim]):
                    part = lay.reduce(g2.sum(dim), (reg[dim],),
                                      "adafactor_" + key) / whole[dim]
                else:
                    part = g2.mean(dim)
                blk = lay.state[f"fac/{name}/{key}"]
                st[key].copy_(beta2 * st[key] + (1 - beta2) * lay.move(
                    part, rows, blk, "adafactor_" + key + "_rows"))
                return lay.gather(st[key], blk, "adafactor_" + key)

            if self._factored(whole):
                row, col = reg[:-1], reg[:-2] + reg[-1:]
                vr = moment("vr", -1, row)
                vc = moment("vc", -2, col)
                rfac = vr / torch.clamp(vr.mean(dim=-1, keepdim=True),
                                        min=self.eps)
                u = g32 / (torch.sqrt(lay.cut(rfac, row))[..., None]
                           * torch.sqrt(lay.cut(vc, col))[..., None, :]
                           + 1e-12)
            else:
                v = moment("v", None, reg)
                u = g32 / (torch.sqrt(lay.cut(v, reg)) + 1e-12)
            if any(lay.split(e) for e in reg):
                ss = lay.reduce((u * u).sum().reshape(1), reg,
                                "adafactor_rms").reshape(())
                rms_u = torch.sqrt(ss / math.prod(whole) + 1e-12)
            else:
                rms_u = torch.sqrt((u * u).mean() + 1e-12)
            u = u / torch.clamp(rms_u / self.clip_threshold, min=1.0)
            blk = lay.param_block(name, p)
            if self.weight_decay:
                u = u + self.weight_decay * blk.float()
            blk.copy_((blk.float() - lr * u).to(p.dtype))
            lay.param_back(name, p, blk)
        return params, {"fac": state["fac"], "step": step}


class _Whole:
    """The layout of a tree held whole on one device (:meth:`Adafactor.
    update` without a mesh): every block the whole leaf, no dim split, no
    collective."""

    def __init__(self, params: Tree):
        self.whole = {n: tuple(p.shape) for n, p in named_leaves(params)}
        self.region = {n: (None,) * len(s) for n, s in self.whole.items()}
        self.state = collections.defaultdict(lambda: None)

    @staticmethod
    def split(entry) -> bool:
        return False

    @staticmethod
    def reduce(t, spec, what):
        return t

    @staticmethod
    def move(t, src, dst, what):
        return t

    @staticmethod
    def gather(t, spec, what):
        return t

    @staticmethod
    def cut(t, spec):
        return t

    @staticmethod
    def param_block(name, p):
        return p

    @staticmethod
    def param_back(name, p, blk):
        pass


def _param_states(fac: Tree, params: Tree):
    """(parameter name, its Adafactor state dict) for every parameter."""
    for name, _ in named_leaves(params):
        node = fac
        for k in name.split("/"):
            node = node[k]
        yield name, node


def make_optimizer(cfg, base_lr: float = 3e-4, warmup: int = 100,
                   total: int = 10_000):
    """``cfg.optimizer``'s optimizer (AdamW, or Adafactor for "adafactor")
    on the cosine schedule."""
    sched = cosine_schedule(base_lr, warmup, total)
    if cfg.optimizer == "adafactor":
        return Adafactor(lr=sched)
    return AdamW(lr=sched)
