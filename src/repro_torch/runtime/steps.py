"""Step functions: the train step (gradient, optional compression,
clip, optimizer), the eval step, the train state, and the decomposed
forward and quality steps.

Counterpart of ``repro.runtime.steps``.  The train and eval steps run
each family's ``loss_fn`` through the kernel set of ``backend``
(``"cuda"``: the hand-written kernels and their backward kernels on the
card; ``"reference"``: the plain versions under autograd, the route
check).  Gradients come from ``torch.autograd.grad`` on detached aliases
of the parameters (no ``.grad`` is kept); the optimizer then updates the
parameters in place (``optim``).  Each decomposed-step factory resolves
ONE :class:`~repro_torch.engine.DecomposeEngine` (from an engine or an
``EngineConfig`` that carries a policy) and threads it through every
block.  The returned functions take tensors on the device the caller
chose (the card by default; the CPU tests pass host tensors).

A train step made with ``mesh=`` (a ``DeviceMesh`` whose "model" axis is
1) is data-parallel, one process per device, every rank holding the
whole parameters and optimizer state: it takes the GLOBAL batch, keeps
the rank's block of each leaf's leading dim (``distributed.sharding.
batch_spec``'s rule: rank i of the DP group takes rows [i·b/dp,
(i+1)·b/dp); a leading dim that dp does not divide stays whole on every
rank; a batch-1 batch that the rule shards along its sequence raises),
and syncs the gradients over the DP group before the global clip, so
the clip and the optimizer see the global gradient as the reference's
GSPMD step does.  Each family's loss is a mean over its counted tokens
(labels other than −1), so a rank's gradient is scaled by n_i·dp / N (n_i
its counted tokens, N the sum) before the sync averages it: the result
is the gradient of the global mean whatever the shards' counts, and the
scale is exactly 1 when they are equal.  The logged loss is the same
weighted mean, all-reduced.  A config with experts (``num_experts`` > 0)
keeps the whole batch on every rank instead, as its serving keeps every
slot (``serving.families.MoEServing.slot_sharded``): ``moe_ffn`` sizes
each expert's capacity from the tokens of the call, and the auxiliary
balance loss is a statistic of the whole batch, so a split batch would
drop other tokens and balance other counts than the reference's global
step; every rank then computes the whole-batch gradient, and the sync
averages identical gradients.  The sync is ``grad_transform``: by
default ``distributed.compression.dp_mean`` over the DP group; a given
transform must carry ``dp_sync`` (``compression.PowerSGD`` built with
the group does).  Such a step resumes from a checkpoint through
``runtime.driver.unshard(restore_for_mesh(...))``.

On a "model" axis larger than 1 (tensor parallelism) the parameters
are the rank's ``params_sharding`` blocks (:func:`shard_train_state`), the loss
runs under ``distributed.tp.use`` (Megatron layers, vocab-parallel
cross-entropy, expert-parallel ``moe_ffn_shard_map``, Mamba2's block of
heads; every family), and each rank's gradients are of its blocks (a
replicated leaf that ranks read in part, as Mamba2's conv taps, A, D,
dt bias and gated-norm scale, carries the whole gradient on every model
rank).  The extra batch leaves (``image_embeds``, ``frames``) are
split over DP with the tokens and replicated over "model".  With
``zero1=True`` the optimizer is ZeRO-1 (``opt_state_sharding``): each
DP rank holds its block of AdamW's m and v, the gradient of a leaf with
a ZeRO-1 dim is reduce-scattered over the DP group instead of
all-reduced (PowerSGD, when given, syncs
the whole gradient and the rank keeps its block), the rank updates its
block of the parameter and the updated blocks are all-gathered.  Either
way the global clip sums each leaf's squares once over the mesh
(``optim.clip_sharded``: a block that M ranks hold alike counts 1/M on
each).  Such a step takes ``driver.restore_for_mesh``'s DTensors as they
are (their local blocks), with no ``unshard``.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import torch

from ..configs import ArchConfig
from ..distributed import compression as comp, sharding as sh
from ..distributed import tp as TP
from ..engine import DecomposeEngine, EngineConfig
from ..engine.config import tp_mesh as _tp_mesh
from ..kernels.ops import make_kernels
from ..models import api
from ..models import decomposed as D
from ..optim import AdamW, clip_by_global_norm, clip_sharded, make_optimizer
from ..tree import leaves, named_leaves, rebuild, tree_map, unflatten_like

Tree = Any

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


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def value_and_grad(loss_of: Callable, params: Tree, batch
                   ) -> Tuple[torch.Tensor, Tree]:
    """(loss, gradient tree) of ``loss_of(params, batch)``: the loss is
    taken on detached aliases of the parameters that require a gradient,
    so the caller's tensors keep no ``.grad``; a parameter the loss does
    not reach gets a zero gradient."""
    flat = leaves(params)
    req = [p.detach().requires_grad_(p.is_floating_point()) for p in flat]
    loss = loss_of(unflatten_like(params, req), batch)
    wrt = [r for r in req if r.requires_grad]
    grads = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    out = []
    for r in req:
        g = next(grads) if r.requires_grad else None
        out.append(torch.zeros_like(r) if g is None else g)
    return loss.detach(), unflatten_like(params, out)


class _Layout:
    """Where each leaf of a sharded train state lives: its param spec,
    its ZeRO-1 dim (the dim ``opt_state_sharding`` adds the DP axis to,
    None for none), whether its gradient is already reduced over "data"
    (2-D expert weights), and the clip weight of its local block."""

    def __init__(self, cfg, opt, mesh, tp: bool, zero1: bool):
        p_abs, o_abs = abstract_train_state(cfg, opt)
        m_size = sh.model_size(mesh)
        dp = sh.dp_size(mesh)
        self.spec, self.block, self.data_reduced, self.weight = {}, {}, {}, {}
        for name, leaf in named_leaves(p_abs):
            shape = tuple(leaf.shape)
            rule = sh.param_spec(name, shape, mesh, cfg)
            spec = rule if tp else sh.Spec(*([None] * len(shape)))
            self.spec[name] = spec
            flat = [a for e in spec for a in
                    (e if isinstance(e, tuple) else (e,)) if e is not None]
            self.data_reduced[name] = "data" in flat and dp > 1
            dim = None
            if zero1 and len(shape) >= 1:     # opt_state_sharding's dim
                z = sh._zero1(rule, shape, mesh)
                dim = next((d for d, (a, b) in enumerate(zip(rule, z))
                            if a != b), None)
                if dim is not None and self.data_reduced[name]:
                    raise NotImplementedError(
                        f"{name}: ZeRO-1 of a leaf already sharded over "
                        f"'data' (expert_sharding='2d') is not ported")
            self.block[name] = dim
            rep = 1
            if "model" not in flat:
                rep *= m_size
            if dim is None and not self.data_reduced[name]:
                rep *= dp
            self.weight[name] = 1.0 / rep


class _DPGather:
    """``gather(block, dim, name)``: the DP group's blocks of a leaf
    concatenated along ``dim`` (ZeRO-1's parameter all-gather)."""

    def __init__(self, mesh):
        self.group = sh.dp_group(mesh)
        self.rank = sh.dp_rank(mesh)

    def __call__(self, blk, dim, name):
        return sh.gather_dim(blk, self.group, "params", dim)


def local_blocks(tree):
    """Each DTensor leaf of ``tree`` as its local block (its shard on this
    rank), any other leaf as it is."""
    def one(t):
        return t.to_local() if hasattr(t, "to_local") else t
    return tree_map(one, tree)


def shard_train_state(cfg: ArchConfig, params: Tree, opt_state: Tree,
                      mesh, *, zero1: bool = False, optimizer=None):
    """(params, opt_state) of whole trees as the blocks a train step made
    with the same ``mesh``/``zero1`` takes: the parameters'
    ``params_sharding`` blocks under tensor parallelism, and with ZeRO-1
    the DP rank's block of m and v (``opt_state_sharding``)."""
    tp = _tp_mesh(mesh) is not None
    lay = _Layout(cfg, optimizer or make_optimizer(cfg), mesh, tp, zero1)
    if tp:
        params = sh.shard_params(params, mesh, cfg)
    if not zero1:
        if tp:
            opt_state = dict(opt_state, **{
                k: sh.shard_params(opt_state[k], mesh, cfg)
                for k in ("m", "v")})
        return params, opt_state
    i = sh.dp_rank(mesh)
    where = sh.coords(mesh)

    def block(name, t):
        full = t.shape
        t = sh.local_block(t, lay.spec[name], mesh, where) if tp else t
        d = lay.block[name]
        if d is not None:
            n = t.shape[d] // sh.dp_size(mesh)
            t = t.narrow(d, i * n, n)
        return t if t.shape == full else t.clone()
    out = dict(opt_state)
    for k in ("m", "v"):
        out[k] = rebuild(opt_state[k], {n: block(n, t) for n, t in
                                        named_leaves(opt_state[k])})
    return params, out


def whole_train_state(cfg: ArchConfig, params: Tree, opt_state: Tree,
                      mesh, *, zero1: bool = False, optimizer=None):
    """:func:`shard_train_state`'s inverse: the whole trees on every rank
    (all-gathers of the blocks; every rank calls it), so a checkpoint
    does not depend on the mesh it was saved on."""
    tp = _tp_mesh(mesh) is not None
    lay = _Layout(cfg, optimizer or make_optimizer(cfg), mesh, tp, zero1)
    params, opt_state = local_blocks(params), local_blocks(opt_state)

    def whole(name, t, moment):
        d = lay.block[name]
        if moment and zero1 and d is not None:
            t = sh.gather_dim(t, sh.dp_group(mesh), "checkpoint", d)
        if tp:
            t = sh.gather_block(t, lay.spec[name], mesh, "checkpoint")
        return t
    params = rebuild(params, {n: whole(n, t, False)
                              for n, t in named_leaves(params)})
    out = dict(opt_state)
    for k in ("m", "v"):
        out[k] = rebuild(opt_state[k], {n: whole(n, t, True) for n, t in
                                        named_leaves(opt_state[k])})
    return params, out


def make_train_step(cfg: ArchConfig, optimizer=None,
                    max_grad_norm: float = 1.0, microbatches: int = 1,
                    grad_transform: Optional[Callable] = None,
                    backend: str = "cuda", mesh=None,
                    zero1: bool = False) -> Callable:
    """train_step(params, opt_state, batch) → (params, opt_state,
    {"loss", "grad_norm"}), the reference's step: the gradient of the
    family's ``loss_fn``, ``grad_transform`` (e.g. PowerSGD), the global
    clip, the optimizer.  ``microbatches`` > 1 splits the batch on its
    first axis and accumulates float32 gradients in a loop (the
    reference scans); the loss and gradients are then the microbatch
    means.  The parameters are updated in place and returned.  With
    ``mesh`` the step is data-parallel, tensor-parallel on a "model"
    axis larger than 1, and ZeRO-1 as ``zero1`` asks (module
    docstring)."""
    fns = api.model_fns(cfg)
    opt = optimizer or make_optimizer(cfg)
    kernels = make_kernels(backend)
    tpm = _tp_mesh(mesh)
    lay = None
    if mesh is not None:
        sh.require_groups(mesh, "a train step")
        if zero1 and not isinstance(opt, AdamW):
            raise NotImplementedError(
                f"ZeRO-1 of {type(opt).__name__}: the port's ZeRO-1 step "
                f"is AdamW's; Adafactor's factored state on a DP mesh is "
                f"an item of ROADMAP.md's distribution work")
        if tpm is not None or zero1:
            lay = _Layout(cfg, opt, mesh, tpm is not None, zero1)
        if grad_transform is None:
            skip = {n for n, r in (lay.data_reduced.items() if lay else ())
                    if r}
            grad_transform = comp.dp_mean(sh.dp_group(mesh), skip=skip,
                                          block=None if not zero1 else
                                          lay.block)
        elif not getattr(grad_transform, "dp_sync", False):
            raise ValueError(
                "a data-parallel train step needs a grad_transform that "
                "syncs over the DP group (dp_sync): compression.dp_mean "
                "or compression.PowerSGD(..., group=)")

    def loss_of(params, batch):
        return fns.loss_fn(params, cfg, batch, kernels)

    def grads_of(params, batch):
        if microbatches == 1:
            return value_and_grad(loss_of, params, batch)
        loss = torch.zeros((), device=leaves(params)[0].device)
        grads = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        for i in range(microbatches):
            mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                               + tuple(v.shape[1:]))[i]
                  for k, v in batch.items()}
            l_i, g_i = value_and_grad(loss_of, params, mb)
            tree_map(lambda a, b: a.add_(b.float()), grads, g_i)
            loss = loss + l_i
        loss = loss / microbatches
        grads = tree_map(lambda g: g / microbatches, grads)
        return loss, grads

    def train_step(params, opt_state, batch):
        if mesh is not None:
            params, opt_state = local_blocks(params), local_blocks(opt_state)
            batch, weight = _dp_shard(batch, mesh, cfg.num_experts == 0)
        with TP.use(tpm):
            loss, grads = grads_of(params, batch)
        if mesh is not None:
            grads, loss = _dp_weigh(grads, loss, weight, mesh)
        if grad_transform is not None:
            grads = grad_transform(grads)
            if zero1 and getattr(grad_transform, "whole", True):
                grads = _dp_blocks(grads, lay, mesh)
        if lay is None:
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        else:
            grads, gnorm = clip_sharded(grads, max_grad_norm, lay.weight,
                                        lambda t: _mesh_sum(t, mesh))
        if zero1:
            params, opt_state = opt.update_zero1(grads, opt_state, params,
                                                 lay.block, _DPGather(mesh))
        else:
            params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def _dp_blocks(grads, lay, mesh):
    """The DP rank's ZeRO-1 block of each whole (synced) gradient."""
    i, dp = sh.dp_rank(mesh), sh.dp_size(mesh)

    def one(name, g):
        d = lay.block[name]
        if d is None:
            return g
        n = g.shape[d] // dp
        return g.narrow(d, i * n, n)
    return rebuild(grads, {n: one(n, g) for n, g in named_leaves(grads)})


def _mesh_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t``'s sum over the whole mesh: over "model", then over the DP
    super-axis."""
    t = t.reshape(1).clone()
    if sh.model_size(mesh) > 1:
        sh.all_reduce(t, sh.model_group(mesh), "grad_norm")
    sh.all_reduce(t, sh.dp_group(mesh), "grad_norm")
    return t.reshape(())


def _dp_shard(batch, mesh, split: bool):
    """(this rank's block of ``batch``, or all of it unless ``split``, and
    its gradient weight n_i·dp / N)."""
    dp, i = sh.dp_size(mesh), sh.dp_rank(mesh)
    local = dict(batch)
    for k, v in (batch.items() if split else ()):
        spec = sh.batch_spec(tuple(v.shape), mesh)
        if len(spec) > 1 and spec[1] is not None:
            raise NotImplementedError(
                f"batch leaf {k!r} {tuple(v.shape)}: a batch-1 batch "
                f"shards its sequence over the DP axis, which the port's "
                f"train step does not run yet (the model-axis slice of "
                f"ROADMAP.md's distribution work)")
        if spec and spec[0] is not None:
            n = v.shape[0] // dp
            local[k] = v[i * n:(i + 1) * n]
    n_i = torch.clamp((local["labels"] != -1).sum(), min=1).to(
        torch.float64)
    total = n_i.clone()
    sh.all_reduce(total, sh.dp_group(mesh), "token_count")
    return local, (n_i * dp / total).to(torch.float32)


def _dp_weigh(grads, loss, weight, mesh):
    """Scale this rank's gradient by its weight (skipped when it is 1),
    and all-reduce the weighted loss to the global mean."""
    if bool(weight != 1.0):
        grads = tree_map(lambda g: g * weight.to(g.dtype), grads)
    wl = (loss.float() * weight).reshape(1)
    sh.all_reduce(wl, sh.dp_group(mesh), "loss")
    return grads, (wl / sh.dp_size(mesh)).reshape(()).to(loss.dtype)


def make_eval_step(cfg: ArchConfig, backend: str = "cuda") -> Callable:
    """eval_step(params, batch) → {"loss"}, without a gradient."""
    fns = api.model_fns(cfg)
    kernels = make_kernels(backend)

    def eval_step(params, batch):
        with torch.no_grad():
            return {"loss": fns.loss_fn(params, cfg, batch, kernels)}
    return eval_step


def init_train_state(cfg: ArchConfig, generator: torch.Generator,
                     optimizer=None, device=None) -> Tuple[Tree, Tree]:
    """(params, optimizer state): the family's random init from
    ``generator`` on ``device``, and the optimizer's zero state."""
    fns = api.model_fns(cfg)
    opt = optimizer or make_optimizer(cfg)
    params = fns.init(cfg, generator, device)
    return params, opt.init(params)


def abstract_train_state(cfg: ArchConfig, optimizer=None
                         ) -> Tuple[Tree, Tree]:
    """(params, optimizer state) on the ``meta`` device: shapes and dtypes
    with no memory behind them (the reference's ``jax.eval_shape``); the
    template a checkpoint restores into."""
    return init_train_state(cfg, torch.Generator(), optimizer,
                            device="meta")
