"""Step functions: the train step (gradient, optional compression,
clip, optimizer), the eval step, the train state, the prefill and decode
steps (the reference's dry-run cells), and the decomposed forward and
quality steps.

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
rank; a batch-1 batch that the rule shards along its sequence trains
sequence sharded, below),
and syncs the gradients over the DP group before the global clip, so
the clip and the optimizer see the global gradient as the reference's
GSPMD step does.  Each family's loss is a mean over its counted tokens
(labels other than −1), so a rank's gradient is scaled by n_i·dp / N (n_i
its counted tokens, N the sum) before the sync averages it: the result
is the gradient of the global mean whatever the shards' counts, and the
scale is exactly 1 when they are equal.  The logged loss is the same
weighted mean, all-reduced.  A config with experts (``num_experts`` > 0)
splits its batch too, and runs under ``distributed.tokens.use``: its
MoE blocks see the rank's rows as a block of the whole batch's tokens.
By default they reproduce the reference's global ``moe_ffn`` (capacity
from the global token count, each slot's rank in its expert offset by
the ranks before it, the auxiliary loss from the group's summed
statistics); with ``cfg.moe_shard_map`` the reference's
``moe_ffn_shard_map`` (capacity from the rank's tokens, the auxiliary
loss averaged over the group).  Either way every rank's loss reads the
group's statistics, so the weight scales the loss before the backward,
whose all-reduces then sum the weighted contributions (the weights sum
to dp, and the sync's mean makes them the gradient of the global
loss).  With ``microbatches`` > 1 each rank holds its block of every
microbatch of the global batch, so microbatch j routes the reference's
microbatch j.  The sync is ``grad_transform``: by
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
are (their local blocks), with no ``unshard``.  Adafactor's ZeRO-1 (and
its tensor-parallel step) keeps vr, vc and v in ``opt_state_sharding``'s
blocks and updates through ``optim.Adafactor.update``'s layout; a leaf
already sharded over "data" (2-D experts) keeps its parameter's blocks
for AdamW's moments (:class:`_Layout`, ROADMAP.md caveat C10).

On a mesh a batch-1 batch (``seq_batch``; every family) runs each rank
on its block of the sequence under ``distributed.seq.use`` (a one-rank
DP group included): the attention's keys gathered, Mamba2's conv halo
and state scan; a cross-attention memory (the vlm's image embeddings,
the audio frames) comes whole and the family keeps its rows where the
group divides them, gathering their K/V.  Every rank's loss then reads
every rank's keys and states, so the weight n_i·dp / N scales the loss
before the backward, and the DP sync sums the ranks' contributions to
the gradient of the global mean.  Megatron-SP (``cfg.seq_parallel``)
runs inside the families' functions, in the blocks the reference sends
through ``transformer.block``, on the mesh's "model" axis, a one-rank
one included (:func:`_tp_mesh`, ``distributed.tp.sp_on``); with
sequence sharding on the same step each rank's block of S is split
again over "model".  A batch-1 sequence the DP group does not divide
runs whole on every rank, as the rules keep it (:func:`seq_batch`).

The decomposed forward and quality steps take ``mesh`` as the prefill
step does: the rank's parameter blocks, its rows of the GLOBAL batch
over DP (decomposed alone: ``local``), its blocks tensor-parallel
(``models.decomposed``), the quality step's KL averaged over the DP
group.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import torch

from ..configs import ArchConfig
from ..distributed import compression as comp, sharding as sh
from ..distributed import seq as SEQ
from ..distributed import tokens as TOK
from ..distributed import tp as TP
from ..engine import DecomposeEngine, EngineConfig
from ..engine.config import tp_mesh
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


def _decomposed_on(cfg: ArchConfig, mesh, what: str) -> Callable:
    """run(body, params, tokens) → (body's result, split): ``body(params,
    tokens, local)`` without a mesh as it is; with ``mesh`` on the
    rank's blocks of ``params`` (``local_blocks``) and its rows of the
    GLOBAL ``tokens`` over DP where dp divides B (``split``; else the
    whole batch), under tensor parallelism on its "model" axis (a
    one-rank one for a seq_parallel config), ``local`` telling the body
    that its rows are already split."""
    tpm = _tp_mesh(mesh, cfg)
    if mesh is not None:
        sh.require_groups(mesh, what)

    def run(body, params, tokens):
        if mesh is None:
            return body(params, tokens, False), False
        dp, i = sh.dp_size(mesh), sh.dp_rank(mesh)
        split = tokens.shape[0] % dp == 0
        if split:
            n = tokens.shape[0] // dp
            tokens = tokens[i * n:(i + 1) * n]
        with TP.use(tpm, one_rank=True):
            return body(local_blocks(params), tokens, split), split
    return run


def make_decomposed_forward_step(cfg: ArchConfig, engine: EngineLike,
                                 mesh=None) -> Callable:
    """forward(params, tokens [B, S], wfactors=None) → logits [B, S, V]
    with policy-selected decomposed execution; ``wfactors`` are the
    whole weights' offline factors (Table 3 mode,
    ``decomposed.decompose_layer_weights``).  With ``mesh``
    (:func:`make_prefill_step`'s contract): the parameters are the
    rank's blocks, the tokens GLOBAL, and the rank runs its rows of the
    batch over DP where dp divides B (else the whole batch), its blocks
    tensor-parallel on the "model" axis (``models.decomposed``); the
    logits are its rows'."""
    engine = _resolve_policy_engine(engine)
    run = _decomposed_on(cfg, mesh, "a decomposed forward step")

    def forward_step(params, tokens, wfactors=None):
        return run(lambda p, t, local: D.forward(p, cfg, t, engine,
                                                 wfactors, local),
                   params, tokens)[0]
    return forward_step


def make_decomposed_quality_step(cfg: ArchConfig, engine: EngineLike,
                                 mesh=None) -> Callable:
    """quality(params, tokens, wfactors=None) → KL(dense ‖ decomposed)
    over the vocab, averaged over every position of the batch; on
    ``mesh`` as :func:`make_decomposed_forward_step`, the ranks' means
    of their rows averaged over the DP group."""
    engine = _resolve_policy_engine(engine)
    run = _decomposed_on(cfg, mesh, "a decomposed quality step")

    def quality_step(params, tokens, wfactors=None):
        kl, split = run(lambda p, t, local: D.logit_kl(p, cfg, t, engine,
                                                       wfactors, local),
                        params, tokens)
        if split:
            kl = kl.reshape(1).clone()
            sh.all_reduce(kl, sh.dp_group(mesh), "kl")
            kl = (kl / sh.dp_size(mesh)).reshape(())
        return kl
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


def _tp_mesh(mesh, cfg):
    """The mesh a step runs tensor-parallel on: ``engine.config.tp_mesh``'s
    (a "model" axis larger than 1), or for a config that asks for
    Megatron-SP any mesh with a "model" axis (at 1, a one-rank group whose
    collectives are copies)."""
    if mesh is not None and cfg.seq_parallel \
            and "model" in sh.mesh_axes(mesh):
        return mesh
    return tp_mesh(mesh)


def _axes(spec) -> list:
    """The mesh axis names a spec's entries name."""
    return [a for e in spec for a in (e if isinstance(e, tuple) else (e,))
            if a is not None]


class _Layout:
    """Where each leaf of a sharded train state lives: its param spec,
    its ZeRO-1 dim (the dim ``opt_state_sharding`` adds the DP axis to,
    None for none), whether its gradient is already reduced over "data"
    (2-D expert weights), the clip weight of its local block, the spec
    of the rank's update block (``region``: the param spec plus the DP
    axis on the ZeRO-1 dim) and of each optimizer-state leaf's block
    (``state``).

    A leaf already sharded over "data" (``expert_sharding="2d"``) gets a
    ZeRO-1 spec from the rules that names "data" twice (the reference's
    ``_zero1``; JAX refuses such a spec, ROADMAP.md caveat C10): the step
    reads it as already split over DP, so its AdamW moments keep the
    parameter's own blocks, with no second split.  Adafactor's vr, vc and
    v keep the rules' blocks (their paths match no parameter rule, so
    their specs name the DP axis once).  ``reduce``, ``move``, ``cut``,
    ``gather``, ``param_block``, ``param_back`` and ``split`` are the
    block arithmetic ``optim.Adafactor.update`` runs on a mesh."""

    def __init__(self, cfg, opt, mesh, tp: bool, zero1: bool):
        p_abs, o_abs = abstract_train_state(cfg, opt)
        m_size = sh.model_size(mesh)
        dp = sh.dp_size(mesh)
        self.mesh = mesh
        self.spec, self.block, self.data_reduced, self.weight = {}, {}, {}, {}
        self.region, self.whole, self.state = {}, {}, {}
        for name, leaf in named_leaves(p_abs):
            shape = tuple(leaf.shape)
            rule = sh.param_spec(name, shape, mesh, cfg)
            spec = rule if tp else sh.Spec(*([None] * len(shape)))
            self.spec[name] = spec
            self.whole[name] = shape
            flat = _axes(spec)
            self.data_reduced[name] = "data" in flat and dp > 1
            dim = None
            if zero1 and len(shape) >= 1 and not self.data_reduced[name]:
                z = sh._zero1(rule, shape, mesh)  # opt_state_sharding's dim
                dim = next((d for d, (a, b) in enumerate(zip(rule, z))
                            if a != b), None)
            self.block[name] = dim
            region = list(spec)
            if dim is not None:
                region[dim] = sh.dp_name(mesh)
            self.region[name] = sh.Spec(*region)
            rep = 1
            if "model" not in flat:
                rep *= m_size
            if dim is None and not self.data_reduced[name]:
                rep *= dp
            self.weight[name] = 1.0 / rep
        for name, leaf in named_leaves(o_abs):
            if name == "step":
                continue
            if name.startswith("fac/"):          # Adafactor: the rules'
                shape = tuple(leaf.shape)
                spec = sh.param_spec(name, shape, mesh, cfg)
                self.state[name] = sh._zero1(spec, shape, mesh) \
                    if zero1 and shape else spec
            else:                                # AdamW m/v: the region
                self.state[name] = self.region[name.split("/", 1)[1]]

    def split(self, entry) -> bool:
        """Whether a spec entry splits its dim (names an axis: a one-rank
        axis too, whose collectives are copies)."""
        return entry is not None

    def reduce(self, t: torch.Tensor, spec, what: str) -> torch.Tensor:
        """``t`` summed over every axis ``spec`` names."""
        for entry in dict.fromkeys(e for e in spec if e is not None):
            t = t.contiguous()
            sh.all_reduce(t, sh.axis_group(self.mesh, entry), what)
        return t

    def move(self, t: torch.Tensor, src, dst, what: str) -> torch.Tensor:
        """This rank's block under ``dst`` of the tensor whose block under
        ``src`` is ``t`` (gathered over ``src``'s axes where they differ)."""
        if tuple(src) == tuple(dst):
            return t
        return self.cut(self.gather(t, src, what), dst)

    def cut(self, t: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block of the whole ``t`` under ``spec``."""
        return sh.local_block(t, spec, self.mesh)

    def gather(self, t: torch.Tensor, spec, what: str) -> torch.Tensor:
        """The whole tensor of this rank's block ``t`` under ``spec``."""
        return sh.gather_block(t, spec, self.mesh, what)

    def param_block(self, name: str, p: torch.Tensor) -> torch.Tensor:
        """The rank's update block of its parameter block ``p`` (a view:
        the ZeRO-1 dim's DP block, or ``p`` itself)."""
        d = self.block[name]
        if d is None:
            return p
        n = p.shape[d] // sh.dp_size(self.mesh)
        return p.narrow(d, sh.dp_rank(self.mesh) * n, n)

    def param_back(self, name: str, p: torch.Tensor, blk: torch.Tensor
                   ) -> None:
        """ZeRO-1: the DP group's updated blocks all-gathered into ``p``."""
        d = self.block[name]
        if d is not None:
            p.copy_(sh.gather_dim(blk, sh.dp_group(self.mesh), "params", d))


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
    tp = _tp_mesh(mesh, cfg) is not None
    lay = _Layout(cfg, optimizer or make_optimizer(cfg), mesh, tp, zero1)
    if tp:
        params = sh.shard_params(params, mesh, cfg)

    def block(name, t):
        if name not in lay.state:
            return t
        b = sh.local_block(t, lay.state[name], mesh)
        return t if b.shape == t.shape else b.clone()
    return params, rebuild(opt_state, {n: block(n, t) for n, t in
                                       named_leaves(opt_state)})


def whole_train_state(cfg: ArchConfig, params: Tree, opt_state: Tree,
                      mesh, *, zero1: bool = False, optimizer=None):
    """:func:`shard_train_state`'s inverse: the whole trees on every rank
    (all-gathers of the blocks; every rank calls it), so a checkpoint
    does not depend on the mesh it was saved on."""
    tp = _tp_mesh(mesh, cfg) is not None
    lay = _Layout(cfg, optimizer or make_optimizer(cfg), mesh, tp, zero1)
    params, opt_state = local_blocks(params), local_blocks(opt_state)
    params = rebuild(params, {
        n: sh.gather_block(t, lay.spec[n], mesh, "checkpoint")
        for n, t in named_leaves(params)})
    return params, rebuild(opt_state, {
        n: sh.gather_block(t, lay.state[n], mesh, "checkpoint")
        if n in lay.state else t for n, t in named_leaves(opt_state)})


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
    docstring).  On a mesh a batch-1 batch trains sequence sharded over
    the DP group (:func:`seq_batch`; module docstring)."""
    fns = api.model_fns(cfg)
    opt = optimizer or make_optimizer(cfg)
    kernels = make_kernels(backend)
    tpm = _tp_mesh(mesh, cfg)
    lay = None
    if mesh is not None:
        sh.require_groups(mesh, "a train step")
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

    def grads_of(params, batch, weight=None):
        """(loss, gradients), the microbatches' means; ``weight`` scales
        the loss before the backward."""
        fn = loss_of if weight is None else (
            lambda p_, b_: loss_of(p_, b_) * weight)
        if microbatches == 1:
            return value_and_grad(fn, params, batch)
        loss = torch.zeros((), device=leaves(params)[0].device)
        grads = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        for i in range(microbatches):
            mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                               + tuple(v.shape[1:]))[i]
                  for k, v in batch.items()}
            l_i, g_i = value_and_grad(fn, params, mb)
            tree_map(lambda a, b: a.add_(b.float()), grads, g_i)
            loss = loss + l_i
        loss = loss / microbatches
        grads = tree_map(lambda g: g / microbatches, grads)
        return loss, grads

    def train_step(params, opt_state, batch):
        seq = split = pre = False
        if mesh is not None:
            params, opt_state = local_blocks(params), local_blocks(opt_state)
            seq = seq_batch(batch["tokens"].shape, mesh)
            if seq and microbatches != 1:
                raise ValueError("a batch-1 sequence-sharded step takes no "
                                 "microbatches")
            split = seq or _rows_split(batch["tokens"].shape, mesh)
            batch, weight = _dp_shard(batch, mesh, seq, microbatches)
            # the weight enters before the backward where every rank's
            # loss reads every rank's keys and states (seq) or its MoE
            # statistics
            pre = seq or (split and cfg.num_experts > 0)
        with TP.use(tpm, one_rank=True), SEQ.use(mesh if seq else None), \
                TOK.use(mesh if split else None):
            loss, grads = grads_of(params, batch, weight if pre else None)
        if mesh is not None:
            grads, loss = _dp_weigh(grads, loss, 1.0 if pre else weight,
                                    mesh)
        if grad_transform is not None:
            grads = grad_transform(grads)
            if zero1 and getattr(grad_transform, "whole", True):
                grads = _dp_blocks(grads, lay, mesh)
        if lay is None:
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        else:
            grads, gnorm = clip_sharded(grads, max_grad_norm, lay.weight,
                                        lambda t: _mesh_sum(t, mesh))
        if lay is not None and not isinstance(opt, AdamW):
            params, opt_state = opt.update(grads, opt_state, params, lay)
        elif zero1:
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


def seq_batch(shape, mesh) -> bool:
    """Whether a batch whose tokens are ``shape`` [B, S] runs sequence
    sharded over the DP group on ``mesh``: at B = 1 where the group
    divides S (``batch_spec``'s S branch), on a one-rank group included,
    every family and Megatron-SP with it (S split over "data", each
    rank's block over "model").  A length the group does not divide
    stays whole on every rank, as the rule keeps it: the batch then runs
    whole on each, and a prefill's cache is cut to the rules' blocks of
    its time axes (:func:`time_blocks`)."""
    return mesh is not None and shape[0] == 1 \
        and shape[1] % sh.dp_size(mesh) == 0


def time_blocks(cache, mesh):
    """The rank's blocks, over "data", of the time axes of a whole-prompt
    batch-1 prefill cache (``cache_pspec``'s B == 1 branch: a time axis
    "data" divides is split, any other stays whole); the leaves' "model"
    blocks are the prefill's own."""
    from ..tree import named_leaves, rebuild

    def one(name, t):
        spec = sh.cache_pspec(name, tuple(t.shape), mesh)
        blk = sh.local_block(t, sh.Spec(*(e if e == "data" else None
                                          for e in spec)), mesh)
        return t if blk.shape == t.shape else blk.clone()
    return rebuild(cache, {n: one(n, t) for n, t in named_leaves(cache)})


#: the leaves of a batch-1 batch that hold the prompt's sequence; the
#: others (image embeddings, encoder frames) are a cross-attention
#: memory, given whole: the family keeps its rows where the group
#: divides them (``distributed.seq.memory``)
SEQ_LEAVES = ("tokens", "labels")


def _rows_split(shape, mesh) -> bool:
    """Whether the rules split a batch leaf of ``shape`` by its rows."""
    spec = sh.batch_spec(tuple(shape), mesh)
    return bool(spec) and spec[0] is not None


def _dp_shard(batch, mesh, seq: bool = False, microbatches: int = 1):
    """(this rank's block of ``batch`` and its gradient weight n_i·dp /
    N): the rank's rows of each leaf the rules split by rows, its block
    of every one of ``microbatches`` equal row blocks (so its local
    microbatch j is its block of the global microbatch j); with ``seq``
    the rank's block of the sequence (dim 1) of the :data:`SEQ_LEAVES`,
    the memory leaves whole (the family keeps its rows of them)."""
    dp, i = sh.dp_size(mesh), sh.dp_rank(mesh)
    local = dict(batch)
    for k, v in batch.items():
        if seq:
            if k in SEQ_LEAVES:
                local[k] = _seq_block(v, dp, i)
        elif _rows_split(v.shape, mesh):
            mb = v.reshape((microbatches, -1) + tuple(v.shape[1:]))
            n = mb.shape[1] // dp
            local[k] = mb[:, i * n:(i + 1) * n].reshape(
                (-1,) + tuple(v.shape[1:]))
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


# ---------------------------------------------------------------------------
# Serving steps: prefill and decode (the dry-run's cells)
# ---------------------------------------------------------------------------

def _token_input(cfg) -> int:
    """The index of the token matrix among a family's prefill inputs (the
    audio family's come after its frames)."""
    return 1 if cfg.family == "audio" else 0


def make_prefill_step(cfg: ArchConfig, mesh=None, backend: str = "cuda"
                      ) -> Callable:
    """prefill(params, *inputs, max_len=None) → (last logits [B, V],
    cache): the family's prefill on ``inputs`` (``api.prefill_input_specs``'
    order), the ssm and hybrid families' SSD term through ``backend``'s
    kernels.  With ``mesh``: under tensor parallelism on its "model"
    axis, the parameters being the rank's blocks; the inputs are GLOBAL
    and the rank runs its block of them by the rules' ``batch_spec`` —
    its rows of the batch (logits and cache of those rows), or, for a
    batch-1 batch (:func:`seq_batch`), its block of the sequence: the
    logits are then the whole prompt's last and the cache the rank's
    block of its time axis (``cache_pspec``)."""
    fns = api.model_fns(cfg)
    kw = {"kernels": make_kernels(backend)} \
        if cfg.family in ("ssm", "hybrid") else {}
    tpm = _tp_mesh(mesh, cfg)
    if mesh is not None:
        sh.require_groups(mesh, "a prefill step")

    def prefill_step(params, *inputs, max_len=None):
        if mesh is None:
            return fns.prefill(params, cfg, *inputs, max_len=max_len, **kw)
        params = local_blocks(params)
        tok = inputs[_token_input(cfg)]
        seq = seq_batch(tok.shape, mesh)
        dp, i = sh.dp_size(mesh), sh.dp_rank(mesh)
        split = seq or tok.shape[0] % dp == 0
        if seq:     # the memory (image embeddings, frames) stays whole
            t = _token_input(cfg)
            inputs = tuple(_seq_block(x, dp, i) if j == t else x
                           for j, x in enumerate(inputs))
        else:
            inputs = tuple(x if x.shape[0] % dp else
                           x[i * (x.shape[0] // dp):
                             (i + 1) * (x.shape[0] // dp)] for x in inputs)
        with TP.use(tpm, one_rank=True), SEQ.use(mesh if seq else None), \
                TOK.use(mesh if split else None):
            logits, cache = fns.prefill(params, cfg, *inputs,
                                        max_len=max_len, **kw)
        if tok.shape[0] == 1 and not seq:
            cache = time_blocks(cache, mesh)
        return logits, cache
    return prefill_step


def _seq_block(x: torch.Tensor, dp: int, i: int) -> torch.Tensor:
    """Rank ``i``'s block of ``dp`` along a batch-1 input's sequence (a
    length they divide, :func:`seq_batch`)."""
    n = x.shape[1] // dp
    return x[:, i * n:(i + 1) * n]


def make_decode_step(cfg: ArchConfig, mesh=None,
                     global_batch: Optional[int] = None,
                     cache_len: Optional[int] = None) -> Callable:
    """decode(params, token [B], cache, pos [B]) → (logits [B, V], cache):
    one decode step, the cache updated in place.  With ``mesh``: under
    tensor parallelism on its "model" axis, ``cache`` being the rank's
    blocks (``api.shard_cache``): its slots (B over DP, the rank's
    ``token``/``pos`` rows, a block of the step's tokens for the MoE
    family's statistics, ``distributed.tokens``), or at B = 1 its block
    of every time axis over "data" (``cache_pspec``'s B = 1 branch: the
    long-context decode, each rank's rows reduced to flash statistics
    and merged).  ``global_batch`` is the step's whole batch (default:
    a rank with more than one row holds the rules' block of the slots,
    one row is a batch-1 step's); ``cache_len`` the whole time axis of a
    batch-1 cache (default: the rules' blocks): a length "data" does
    not divide is whole on every rank (:func:`time_blocks`), and the
    step then runs the rows whole (:func:`_whole_time`)."""
    fns = api.model_fns(cfg)
    tpm = _tp_mesh(mesh, cfg)
    if mesh is not None:
        sh.require_groups(mesh, "a decode step")

    def decode_step(params, token, cache, pos):
        if mesh is None:
            return fns.decode_step(params, cfg, token, cache, pos)
        if token.shape[0] == 1 and _whole_time(mesh, cache_len):
            with TP.use(tpm, one_rank=True):
                return _with_whole_cross(
                    cfg, mesh, cache, lambda c: fns.decode_step(
                        local_blocks(params), cfg, token, c, pos))
        seq = token.shape[0] == 1 and cfg.family != "ssm"
        # the rank's slots: its block of the step's tokens (the one token
        # of a batch-1 step is every rank's)
        split = token.shape[0] > 1 if global_batch is None else \
            sh.token_sharding(mesh, global_batch)[0] is not None
        with TP.use(tpm, one_rank=True), \
                SEQ.use(mesh if seq else None, "data"), \
                TOK.use(mesh if split else None):
            return fns.decode_step(local_blocks(params), cfg, token, cache,
                                   pos)
    return decode_step


def _whole_time(mesh, cache_len: Optional[int]) -> bool:
    """Whether a batch-1 cache of ``cache_len`` rows is whole on every
    rank (the rules split a time axis over "data" where it divides)."""
    return cache_len is not None \
        and cache_len % sh.axis_size(mesh, "data") != 0


def _with_whole_cross(cfg, mesh, cache, step):
    """``step(cache)`` on a batch-1 cache whose self rows are whole: a
    cross-attention cache whose rows the rules split over "data" (its
    memory's length divisible, ``seq.cached_memory``) is all-gathered
    whole for the step (decode only reads it), and the returned cache
    keeps the rank's block of it."""
    cross = cache.get("cross") if isinstance(cache, dict) else None
    n = cfg.num_image_tokens if cfg.family == "vlm" else \
        cfg.num_audio_frames
    d = sh.axis_size(mesh, "data")
    if cross is None or n % d or d == 1:
        return step(cache)
    group = sh.axis_group(mesh, "data")
    whole = dict(cache, cross={k: sh.gather_dim(v, group, "x" + k + "_whole",
                                                v.dim() - 3)
                               for k, v in cross.items()})
    logits, out = step(whole)
    return logits, dict(out, cross=cross)


def make_dkv_decode_step(cfg: ArchConfig, mesh=None,
                         cache_len: Optional[int] = None) -> Callable:
    """decode(params, token, cache, pos, frozen_len) → (logits, cache):
    one step over a decomposed KV cache (``decomposed_kv.decode_step_dkv``,
    the kernel route), on ``mesh`` as :func:`make_decode_step` (at B = 1
    the rank's block of the prefix rows and of the tail, or, where
    ``cache_len`` is a length "data" does not divide, the whole rows)."""
    from ..models import decomposed_kv as DK
    tpm = _tp_mesh(mesh, cfg)
    if mesh is not None:
        sh.require_groups(mesh, "a decode step")

    def decode_step(params, token, cache, pos, frozen_len):
        seq = mesh is not None and token.shape[0] == 1 \
            and not _whole_time(mesh, cache_len)
        with TP.use(tpm, one_rank=True), \
                SEQ.use(mesh if seq else None, "data"):
            return DK.decode_step_dkv(local_blocks(params), cfg, token,
                                      cache, pos, frozen_len)
    return decode_step


def make_dkv_prefill_step(cfg: ArchConfig, rank: int, tail: int = 128,
                          engine=None, exact: bool = False,
                          mesh=None) -> Callable:
    """prefill(params, tokens) → (logits, decomposed KV cache) through the
    engine's backend (the reference's ``make_dkv_prefill_step``: a thin
    wrapper of ``decomposed_kv.prefill_dkv``).  With ``mesh``: under
    tensor parallelism on its "model" axis (the parameters the rank's
    blocks), the GLOBAL prompt of batch 1 sharded along its sequence
    over the DP group (:func:`seq_batch`): the rank prefills its block,
    the factors come from ``decomposed_kv._decompose_blocks`` and the
    cache is the one :func:`make_dkv_decode_step` decodes on the same
    mesh (U·Σ's and the tail's rows the rank's block, Vᵀ whole).  A
    batch of several prompts runs whole on every rank (the engine
    shards its decomposition batch over DP when its config has the
    mesh)."""
    from ..models import decomposed_kv as DK
    if isinstance(engine, EngineConfig):
        engine = DecomposeEngine(engine)
    engine = engine or DecomposeEngine()
    tpm = _tp_mesh(mesh, cfg)
    if mesh is not None:
        sh.require_groups(mesh, "a prefill step")

    def prefill_step(params, tokens):
        if mesh is None:
            return DK.prefill_dkv(params, cfg, tokens, rank, tail=tail,
                                  exact=exact, engine=engine)
        seq = seq_batch(tokens.shape, mesh)
        if seq:
            tokens = _seq_block(tokens, sh.dp_size(mesh), sh.dp_rank(mesh))
        with TP.use(tpm, one_rank=True), SEQ.use(mesh if seq else None):
            return DK.prefill_dkv(local_blocks(params), cfg, tokens, rank,
                                  tail=tail, exact=exact, engine=engine)
    return prefill_step


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
