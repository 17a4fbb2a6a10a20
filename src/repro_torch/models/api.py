"""Family-agnostic model entry points (serving and training).

Counterpart of ``repro.models.api.ModelFns``/``model_fns``: the one place
that maps a config's family to its functions.  Every family's functions
share one signature:

* ``init(cfg, generator, device=None)`` → params;
* ``prefill(params, cfg, *inputs, max_len=None)`` → (last logits [B, V],
  cache), ``inputs`` being ``prefill_inputs(cfg, tokens, make)``: the
  tokens alone, tokens and image embeddings (vlm), or encoder frames and
  tokens (audio); the ssm family also takes ``kernels=`` (its scan's
  kernel set);
* ``decode_step(params, cfg, token, cache, pos, live=None)`` → (logits
  [B, V], cache), updating the cache in place (a row whose ``live`` is
  False writes nothing);
* ``loss_fn(params, cfg, batch, kernels=None)`` → the scalar training
  loss of a batch dict (``tokens``, ``labels``, and the family's
  ``batch_extras``), each block under ``layers.ckpt``; ``kernels`` is
  the kernel set (``kernels.ops.make_kernels(backend)``) of the families
  whose training path runs a port kernel (ssm, hybrid);
* ``init_cache(cfg, batch, max_len, device=None)`` → the zero cache of
  ``batch`` slots; a leaf's slot axis is where :func:`cache_batch_axes`
  finds it (1 for dense, moe, ssm and audio; the hybrid's grouped Mamba2
  state and the vlm's self K/V have it at 2).

Admission support (every family): :func:`splice_cache` writes fresh
prefill rows into a live cache IN PLACE, and :func:`tree_ready` /
:func:`splice_on_ready` are the non-blocking done-probe and
splice-if-done of the async engine's tickets, over ``torch.cuda.Event``s.

Sizes: :func:`abstract_params` is a config's parameter tree on the
``meta`` device (shapes and dtypes, no memory, nothing drawn), and
:func:`param_count` / :func:`active_param_count` count it with the
reference's conventions.  :func:`decomposed_fns` binds the decomposed
entry points (the activation forward, the decomposed-KV prefill, decode
and fold) to one ``DecomposeEngine``.

Meshes: :func:`cache_shardings` gives the specs of a cache tree
(``distributed.sharding.cache_pspec``), and :class:`SlotShard` is the
slot arithmetic of a slot-sharded serving engine: which of the engine's
slots this rank holds under the rules' batch rule (a contiguous block
of slots / dp when dp divides the slot count, else every slot), the
local index of a global slot, and the all-gather of per-slot results.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, List, NamedTuple, Tuple

import torch

from ..sampling import MASK, fold_in, greedy_sampler, takes_key
from ..tree import tree_map
from . import encdec, hybrid, mamba2, moe, transformer, vlm


def tokens_prefill_inputs(cfg, tokens, make, mem_len=None):
    """Default ``ModelFns.prefill_inputs``: the token matrix is the whole
    prefill input (dense, moe, ssm, hybrid)."""
    return (tokens,)


def no_batch_extras(cfg, b, s, make):
    """Default ``ModelFns.batch_extras``: tokens and labels are the whole
    training batch."""
    return {}


class ModelFns(NamedTuple):
    """One family's functions.  ``prefill_inputs(cfg, tokens, make,
    mem_len=None)`` gives the positional prefill inputs after (params,
    cfg): the tokens, plus the image embeddings (vlm) or the encoder
    frames (audio, first) made by ``make(shape, dtype)`` (zeros, for the
    serving engine's placeholders); ``batch_extras`` names a training
    batch's extra members the same way (the image embeddings or frames
    that ``loss_fn`` reads besides tokens and labels)."""
    init: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable
    loss_fn: Callable
    prefill_inputs: Callable = tokens_prefill_inputs
    batch_extras: Callable = no_batch_extras


def run_decode_block(step: Callable, max_block: int, tok: torch.Tensor,
                     cache, pos: torch.Tensor, n_steps, stop_table,
                     slot_live=None, *, sampler: Callable = greedy_sampler,
                     key=None, round0=0):
    """Up to ``n_steps`` (≤ ``max_block``) sampled decode steps as ONE
    fixed-length loop over device tensors, with no host read inside — the
    form a CUDA graph captures (counterpart of
    ``repro.models.api.run_decode_block``, whose ``while_loop`` exits).

    ``step(tok, cache, pos, live)`` → (logits, cache) is one decode step
    that writes nothing for a row whose ``live`` (bool [B]) is False.
    ``n_steps`` is an int or an int tensor; ``stop_table`` is int32
    [B, W], −1-padded.  ``sampler(logits, 1)`` picks each step's tokens
    on the device (greedy by default); a keyed sampler (``takes_key``)
    gets ``fold_in(key, round0 + i)`` at step i, the key the single-step
    engine derives for that round (``key`` and ``round0`` may be device
    tensors, as a captured graph's feed holds them).  The block
    halts after the first step in which any slot samples one of its stop
    tokens, or after ``n_steps``: every later iteration still runs, but
    with ``live`` all False and ``tok``/``pos`` frozen, so it changes no
    state.

    ``slot_live`` (bool [B], optional) marks the slots that hold a
    request: a dead slot's token and position stay where they were, as
    in the single-step engine, whose dead rows decode token 0 at a fixed
    position every round (the cache writes still follow ``active``, as a
    single step writes every row).  Rows then never see a difference
    between the two engines, which matters where rows interact (the MoE
    capacity: a dead row's token takes a slot in its experts).

    Returns ``(buf int32 [max_block, B], steps int32 [], done bool [B],
    cache)`` as the reference does: rows of ``buf`` at or past ``steps``
    are zero, and ``done`` is the stop mask of the last step taken.
    """
    b, dev = tok.shape[0], tok.device
    n = torch.as_tensor(n_steps, device=dev)
    keyed = takes_key(sampler)
    if keyed:
        key = torch.as_tensor(key, device=dev).long() & MASK
        round0 = torch.as_tensor(round0, device=dev).long()
    buf = torch.zeros(max_block, b, dtype=torch.int32, device=dev)
    steps = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    halted = torch.zeros((), dtype=torch.bool, device=dev)
    for i in range(max_block):
        active = ~halted & (n > i)                       # bool []
        logits, cache = step(tok, cache, pos, active.expand(b))
        adv = active if slot_live is None else active & slot_live
        nxt = (sampler(logits, 1, fold_in(key, round0 + i)) if keyed
               else sampler(logits, 1)).to(torch.int32)
        buf[i] = torch.where(adv, nxt, 0)
        hit = (nxt[:, None] == stop_table).any(dim=1)
        done = torch.where(active, hit, done)
        halted = halted | (active & hit.any())
        steps = steps + active.to(torch.int32)
        tok = torch.where(adv, nxt.to(tok.dtype), tok)
        pos = pos + adv.to(pos.dtype)
    return buf, steps, done, cache


_FAMILY = {
    "dense": ModelFns(transformer.init, transformer.prefill,
                      transformer.decode_step, transformer.init_cache,
                      transformer.loss_fn),
    "ssm": ModelFns(mamba2.init, mamba2.prefill, mamba2.decode_step,
                    mamba2.init_state, mamba2.loss_fn),
    "moe": ModelFns(moe.init, moe.prefill, moe.decode_step, moe.init_cache,
                    moe.loss_fn),
    "hybrid": ModelFns(hybrid.init, hybrid.prefill, hybrid.decode_step,
                       hybrid.init_state, hybrid.loss_fn),
    "vlm": ModelFns(vlm.init, vlm.prefill, vlm.decode_step, vlm.init_cache,
                    vlm.loss_fn, vlm.prefill_inputs, vlm.batch_extras),
    "audio": ModelFns(encdec.init, encdec.prefill, encdec.decode_step,
                      encdec.init_cache, encdec.loss_fn,
                      encdec.prefill_inputs, encdec.batch_extras),
}


def model_fns(cfg) -> ModelFns:
    try:
        return _FAMILY[cfg.family]
    except KeyError:
        raise ValueError(f"family {cfg.family!r} is not ported; ported: "
                         f"{sorted(_FAMILY)}") from None


# ---------------------------------------------------------------------------
# Cache splicing and the done-probe (admission support, every family)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def cache_batch_axes(cfg):
    """Tree (matching ``init_cache``'s) of each leaf's slot axis, found by
    building the cache at two batch sizes on the ``meta`` device (no
    memory, no per-family table to drift when a family adds a leaf)."""
    fns = model_fns(cfg)
    a = fns.init_cache(cfg, 2, 8, device="meta")
    b = fns.init_cache(cfg, 5, 8, device="meta")

    def axis(x, y):
        d = [i for i, (m, n) in enumerate(zip(x.shape, y.shape)) if m != n]
        assert len(d) == 1, f"ambiguous batch axis for leaf {tuple(x.shape)}"
        return d[0]

    return tree_map(axis, a, b)


def splice_cache(cfg, old, new, slot_indices, src_indices=None):
    """Write batch rows ``src_indices`` (default ``0…n−1``) of ``new``
    into ``old`` at ``slot_indices`` along each leaf's slot axis, IN
    PLACE, so that buffers a captured graph reads keep their address.
    ``new`` may carry more rows than ``len(slot_indices)`` (bucketed
    prefill padding); the excess is dropped.  Returns ``old``."""
    axes = cache_batch_axes(cfg)

    def one(o, nw, ax):
        idx = torch.as_tensor(slot_indices, device=o.device).long()
        src = torch.arange(idx.numel(), device=o.device) \
            if src_indices is None else \
            torch.as_tensor(src_indices, device=o.device).long()
        o.movedim(ax, 0)[idx] = nw.movedim(ax, 0)[src].to(o.dtype)
        return o

    tree_map(one, old, new, axes)
    return old


# ---------------------------------------------------------------------------
# Abstract parameters and parameter counts
# ---------------------------------------------------------------------------

def abstract_params(cfg):
    """The family's parameter tree on the ``meta`` device: the shapes and
    dtypes of ``init``, with no memory allocated and nothing drawn."""
    return model_fns(cfg).init(cfg, None, device="meta")


def param_count(cfg) -> int:
    """Elements of every parameter leaf (the padded vocab rows
    included, as in the reference)."""
    return sum(math.prod(t.shape) for t in tree_leaves(abstract_params(cfg)))


def active_param_count(cfg) -> int:
    """Matmul-active parameters per token, the N of the 6·N·D model-FLOPs
    convention: a MoE layer counts top_k of its num_experts; the input
    embedding is left out when untied (a gather, no FLOPs) and kept once
    when tied (it is the head)."""
    total = param_count(cfg)
    if not cfg.tie_embeddings:
        total -= cfg.padded_vocab * cfg.d_model
    if not cfg.num_experts:
        return total
    n_moe_layers = cfg.num_layers - cfg.first_k_dense
    expert_params = 3 * cfg.d_model * cfg.moe_d_ff
    return total - n_moe_layers * (cfg.num_experts - cfg.top_k) \
        * expert_params


# ---------------------------------------------------------------------------
# Decomposed execution bound to one engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecomposedFns:
    """The decomposed entry points, bound to ONE ``DecomposeEngine``:
    ``forward``/``logit_kl`` run the policy's decomposed blocks;
    ``prefill_dkv``/``decode_step_dkv``/``compress_tail``/``splice_dkv``
    are the decomposed-KV serving path.  Made by :func:`decomposed_fns`."""
    engine: Any
    forward: Callable               # (params, tokens) -> logits
    logit_kl: Callable              # (params, tokens) -> scalar
    prefill_dkv: Callable           # (params, tokens[, rank, ...])
                                    # -> (logits, cache)
    decode_step_dkv: Callable       # (params, token, cache, pos, frozen_len)
    compress_tail: Callable         # (cache[, rank, frozen_len, fold,
                                    #  new_frozen]) -> cache
    splice_dkv: Callable = None     # (live, fresh, slot_indices) -> cache


def decomposed_fns(cfg, engine, mesh=None) -> DecomposedFns:
    """Bind the decomposed entry points of the dense family to
    ``engine``, the one source of ranks, policy and kernels: a rank or
    tail left None is the engine config's ``kv_rank``/``kv_tail``.
    ``forward`` and ``logit_kl`` run on ``mesh`` as
    ``runtime.steps.make_decomposed_forward_step`` /
    ``make_decomposed_quality_step`` do (the rank's parameter blocks,
    the GLOBAL tokens).
    ``decode_step_dkv``'s ``frozen_len`` may be an int (every slot) or
    int32 [B]; ``compress_tail`` with no ``frozen_len`` folds every
    slot's tail at the prefix's end (the reference's uniform mode)."""
    # a guard that raises, not a second dispatch table
    if cfg.family != "dense":  # dcomlint: disable=F1
        raise ValueError(f"decomposed execution runs the dense family, not "
                         f"{cfg.family!r}")
    from . import decomposed as D
    from . import decomposed_kv as DK

    def need_policy():
        if engine.config.policy is None:
            raise ValueError("the engine has no decomposition policy")

    def forward(params, tokens, wfactors=None):
        need_policy()
        from ..runtime import steps
        return steps.make_decomposed_forward_step(cfg, engine, mesh)(
            params, tokens, wfactors)

    def logit_kl(params, tokens, wfactors=None):
        need_policy()
        from ..runtime import steps
        return steps.make_decomposed_quality_step(cfg, engine, mesh)(
            params, tokens, wfactors)

    def prefill_dkv(params, tokens, rank=None, tail=None, exact=False):
        return DK.prefill_dkv(
            params, cfg, tokens,
            engine.config.kv_rank if rank is None else rank,
            tail=engine.config.kv_tail if tail is None else tail,
            exact=exact, engine=engine)

    def decode_step_dkv(params, token, cache, pos, frozen_len):
        fl = torch.as_tensor(frozen_len, dtype=torch.int32,
                             device=token.device).expand(token.shape[0])
        return DK.decode_step_dkv(params, cfg, token, cache, pos, fl)

    def compress_tail(cache, rank=None, frozen_len=None, fold=None,
                      new_frozen=None):
        b, tl = cache["tail"]["k"].shape[1:3]
        t = cache["k_u"].shape[2]
        dev = cache["k_u"].device
        if frozen_len is None:
            frozen_len = torch.full((b,), t, dtype=torch.int32, device=dev)
        if fold is None:
            fold = torch.ones(b, dtype=torch.bool, device=dev)
        if new_frozen is None:
            new_frozen = torch.full((b,), t + tl, dtype=torch.int32,
                                    device=dev)
        return DK.compress_tail(
            cache, cfg, engine.config.kv_rank if rank is None else rank,
            frozen_len, fold, new_frozen)

    return DecomposedFns(engine, forward, logit_kl, prefill_dkv,
                         decode_step_dkv, compress_tail, DK.splice_dkv)


# ---------------------------------------------------------------------------
# Input specs: shape stand-ins per workload kind (the dry-run's pattern)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` with no memory behind it."""
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg, shape) -> dict:
    """The training batch of a ``ShapeSpec`` (``global_batch`` sequences of
    ``seq_len`` tokens) as ``meta`` tensors: int32 ``tokens`` and
    ``labels``, and the family's ``batch_extras``."""
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": _meta((b, s), torch.int32),
             "labels": _meta((b, s), torch.int32)}
    specs.update(model_fns(cfg).batch_extras(cfg, b, s, _meta))
    return specs


def prefill_input_specs(cfg, shape) -> tuple:
    """The positional inputs of the family's ``prefill`` after (params,
    cfg), as ``meta`` tensors (an audio prefill's memory is ``seq_len``
    frames, as the reference's dry-run sizes it)."""
    b, s = shape.global_batch, shape.seq_len
    return model_fns(cfg).prefill_inputs(cfg, _meta((b, s), torch.int32),
                                         _meta, mem_len=s)


def decode_input_specs(cfg, shape) -> tuple:
    """(token, cache, pos) of the family's ``decode_step`` as ``meta``
    tensors: int32 [B] tokens and positions, the cache of ``seq_len``
    rows."""
    b, s = shape.global_batch, shape.seq_len
    cache = model_fns(cfg).init_cache(cfg, b, s, device="meta")
    return _meta((b,), torch.int32), cache, _meta((b,), torch.int32)


def make_fake_batch(cfg, shape, generator=None, device=None) -> dict:
    """A concrete synthetic batch of :func:`train_batch_specs`' shapes and
    dtypes: token ids uniform in [0, vocab), floats N(0, 1) in their
    dtype, drawn from ``generator`` (default: seeded 0) in sorted name
    order."""
    gen = generator or torch.Generator().manual_seed(0)
    out = {}
    for name, sp in sorted(train_batch_specs(cfg, shape).items()):
        if sp.dtype.is_floating_point:
            t = torch.randn(tuple(sp.shape), generator=gen).to(sp.dtype)
        else:
            t = torch.randint(0, cfg.vocab, tuple(sp.shape), generator=gen,
                              dtype=sp.dtype)
        out[name] = t.to(device) if device is not None else t
    return out


def shard_cache(cfg, cache, mesh, seq_shard: bool = True):
    """This rank's blocks of a whole decode cache under the rules'
    :func:`cache_shardings` (``seq_shard``: a batch-1 cache's time axes
    over "data"), each a copy of its own where it is part of the leaf."""
    from ..distributed import sharding as sh
    from ..tree import named_leaves, rebuild

    def one(name, t):
        b = sh.local_block(t, sh.cache_pspec(name, tuple(t.shape), mesh,
                                             seq_shard), mesh)
        return t if b.shape == t.shape else b.clone()
    return rebuild(cache, {n: one(n, t) for n, t in named_leaves(cache)})


def shard_params(cfg, params, mesh):
    """This rank's ``params_sharding`` blocks of a whole parameter tree of
    ``cfg``'s family, for tensor parallelism on ``mesh``'s "model" axis
    (every family runs it: dense, decomposed KV, moe, ssm, hybrid, vlm
    and audio).  Under ``distributed.tp.use(mesh)`` the family's
    ``init_cache`` then builds the rank's cache blocks
    (:func:`cache_shardings`' blocks)."""
    from ..distributed import sharding as sh
    return sh.shard_params(params, mesh, cfg)


def cache_shardings(cfg, cache, mesh, seq_shard: bool = True):
    """The :class:`~repro_torch.distributed.sharding.Spec` of every leaf
    of a decode cache on ``mesh`` (a serving engine's caches use
    ``seq_shard=False``: slot-axis DP only)."""
    from ..distributed import sharding as sh
    return sh.cache_sharding(cache, mesh, cfg, seq_shard=seq_shard)


class SlotShard:
    """The slots of an engine of ``slots`` that this rank holds on
    ``mesh``.  The rules shard a cache's slot axis over the DP super-axis
    when dp divides it and it is > 1 (``cache_pspec``): rank i of the DP
    group then holds the contiguous block ``[i·n, (i+1)·n)``, n =
    slots / dp; otherwise (or with no mesh) every rank holds every slot.
    ``sharded`` says whether per-slot results must be gathered: True on
    a mesh whose rule shards the slots, even at one rank (a one-rank
    all-gather is a copy)."""

    def __init__(self, slots: int, mesh=None):
        self.slots = slots
        self.dp = 1
        self.sharded = False
        self.first, self.n = 0, slots
        self.group = None                # the DP group, when sharded
        if mesh is not None:
            import torch.distributed as dist
            from ..distributed import sharding as sh
            self.dp = sh.dp_size(mesh)
            self.sharded = slots % self.dp == 0 and slots > 1
            if self.sharded:
                self.group = sh.dp_group(mesh)
                self.n = slots // self.dp
                self.first = dist.get_rank(self.group) * self.n

    def __repr__(self) -> str:
        return (f"SlotShard(slots={self.slots}, first={self.first}, "
                f"n={self.n}, dp={self.dp}, sharded={self.sharded})")

    def owns(self, slot: int) -> bool:
        return self.first <= slot < self.first + self.n

    def take(self, arr):
        """The rows of the held slots of a per-slot host array or list
        (the array itself when every slot is held)."""
        if self.n == self.slots:
            return arr
        return arr[self.first:self.first + self.n]

    def pairs(self, slots_idx) -> Tuple[List[int], List[int]]:
        """(local slot indices, positions j in ``slots_idx``) of the held
        slots among ``slots_idx``."""
        loc, src = [], []
        for j, s in enumerate(slots_idx):
            if self.owns(int(s)):
                loc.append(int(s) - self.first)
                src.append(j)
        return loc, src

    def take_cache(self, cfg, cache, axis=None):
        """The held slots' rows of a whole-slot cache: every leaf along
        its slot axis (the family's ``cache_batch_axes``, or ``axis``
        for every leaf)."""
        if self.n == self.slots:
            return cache
        axes = cache_batch_axes(cfg) if axis is None \
            else tree_map(lambda _: axis, cache)
        return tree_map(lambda x, ax: x.narrow(ax, self.first, self.n)
                        .contiguous(), cache, axes)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` concatenated along dim 0 in rank (slot)
        order, by one all-gather over the DP group; ``t`` itself when the
        slots are not sharded."""
        if not self.sharded:
            return t
        from ..distributed import sharding as sh
        out = t.new_empty((t.shape[0] * self.dp,) + tuple(t.shape[1:]))
        sh.all_gather_into(out, t.contiguous(), self.group, "tokens")
        return out


def tree_leaves(tree):
    """The leaves of nested dicts, lists and tuples (None skipped)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    elif tree is not None:
        yield tree


def tree_ready(tree) -> bool:
    """Non-blocking done-probe over a tree whose leaves may be
    ``torch.cuda.Event``s: True when every event has completed
    (``Event.query()``, which never blocks).  Leaves without ``query``
    (tensors, numpy arrays, scalars) count as ready: on the host a
    prefill has finished when its call returns."""
    return all(leaf.query() for leaf in tree_leaves(tree)
               if isinstance(leaf, torch.cuda.Event))


def splice_on_ready(cfg, old, new, slot_indices, src_indices=None,
                    event=None):
    """Splice-if-done: when ``event`` (the prefill's, on its side stream)
    has completed, the current stream waits on it (a no-op on the
    device, but it orders the reads) and :func:`splice_cache` runs;
    otherwise returns None — "not yet, keep decoding" — without
    blocking."""
    if not tree_ready(event):
        return None
    if event is not None:
        torch.cuda.current_stream().wait_event(event)
    return splice_cache(cfg, old, new, slot_indices, src_indices)
