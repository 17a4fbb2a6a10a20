"""Shared building blocks of the dense transformer (plain functions).

Counterpart of ``repro.models.layers``.  Parameters are nested dicts of
tensors in the JAX layout (weights ``[in, out]``, layers stacked on a
leading L axis); activations are [B, S, H], attention internals
[B, S, n, d].  Matmuls take the storage dtype (bf16) and accumulate in
float32; attention scores, softmax and normalization run in float32, as
the JAX code asks with ``preferred_element_type``.

:func:`mlp`, :func:`decode_attention`, :func:`qkv`, :func:`cross_attention`
and :func:`memory_kv` have one body for one device and for tensor
parallelism (``distributed.tp.use(mesh)``,
where the parameters are the rank's blocks of ``params_sharding``):
Megatron's layout, column-parallel Q/K/V, up and gate, their input
through ``tp.copy``; row-parallel O and down, their output through
``tp.reduce`` before the (replicated) bias (with ``sp``, Megatron-SP:
``tp.sp_in``'s all-gather and ``tp.sp_out``'s reduce-scatter along the
sequence).  :func:`decode_attention` over a batch-1 cache whose time
axis is sharded over the DP group (``distributed.seq``) merges the
ranks' flash statistics.  Head counts come from the
rank's layout (``tp.layout``: every head on one device).  Without a
"model" axis the ``tp`` helpers are the identity, so the body is the
single-device computation.
"""
from __future__ import annotations

import functools
import threading
from typing import Any, Dict, List

import torch

from ..distributed import seq as SEQ
from ..distributed import tp as TP
from ..tree import tree_map

Params = Dict[str, Any]

# Query-chunk length of prefill attention (bounds the [qc, T] score block).
ATTN_CHUNK = 512


def silu(x: torch.Tensor) -> torch.Tensor:
    """x·σ(x) with σ(x) = 1 / (1 + e^−x) evaluated op by op in x's dtype:
    how XLA expands ``jax.nn.silu``'s logistic, so bf16 rounds where the
    reference rounds (``F.silu`` rounds once and flips greedy tokens)."""
    return x * (1 / (1 + torch.exp(-x)))


def _const(v: float, like: torch.Tensor) -> float:
    """``v`` rounded to ``like``'s dtype, as JAX rounds a weakly typed
    Python constant before the op (a torch op would carry it at float32
    and round once)."""
    return float(torch.tensor(v, dtype=like.dtype))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of GELU, x·½(1 + tanh(√(2/π)(x + 0.044715
    x³))), op by op in x's dtype with the constants rounded to it: how
    XLA evaluates ``jax.nn.gelu(approximate=True)``, bit for bit in bf16
    (``F.gelu(approximate="tanh")`` rounds once)."""
    inner = _const((2 / 3.141592653589793) ** 0.5, x) * (
        x + _const(0.044715, x) * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


_ACT = {"silu": silu, "gelu": gelu, "geglu": gelu}


def layer_params(layers: Params, i: int) -> Params:
    """Layer ``i`` of a tree stacked on a leading L axis (views)."""
    if isinstance(layers, dict):
        return {k: layer_params(v, i) for k, v in layers.items()}
    return layers[i]


def unstack(layers: Params, n: int) -> List[Params]:
    """The ``n`` layers of a tree stacked on a leading axis, through ONE
    ``torch.unbind`` per leaf.  For training: the backward of an unbind
    stacks every layer's gradient into one tensor, where ``n`` separate
    :func:`layer_params` views would each add a zero-filled copy of the
    whole stacked leaf."""
    if isinstance(layers, dict):
        per = {k: unstack(v, n) for k, v in layers.items()}
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return list(torch.unbind(layers, 0))


def unstack2(layers: Params, groups: int, per: int) -> List[List[Params]]:
    """:func:`unstack` of a tree stacked on two leading axes [groups,
    per, …]: ``groups`` lists of ``per`` layers."""
    flat = unstack(tree_map(
        lambda t: t.reshape((groups * per,) + tuple(t.shape[2:])), layers),
        groups * per)
    return [flat[g * per:(g + 1) * per] for g in range(groups)]


_SAVED_BY_DOTS = frozenset({torch.ops.aten.mm.default,
                            torch.ops.aten.bmm.default,
                            torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing's "dots" policy: keep the outputs of the
    matrix products (``mm``, ``bmm``, ``addmm``), recompute the rest —
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``'s
    counterpart."""
    from torch.utils.checkpoint import CheckpointPolicy
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


_WARMED: set = set()


def _warm_checkpoint(device) -> None:
    """Run ``torch.utils.checkpoint`` ("full" and "dots") once on a tiny
    tensor of ``device`` in a thread of its own.  Its first call imports
    and registers lazily (``torch._dynamo`` among others), and that
    leaves garbage cycles holding the frames on the stack: on the
    training thread they would keep the caller's tensors (a train step's
    parameters and optimizer state) alive until the next garbage
    collection.  On a fresh thread they hold nothing but this warm-up."""
    from torch.utils.checkpoint import (
        checkpoint, create_selective_checkpoint_contexts)
    failed = []

    def run():
        try:
            a = torch.ones(2, 2, device=device, requires_grad=True)
            dots = functools.partial(create_selective_checkpoint_contexts,
                                     _dots_policy)
            for kw in ({}, {"context_fn": dots}):
                out = checkpoint(lambda t: torch.relu(t @ t), a,
                                 use_reentrant=False, **kw)
                out.sum().backward()
        except BaseException as e:           # raised on the caller's thread
            failed.append(e)
    t = threading.Thread(target=run, name="repro-ckpt-warmup")
    t.start()
    t.join()
    if failed:
        raise failed[0]


def ckpt(fn, cfg):
    """``fn`` under activation checkpointing as ``cfg.remat`` and
    ``cfg.remat_policy`` ask (counterpart of the reference's ``ckpt``):
    ``fn`` itself when remat is off; else each call goes through
    ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, which
    keeps the block's inputs and recomputes its forward in the backward
    ("full"), or keeps the matmul outputs too ("dots": selective
    checkpointing).  Non-tensor arguments (the config) pass through."""
    if not cfg.remat:
        return fn
    from torch.utils.checkpoint import (
        checkpoint, create_selective_checkpoint_contexts)
    if cfg.remat_policy == "full":
        context_fn = None
    elif cfg.remat_policy == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _dots_policy)
    else:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; "
                         f"one of ('full', 'dots')")

    @functools.wraps(fn)
    def body(*args):
        dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
                   None)
        if dev not in _WARMED:
            _warm_checkpoint(dev)
            _WARMED.add(dev)
        kw = {} if context_fn is None else {"context_fn": context_fn}
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return body


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """Mean next-token cross-entropy in float32 (counterpart of the
    reference's ``cross_entropy``): logsumexp over the vocab, the label
    logit picked by a masked sum (not a gather), positions whose label is
    ``ignore_id`` masked out, the mean over the rest."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    iota = torch.arange(lg.shape[-1], device=lg.device)
    ll = torch.where(iota == labels[..., None], lg,
                     torch.zeros((), device=lg.device)).sum(dim=-1)
    nll = lse - ll
    mask = (labels != ignore_id).float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def row_dense(p: Params, x: torch.Tensor, sharded: bool,
              sp: int = 0) -> torch.Tensor:
    """A row-parallel product: the rank's partial sum all-reduced over
    "model" when the weight's rows are sharded (with ``sp``
    reduce-scattered along the sequence), then the bias.  Under SP a
    replicated weight's product ran on the whole sequence
    (:func:`mlp`, :func:`qkv`): the rank keeps its rows of it."""
    y = x @ p["w"]
    if sharded:
        y = TP.sp_out(y, sp)
    elif sp:
        y = TP.sp_split(y, sp)
    if "b" in p:
        y = y + TP.sp_rep(p["b"], sp)
    return y


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """(x − μ)/√(σ² + eps)·scale (+ bias) in float32, σ² the BIASED
    variance (``jnp.var``; ``torch.var`` defaults to the unbiased one)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps) * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [..., S, n, d]; positions [..., S].  Rotates INTERLEAVED pairs
    (x[..., 0::2], x[..., 1::2]), as the JAX package does — not the
    rotate-half layout of HF checkpoints."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)
    ang = positions.float()[..., None] * freqs            # [..., S, d/2]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x32 = x.float()
    x1, x2 = x32[..., 0::2], x32[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, x.shape[-1] // n))


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [B,S,nh,d], k [B,T,kvh,d] → scores [B,nh,S,T] float32."""
    b, s, nh, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, nh // kvh, d)
    sc = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    return sc.reshape(b, nh, s, k.shape[1])


def _gqa_pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p [B,nh,S,T], v [B,T,kvh,d] → out [B,S,nh,d] float32."""
    b, nh, s, t = p.shape
    kvh = v.shape[2]
    pg = p.reshape(b, kvh, nh // kvh, s, t)
    out = torch.einsum("bkgst,btkd->bskgd", pg.float(), v.float())
    return out.reshape(b, s, nh, v.shape[-1])


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           positions: torch.Tensor, *, causal: bool = True,
           out_dtype=None, k_positions=None) -> torch.Tensor:
    """Softmax attention q [B,S,nh,d] over k/v [B,T,kvh,d] in query chunks
    of ``ATTN_CHUNK``; plain matmul + softmax.  Returns [B, S, nh·d].
    The causal mask compares ``positions`` (the queries') with
    ``k_positions`` (the keys', by default the same)."""
    b, s, nh, hd = q.shape
    out_dtype = out_dtype or q.dtype
    scale = hd ** -0.5
    kpos = positions if k_positions is None else k_positions
    qc = min(ATTN_CHUNK, s)
    if s % qc != 0:
        qc = s
    outs = []
    for q0 in range(0, s, qc):
        sc = _gqa_scores(q[:, q0:q0 + qc], k) * scale        # [B,nh,qc,T]
        if causal:
            mask = positions[:, q0:q0 + qc, None] >= kpos[:, None, :]
            sc = torch.where(mask[:, None], sc, torch.full_like(sc, -1e30))
        pr = torch.softmax(sc, dim=-1).to(v.dtype)
        outs.append(_gqa_pv(pr, v).to(out_dtype))
    return torch.cat(outs, dim=1).reshape(b, s, nh * hd)


def write_rows(buf: torch.Tensor, index, new: torch.Tensor,
               live=None) -> None:
    """``buf[index] = new`` IN PLACE, where ``index`` picks one row per
    slot (new [B, ...]); a slot whose ``live`` (bool [B]) is False keeps
    its old row — the halted steps of a fused decode block write
    nothing."""
    new = new.to(buf.dtype)
    if live is not None:
        keep = live.reshape((-1,) + (1,) * (new.dim() - 1))
        new = torch.where(keep, new, buf[index])
    buf[index] = new


def decode_attention(p: Params, x: torch.Tensor, cache: Params,
                     pos: torch.Tensor, cfg, live=None) -> torch.Tensor:
    """One-token attention: x [B, 1, H], cache k/v [B, T, kvh, d], pos [B].
    Writes the new K/V row of each slot into ``cache`` IN PLACE, at row
    ``pos`` clamped into the cache (as JAX's ``dynamic_update_slice``
    clamps); a slot whose ``live`` (bool [B]) is False writes nothing.
    Under tensor parallelism: the rank's heads, and ``cache`` holds the
    rank's block of k/v (``cache_pspec``: kv heads, else head_dim).  Over
    a batch-1 cache whose time axis is sharded over the DP group
    (``distributed.seq``): ``cache`` holds the rank's block of rows, the
    rank that owns row ``pos`` writes it, and the softmax merges the
    ranks' flash statistics (``seq.merge_softmax``, the row's own
    softmax without a group)."""
    b, t_l = x.shape[0], cache["k"].shape[1]
    hd = cfg.resolved_head_dim
    q, k_new, v_new, lay = qkv(p, x, cfg, pos[:, None])       # [B,1,nh,d]
    rows = torch.arange(b, device=x.device)
    local, keep = SEQ.owner_rows(pos, t_l, live)
    write_rows(cache["k"], (rows, local), TP.cache_block(k_new, lay)[:, 0],
               keep)
    write_rows(cache["v"], (rows, local), TP.cache_block(v_new, lay)[:, 0],
               keep)
    k = TP.compute_heads(cache["k"], lay, "k_cache")
    v = TP.compute_heads(cache["v"], lay, "v_cache")
    kvh = k.shape[2]
    g = q.shape[2] // kvh
    qg = q[:, 0].reshape(b, kvh, g, hd).float()
    sc = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * (hd ** -0.5)
    t_glob = SEQ.offset(t_l) + torch.arange(t_l, device=x.device)
    out = SEQ.merge_softmax(sc, t_glob[None, :] <= pos[:, None], v)
    return o_proj(p, out.to(x.dtype).reshape(b, 1, q.shape[2] * hd), cfg)


def qkv(p: Params, h: torch.Tensor, cfg, positions: torch.Tensor,
        sp: int = 0):
    """Q/K/V of one block → (q [B, S, nh_l, d] on the rank's query heads,
    k and v [B, S, kvh_c, d] RoPE'd, the rank's ``tp.layout``):
    ``kvh_c`` is the rank's kv heads when the layout is ``aligned`` (on
    one device: every head), else every kv head (the projection's
    columns all-gathered over "model", or computed whole where the rule
    replicates them).  Under a head split q is the heads the rank's
    column block touches (``tp.q_heads``: the blocks all-gathered).
    With ``sp`` (Megatron-SP) ``h`` is the rank's block of the sequence,
    gathered whole here (where the rule replicates ``wq``, or ``wk`` and
    ``wv``, by ``tp.sp_whole``: that product then runs alike on every
    rank)."""
    lay = TP.layout(cfg)
    hd = cfg.resolved_head_dim
    sharded = o_sharded(cfg)
    hc = TP.sp_in(h, sp) if sharded else TP.sp_whole(h, sp)
    q = split_heads(TP.q_heads(dense(p["wq"], hc), lay), lay.nh_l)
    if sharded and not lay.kv_sharded:
        # wk/wv replicated, read by the rank's heads only: each rank's
        # gradient of K/V is a partial sum, summed over "model" here (the
        # input is h whole, not hc: K/V's share of h's gradient is then
        # whole)
        hw = TP.sp_whole(h, sp)
        k = TP.copy(dense(p["wk"], hw), "kv_in")
        v = TP.copy(dense(p["wv"], hw), "kv_in")
    else:
        k = TP.full_kv(dense(p["wk"], hc), lay, "k_cols")
        v = TP.full_kv(dense(p["wv"], hc), lay, "v_cols")
    k, v = split_heads(k, k.shape[-1] // hd), split_heads(v, v.shape[-1] // hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v, lay


def o_sharded(cfg) -> bool:
    """Whether O's rows (the heads' dims) are sharded over "model"."""
    return TP.width_sharded(cfg.num_heads * cfg.resolved_head_dim)


def o_proj(p: Params, x: torch.Tensor, cfg, sp: int = 0
           ) -> torch.Tensor:
    """The attention's output projection ``p["wo"]`` of the rank's query
    heads' output: row-parallel under tensor parallelism (under a head
    split, on the rank's row block of the touched heads' columns)."""
    return row_dense(p["wo"], TP.o_cols(x, TP.layout(cfg)), o_sharded(cfg),
                     sp)


def cross_attention(p: Params, x: torch.Tensor, kv, cfg,
                    cached: bool = False, split: bool = False
                    ) -> torch.Tensor:
    """Attention of x [B, S, H] over memory K/V (no RoPE, no mask),
    through the query-chunked :func:`attend`.  ``kv`` is
    :func:`memory_kv`'s (k, v), or with ``cached`` the cross cache's
    (its rule block under tensor parallelism).  Megatron's layout as in
    :func:`qkv`: the rank's query heads, the kv heads they read, ``wo``
    row-parallel.  With ``split`` (decode: one query row over a batch-1
    cross cache whose rows are the rank's block over "data",
    ``seq.cached_memory``) the rank's scores reduce to flash statistics
    merged over the group (``seq.merge_softmax``), as self-attention's
    do."""
    b, s, _ = x.shape
    lay = TP.layout(cfg)
    xc = TP.copy(x) if o_sharded(cfg) else x
    q = split_heads(TP.q_heads(dense(p["wq"], xc), lay), lay.nh_l)
    if cached:
        k, v = (TP.compute_heads(kv[0], lay, "xk_cache"),
                TP.compute_heads(kv[1], lay, "xv_cache"))
    else:
        k, v = TP.my_heads(kv[0], lay), TP.my_heads(kv[1], lay)
    if split:
        hd = q.shape[-1]
        kvh = k.shape[2]
        qg = q[:, 0].reshape(b, kvh, q.shape[2] // kvh, hd).float()
        sc = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * (hd ** -0.5)
        valid = torch.ones(b, k.shape[1], dtype=torch.bool, device=x.device)
        out = SEQ.merge_softmax(sc, valid, v, "xattn").to(x.dtype).reshape(
            b, 1, q.shape[2] * hd)
        return o_proj(p, out, cfg)
    positions = torch.arange(s, device=x.device).expand(b, s)
    out = attend(q, k, v, positions, causal=False, out_dtype=x.dtype)
    return o_proj(p, out, cfg)


def memory_kv(p: Params, memory: torch.Tensor, cfg):
    """The K/V of ``memory`` [B, M, H] (encoder output or image
    embeddings) under the block's projections → ([B, M, kvh_c, d], same):
    as :func:`qkv`'s K/V, the rank's kv heads when the layout is
    ``aligned`` (on one device: every head), else every kv head.
    :func:`cross_cache` cuts the cache's block from them."""
    lay = TP.layout(cfg)
    hd = cfg.resolved_head_dim
    sharded = o_sharded(cfg)
    if sharded and not lay.kv_sharded:
        # replicated projections read by the rank's heads only: their
        # gradient is summed over "model" (see qkv)
        k = TP.copy(dense(p["wk"], memory), "kv_in")
        v = TP.copy(dense(p["wv"], memory), "kv_in")
    else:
        mc = TP.copy(memory) if sharded else memory
        k = TP.full_kv(dense(p["wk"], mc), lay, "xk_cols")
        v = TP.full_kv(dense(p["wv"], mc), lay, "xv_cols")
    return split_heads(k, k.shape[-1] // hd), split_heads(v, v.shape[-1] // hd)


def cross_cache(kv, cfg):
    """The cross cache's rows (the rule's block under tensor
    parallelism) of :func:`memory_kv`'s (k, v)."""
    lay = TP.layout(cfg)
    return TP.cache_block(kv[0], lay), TP.cache_block(kv[1], lay)


def mlp(p: Params, x: torch.Tensor, activation: str,
        d_ff: int = None, sp: int = 0) -> torch.Tensor:
    """down(act(gate(x)) · up(x)) when the MLP is gated, else
    down(act(up(x))).  Under tensor parallelism ``d_ff`` is the whole
    hidden width: the rule shards it over "model" when M divides it.
    With ``sp`` (Megatron-SP) ``x`` and the output are the rank's block
    of the sequence (a replicated hidden width runs on the whole
    sequence, ``tp.sp_whole``)."""
    act = _ACT[activation]
    sharded = d_ff is not None and TP.width_sharded(d_ff)
    x = TP.sp_in(x, sp) if sharded else TP.sp_whole(x, sp)
    if "gate" in p:
        h = act(dense(p["gate"], x)) * dense(p["up"], x)
    else:
        h = act(dense(p["up"], x))
    return row_dense(p["down"], h, sharded, sp)
