"""Shared building blocks of the dense transformer (plain functions).

Counterpart of ``repro.models.layers``.  Parameters are nested dicts of
tensors in the JAX layout (weights ``[in, out]``, layers stacked on a
leading L axis); activations are [B, S, H], attention internals
[B, S, n, d].  Matmuls take the storage dtype (bf16) and accumulate in
float32; attention scores, softmax and normalization run in float32, as
the JAX code asks with ``preferred_element_type``.
"""
from __future__ import annotations

import functools
import threading
from typing import Any, Dict, List

import torch

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
           out_dtype=None) -> torch.Tensor:
    """Softmax attention q [B,S,nh,d] over k/v [B,T,kvh,d] in query chunks
    of ``ATTN_CHUNK``; plain matmul + softmax.  Returns [B, S, nh·d]."""
    b, s, nh, hd = q.shape
    out_dtype = out_dtype or q.dtype
    scale = hd ** -0.5
    qc = min(ATTN_CHUNK, s)
    if s % qc != 0:
        qc = s
    outs = []
    for q0 in range(0, s, qc):
        sc = _gqa_scores(q[:, q0:q0 + qc], k) * scale        # [B,nh,qc,T]
        if causal:
            mask = positions[:, q0:q0 + qc, None] >= positions[:, None, :]
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
    clamps); a slot whose ``live`` (bool [B]) is False writes nothing."""
    nh, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    b = x.shape[0]
    t = cache["k"].shape[1]
    q = split_heads(dense(p["wq"], x), nh)                   # [B,1,nh,d]
    k_new = split_heads(dense(p["wk"], x), kvh)
    v_new = split_heads(dense(p["wv"], x), kvh)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)
    rows = torch.arange(b, device=x.device)
    wpos = torch.clamp(pos, max=t - 1)
    write_rows(cache["k"], (rows, wpos), k_new[:, 0], live)
    write_rows(cache["v"], (rows, wpos), v_new[:, 0], live)
    k, v = cache["k"], cache["v"]

    sc = _gqa_scores(q, k) * (hd ** -0.5)                     # [B,nh,1,T]
    valid = torch.arange(t, device=x.device)[None, :] <= pos[:, None]
    sc = torch.where(valid[:, None, None, :], sc, torch.full_like(sc, -1e30))
    pr = torch.softmax(sc, dim=-1).to(v.dtype)
    out = _gqa_pv(pr, v).to(x.dtype).reshape(b, 1, nh * hd)
    return dense(p["wo"], out)


def cross_attention(p: Params, x: torch.Tensor, memory_kv, cfg
                    ) -> torch.Tensor:
    """Attention of x [B, S, H] over precomputed memory K/V [B, M, kvh, d]
    (no RoPE, no mask), through the query-chunked :func:`attend`."""
    b, s, _ = x.shape
    q = split_heads(dense(p["wq"], x), cfg.num_heads)
    k, v = memory_kv
    positions = torch.arange(s, device=x.device).expand(b, s)
    out = attend(q, k, v, positions, causal=False, out_dtype=x.dtype)
    return dense(p["wo"], out)


def memory_kv(p: Params, memory: torch.Tensor, kvh: int):
    """The K/V of ``memory`` [B, M, H] (encoder output or image
    embeddings) under the block's projections → ([B, M, kvh, d], same)."""
    return (split_heads(dense(p["wk"], memory), kvh),
            split_heads(dense(p["wv"], memory), kvh))


def mlp(p: Params, x: torch.Tensor, activation: str) -> torch.Tensor:
    """down(act(gate(x)) · up(x)) when the MLP is gated, else
    down(act(up(x)))."""
    act = _ACT[activation]
    if "gate" in p:
        h = act(dense(p["gate"], x)) * dense(p["up"], x)
    else:
        h = act(dense(p["up"], x))
    return dense(p["down"], h)
