"""Shared building blocks of the dense transformer (plain functions).

Counterpart of ``repro.models.layers``.  Parameters are nested dicts of
tensors in the JAX layout (weights ``[in, out]``, layers stacked on a
leading L axis); activations are [B, S, H], attention internals
[B, S, n, d].  Matmuls take the storage dtype (bf16) and accumulate in
float32; attention scores, softmax and normalization run in float32, as
the JAX code asks with ``preferred_element_type``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

Params = Dict[str, Any]

# Query-chunk length of prefill attention (bounds the [qc, T] score block).
ATTN_CHUNK = 512


def silu(x: torch.Tensor) -> torch.Tensor:
    """x·σ(x) with σ(x) = 1 / (1 + e^−x) evaluated op by op in x's dtype:
    how XLA expands ``jax.nn.silu``'s logistic, so bf16 rounds where the
    reference rounds (``F.silu`` rounds once and flips greedy tokens)."""
    return x * (1 / (1 + torch.exp(-x)))


_ACT = {"silu": silu}


def layer_params(layers: Params, i: int) -> Params:
    """Layer ``i`` of a tree stacked on a leading L axis (views)."""
    if isinstance(layers, dict):
        return {k: layer_params(v, i) for k, v in layers.items()}
    return layers[i]


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"]


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


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


def decode_attention(p: Params, x: torch.Tensor, cache: Params,
                     pos: torch.Tensor, cfg) -> torch.Tensor:
    """One-token attention: x [B, 1, H], cache k/v [B, T, kvh, d], pos [B].
    Writes the new K/V row of each slot into ``cache`` IN PLACE."""
    nh, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    b = x.shape[0]
    t = cache["k"].shape[1]
    q = split_heads(dense(p["wq"], x), nh)                   # [B,1,nh,d]
    k_new = split_heads(dense(p["wk"], x), kvh)
    v_new = split_heads(dense(p["wv"], x), kvh)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)
    rows = torch.arange(b, device=x.device)
    cache["k"][rows, pos] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, pos] = v_new[:, 0].to(cache["v"].dtype)
    k, v = cache["k"], cache["v"]

    sc = _gqa_scores(q, k) * (hd ** -0.5)                     # [B,nh,1,T]
    valid = torch.arange(t, device=x.device)[None, :] <= pos[:, None]
    sc = torch.where(valid[:, None, None, :], sc, torch.full_like(sc, -1e30))
    pr = torch.softmax(sc, dim=-1).to(v.dtype)
    out = _gqa_pv(pr, v).to(x.dtype).reshape(b, 1, nh * hd)
    return dense(p["wo"], out)


def mlp(p: Params, x: torch.Tensor, activation: str) -> torch.Tensor:
    """Gated MLP: down(act(gate(x)) · up(x))."""
    h = _ACT[activation](dense(p["gate"], x)) * dense(p["up"], x)
    return dense(p["down"], h)
