"""Dense decoder-only transformer (llama2 / deepseek family).

Counterpart of ``repro.models.transformer``: the same parameter tree
(layers stacked on a leading L axis), prefill that also emits the KV
cache, and one-token decode.  The layer loop is a Python loop over views
of the stacked weights (the JAX version scans).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..platform import torch_dtype
from . import layers as L

Params = L.Params


# ---------------------------------------------------------------------------
# Init: the distributions of repro.models.layers (dense/embed/norm init)
# ---------------------------------------------------------------------------

def init(cfg, generator: torch.Generator, device=None) -> Params:
    """Random weights on ``device`` from ``generator``: N(0, 1/in) for
    projections, N(0, 1/d_model) for the embedding, ones for norm scales.
    Each layer's slice is drawn in float32 and stored in ``cfg.dtype``,
    so a full-width model never holds more than one float32 matrix."""
    dev = torch.device(device if device is not None else generator.device)
    dt = torch_dtype(cfg.dtype)
    nl, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    nh, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * std).to(dt)

    def stacked(in_dim, out_dim):
        w = torch.empty(nl, in_dim, out_dim, device=dev, dtype=dt)
        for i in range(nl):
            w[i] = normal((in_dim, out_dim), in_dim ** -0.5)
        return {"w": w}

    ones = lambda *shape: torch.ones(shape, device=dev, dtype=dt)
    layers = {
        "attn_norm": {"scale": ones(nl, d)},
        "attn": {"wq": stacked(d, nh * hd), "wk": stacked(d, kvh * hd),
                 "wv": stacked(d, kvh * hd), "wo": stacked(nh * hd, d)},
        "mlp_norm": {"scale": ones(nl, d)},
        "mlp": {"up": stacked(d, f), "down": stacked(f, d),
                "gate": stacked(d, f)},
    }
    return {"embed": {"w": normal((cfg.padded_vocab, d), d ** -0.5)},
            "layers": layers,
            "final_norm": {"scale": ones(d)},
            "lm_head": {"w": normal((d, cfg.padded_vocab), d ** -0.5)}}


def param_bytes(p) -> int:
    if isinstance(p, dict):
        return sum(param_bytes(v) for v in p.values())
    return p.numel() * p.element_size()


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------

def norm(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    return L.rmsnorm(p, x, cfg.norm_eps)


def embed(p: Params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    return p["embed"]["w"][tokens]


def logits_head(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    logits = L.dense(p["lm_head"], norm(p["final_norm"], x, cfg))
    if cfg.padded_vocab != cfg.vocab:          # mask the padding tail
        iota = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(iota < cfg.vocab, logits,
                             torch.full_like(logits, -1e30))
    return logits


def _self_attention(lp: Params, h: torch.Tensor, cfg,
                    positions: torch.Tensor):
    """Causal self-attention of one block; also returns its RoPE'd K and
    V [B, S, kvh, d] (the prefill cache rows)."""
    nh, kvh = cfg.num_heads, cfg.num_kv_heads
    q = L.split_heads(L.dense(lp["wq"], h), nh)
    k = L.split_heads(L.dense(lp["wk"], h), kvh)
    v = L.split_heads(L.dense(lp["wv"], h), kvh)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    out = L.attend(q, k, v, positions, causal=True, out_dtype=h.dtype)
    return L.dense(lp["wo"], out), k, v


def block(p: Params, x: torch.Tensor, positions: torch.Tensor,
          cfg) -> torch.Tensor:
    """One dense block: x [B, S, H] → x + attn(norm(x)) + mlp(norm(·))."""
    x = x + _self_attention(p["attn"], norm(p["attn_norm"], x, cfg), cfg,
                            positions)[0]
    return x + L.mlp(p["mlp"], norm(p["mlp_norm"], x, cfg), cfg.activation)


def forward(p: Params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, S] → logits [B, S, V] (the padded vocab tail masked)."""
    b, s = tokens.shape
    x = embed(p, cfg, tokens)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    for i in range(cfg.num_layers):
        x = block(L.layer_params(p["layers"], i), x, positions, cfg)
    return logits_head(p, x, cfg)


def forward_layers(p: Params, cfg, tokens: torch.Tensor):
    """Run every block over ``tokens`` [B, S] → (final hidden [B, S, H],
    per-layer K list, per-layer V list)."""
    b, s = tokens.shape
    x = embed(p, cfg, tokens)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = L.layer_params(p["layers"], i)
        a, k, v = _self_attention(lp["attn"], norm(lp["attn_norm"], x, cfg),
                                  cfg, positions)
        x = x + a
        x = x + L.mlp(lp["mlp"], norm(lp["mlp_norm"], x, cfg),
                      cfg.activation)
        ks.append(k)
        vs.append(v)
    return x, ks, vs


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device=None) -> Params:
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    dt = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, device=device, dtype=dt),
            "v": torch.zeros(shape, device=device, dtype=dt)}


def prefill(p: Params, cfg, tokens: torch.Tensor,
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
    """Full-sequence forward that also emits the KV cache.
    Returns (last-position logits [B, V], cache [L, B, T, kvh, d])."""
    b, s = tokens.shape
    t = max_len or s
    x, ks, vs = forward_layers(p, cfg, tokens)
    cache = init_cache(cfg, b, t, device=tokens.device)
    cache["k"][:, :, :s] = torch.stack(ks)
    cache["v"][:, :, :s] = torch.stack(vs)
    return logits_head(p, x[:, -1:, :], cfg)[:, 0], cache


def decode_step(p: Params, cfg, token: torch.Tensor, cache: Params,
                pos: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """One-token step: token [B], pos [B] → (logits [B, V], cache).  The
    cache is updated IN PLACE (one row per slot per layer)."""
    x = embed(p, cfg, token)[:, None, :]
    for i in range(cfg.num_layers):
        lp = L.layer_params(p["layers"], i)
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
        x = x + L.decode_attention(lp["attn"],
                                   norm(lp["attn_norm"], x, cfg),
                                   layer_cache, pos, cfg)
        x = x + L.mlp(lp["mlp"], norm(lp["mlp_norm"], x, cfg),
                      cfg.activation)
    return logits_head(p, x, cfg)[:, 0], cache
