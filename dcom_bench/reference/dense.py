"""A dense decoder block and head in float32, from the published
equations.

The configuration's variants: RMSNorm, or LayerNorm with a bias where
the model has biased linears (starcoder2); SwiGLU, or an ungated MLP
with the tanh approximation of GELU; rotary embeddings on interleaved
pairs (x[2i], x[2i+1]), the port's layout; grouped-query attention.
Every matrix product goes through a :class:`~.precision.Cast`.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

ATTN_ROWS = 512          # query rows per attention block (memory only)


def layer(params: Dict, i: int) -> Dict:
    """Layer ``i``'s parameters in float32 (a copy)."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return t[i].float()
    return walk(params["layers"])


def norm(p: Dict, x: torch.Tensor, cfg) -> torch.Tensor:
    x = x.float()
    if cfg.use_bias:
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + cfg.norm_eps) * p["scale"].float()
        return y + p["bias"].float() if "bias" in p else y
    var = (x * x).mean(-1, keepdim=True)
    return x * torch.rsqrt(var + cfg.norm_eps) * p["scale"].float()


def linear(p: Dict, x: torch.Tensor, cast) -> torch.Tensor:
    y = cast.mm(x, p["w"])
    return y + p["b"].float() if "b" in p else y


def act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return x * torch.sigmoid(x)
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3)))


def mlp(p: Dict, h: torch.Tensor, cfg, cast) -> torch.Tensor:
    if "gate" in p:
        hid = act(linear(p["gate"], h, cast), cfg.activation) \
            * linear(p["up"], h, cast)
    else:
        hid = act(linear(p["up"], h, cast), cfg.activation)
    return linear(p["down"], hid, cast)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x [S, n, d] rotated at ``positions`` [S] on interleaved pairs."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device,
                                          dtype=torch.float32) / d))
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def qkv(p: Dict, h: torch.Tensor, positions: torch.Tensor, cfg, cast):
    """q [S, nh, hd], k and v [S, kvh, hd] (q and k rotated)."""
    hd = cfg.resolved_head_dim
    q = linear(p["wq"], h, cast).reshape(h.shape[0], -1, hd)
    k = linear(p["wk"], h, cast).reshape(h.shape[0], -1, hd)
    v = linear(p["wv"], h, cast).reshape(h.shape[0], -1, hd)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           valid: torch.Tensor, cast) -> torch.Tensor:
    """Softmax attention of q [S, nh, hd] over k, v [T, kvh, hd] where
    ``valid`` [S, T] allows it → [S, nh·hd]."""
    s, nh, hd = q.shape
    kvh = k.shape[1]
    g = nh // kvh
    kk = cast.round(k).permute(1, 2, 0)                  # [kvh, hd, T]
    vv = cast.round(v).permute(1, 0, 2)                  # [kvh, T, hd]
    out = []
    for r0 in range(0, s, ATTN_ROWS):
        qq = cast.round(q[r0:r0 + ATTN_ROWS])            # [r, nh, hd]
        r = qq.shape[0]
        qg = qq.reshape(r, kvh, g, hd).permute(1, 0, 2, 3).reshape(
            kvh, r * g, hd)
        sc = (qg @ kk).reshape(kvh, r, g, -1) * hd ** -0.5
        ok = valid[r0:r0 + r][None, :, None, :]
        sc = sc.masked_fill(~ok, float("-inf"))
        pr = torch.softmax(sc, dim=-1)
        o = cast.round(pr.reshape(kvh, r * g, -1)) @ vv  # [kvh, r·g, hd]
        out.append(o.reshape(kvh, r, g, hd).permute(1, 0, 2, 3).reshape(
            r, nh * hd))
    return torch.cat(out)


def causal(n: int, device) -> torch.Tensor:
    i = torch.arange(n, device=device)
    return i[:, None] >= i[None, :]


def logits(params: Dict, x: torch.Tensor, cfg, cast) -> torch.Tensor:
    """Final norm and head → [S, vocab] over the real vocabulary."""
    fn = {k: v.float() for k, v in params["final_norm"].items()}
    h = norm(fn, x, cfg)
    w = params["lm_head"]["w"] if "lm_head" in params \
        else params["embed"]["w"].t()
    return cast.mm(h, w[:, :cfg.vocab])


def embed(params: Dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    x = params["embed"]["w"][tokens].float()
    if cfg.tie_embeddings:
        x = x * math.sqrt(cfg.d_model)
    return x
