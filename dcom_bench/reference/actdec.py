"""The activation-decomposition forward (paper §3–4), float32.

In a layer the policy selects, each block input h (after the norm) is
split into its outlier channels and the rest.  The outlier channels are
the ``max(1, round(frac · H))`` with the most entries above the
threshold in magnitude, ties broken by the channel's largest magnitude.
The rest is replaced by its rank-r Lanczos approximation (``iters``
steps), the outlier channels ride along unchanged, and the attention's
Q/K/V and the MLP's up (and gate) projections read that approximation;
the attention itself, the output and down projections and the residual
stream stay dense.  Other layers are dense blocks.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from . import dense as D
from . import lanczos as LZ


def outlier_channels(h: torch.Tensor, threshold: float, count: int
                     ) -> torch.Tensor:
    """h [S, H] → the ``count`` outlier channel indices."""
    a = h.abs()
    counts = (a > threshold).sum(0).float()
    mx = a.amax(0)
    score = counts + mx / (1.0 + mx.max())
    return torch.topk(score, count).indices


def approximate(h: torch.Tensor, rank: int, iters: int, frac: float,
                threshold: float) -> torch.Tensor:
    """h [S, H] with everything but its outlier channels replaced by the
    rank-``rank`` Lanczos approximation."""
    base = h.clone()
    idx = None
    if frac > 0:
        idx = outlier_channels(h, threshold,
                               max(1, round(frac * h.shape[-1])))
        base[:, idx] = 0.0
    us, vt = LZ.svd(base[None], rank, iters)
    out = us[0] @ vt[0]
    if idx is not None:
        out[:, idx] += h[:, idx]
    return out


def block(p: Dict, x: torch.Tensor, cfg, cast, pol: Dict) -> torch.Tensor:
    """One block over x [S, d] (``pol``: None for a dense block, else
    rank / iters / outlier_frac / threshold)."""
    s = x.shape[0]
    pos = torch.arange(s, device=x.device)
    h = D.norm(p["attn_norm"], x, cfg)
    if pol:
        h = approximate(h, pol["rank"], pol["iters"], pol["outlier_frac"],
                        pol["threshold"])
    q, k, v = D.qkv(p["attn"], h, pos, cfg, cast)
    x = x + D.linear(p["attn"]["wo"],
                     D.attend(q, k, v, D.causal(s, x.device), cast), cast)
    h = D.norm(p["mlp_norm"], x, cfg)
    if pol:
        h = approximate(h, pol["rank"], pol["iters"], pol["outlier_frac"],
                        pol["threshold"])
    return x + D.mlp(p["mlp"], h, cfg, cast)


def forward(params: Dict, cfg, tokens: torch.Tensor, layers: Sequence[int],
            pol: Dict, cast) -> torch.Tensor:
    """tokens [S] → logits [S, vocab] float32; ``layers`` decompose under
    ``pol``."""
    x = D.embed(params, tokens, cfg)
    chosen = set(int(i) for i in layers)
    for i in range(cfg.num_layers):
        x = block(D.layer(params, i), x, cfg, cast,
                  pol if i in chosen else None)
    return D.logits(params, x, cfg, cast)
