"""Random weights of a dense decoder from the seed, made on the card.

The parameters are views of ONE buffer of the served dtype, filled by
a few ``normal_`` calls on the device's generator and scaled leaf by
leaf in place: projections N(0, 1/fan_in), the embedding and the head
N(0, 1/d_model), biases (where the configuration has them) N(0, 0.02²),
norm scales one.  The tree is the layout the port's dense models take
(layers stacked on a leading axis).

A mix's ``weights`` object can give the activations the structure real
checkpoints' have, which the activation decomposition relies on:
``norm_outliers`` plants outlier channels (in every layer's two norm
scales a share of the channels, drawn from the seed, takes a gain drawn
uniformly from ``gain``, so those channels of the block inputs stand
far above the rest: the channels the outlier extraction exists for);
``embed_lowrank`` makes the residual stream low-rank (every token's
embedding in one subspace of ``rank`` dimensions, ``scale`` times the
norm a block adds), so the block inputs have a few dominant directions
and a long flat tail, as measured activations do, instead of the flat
spectrum of a random model.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

CHUNK = 1 << 30          # elements a draw fills (a few calls a model)

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str, float]


def leaves(cfg) -> List[Leaf]:
    """(path, shape, init, std) of every parameter, init one of
    ``normal``, ``ones``."""
    d, L = cfg.d_model, cfg.num_layers
    nh, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    f, vp = cfg.d_ff, cfg.padded_vocab
    out: List[Leaf] = [(("embed", "w"), (vp, d), "normal", d ** -0.5)]
    lin = {"attn": {"wq": (d, nh * hd), "wk": (d, kvh * hd),
                    "wv": (d, kvh * hd), "wo": (nh * hd, d)},
           "mlp": {"up": (d, f), "down": (f, d)}}
    if cfg.gated_mlp:
        lin["mlp"]["gate"] = (d, f)
    for norm in ("attn_norm", "mlp_norm"):
        out.append((("layers", norm, "scale"), (L, d), "ones", 1.0))
        if cfg.use_bias:
            out.append((("layers", norm, "bias"), (L, d), "normal", 0.02))
    for grp, ws in lin.items():
        for name, (i, o) in ws.items():
            out.append((("layers", grp, name, "w"), (L, i, o), "normal",
                        i ** -0.5))
            if cfg.use_bias:
                out.append((("layers", grp, name, "b"), (L, o), "normal",
                            0.02))
    out.append((("final_norm", "scale"), (d,), "ones", 1.0))
    if cfg.use_bias:
        out.append((("final_norm", "bias"), (d,), "normal", 0.02))
    if not cfg.tie_embeddings:
        out.append((("lm_head", "w"), (d, vp), "normal", d ** -0.5))
    return out


def _put(tree: Dict, path: Tuple[str, ...], t: torch.Tensor) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = t


def make_params(cfg, seed: int, device, spec: Optional[Dict] = None
                ) -> Dict:
    """The parameter tree of ``cfg`` in ``cfg.dtype`` on ``device``
    (``spec``: a mix's ``weights`` object)."""
    spec = spec or {}
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2**63))
    specs = leaves(cfg)
    n = sum(math.prod(s) for _, s, init, _ in specs if init == "normal")
    buf = torch.empty(n, device=device, dtype=dt)
    for a in range(0, n, CHUNK):
        buf[a:a + CHUNK].normal_(generator=g)
    tree: Dict = {}
    off = 0
    for path, shape, init, std in specs:
        if init == "normal":
            k = math.prod(shape)
            t = buf[off:off + k].view(shape)
            t.mul_(std)
            off += k
        else:
            t = torch.ones(shape, device=device, dtype=dt)
        _put(tree, path, t)
    if spec.get("embed_lowrank"):
        lowrank_embedding(tree, cfg, g, spec["embed_lowrank"])
    if spec.get("norm_outliers"):
        plant_outliers(tree, cfg, g, spec["norm_outliers"])
    return tree


def lowrank_embedding(tree: Dict, cfg, g: torch.Generator, spec: Dict
                      ) -> None:
    """Replace the embedding table by ``scale`` · A·B, A [vocab, rank] and
    B [rank, d_model] standard normal / √rank: every token's embedding
    (norm ≈ scale·√d_model) lies in one ``rank``-dimensional subspace."""
    w = tree["embed"]["w"]
    r = int(spec["rank"])
    a = torch.randn(w.shape[0], r, generator=g, device=g.device)
    b = torch.randn(r, w.shape[1], generator=g, device=g.device) * r ** -0.5
    w.copy_((float(spec["scale"]) * (a @ b)).to(w.dtype))


def plant_outliers(tree: Dict, cfg, g: torch.Generator, spec: Dict) -> None:
    """Give ``round(share · d_model)`` channels of every layer's norm
    scales a gain uniform in ``spec["gain"]`` (channels and gains drawn
    from ``g``)."""
    d, L = cfg.d_model, cfg.num_layers
    c = max(1, round(float(spec["share"]) * d))
    lo, hi = (float(x) for x in spec["gain"])
    dev = g.device
    for norm in ("attn_norm", "mlp_norm"):
        scale = tree["layers"][norm]["scale"]
        keys = torch.rand(L, d, generator=g, device=dev)
        idx = keys.argsort(dim=-1)[:, :c]
        gains = lo + (hi - lo) * torch.rand(L, c, generator=g, device=dev)
        scale.scatter_(1, idx, gains.to(scale.dtype))
