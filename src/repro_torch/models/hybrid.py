"""Zamba2-style hybrid: a Mamba2 backbone plus one SHARED attention block.

Counterpart of ``repro.models.hybrid``.  Layer layout (``num_layers`` in
all): groups of (attn_period − 1) Mamba2 blocks, each group followed by
one invocation of the single shared attention+MLP block (the same
weights every time, a KV cache of its own per invocation), plus a tail
of leftover Mamba2 blocks.  zamba2-1.2b: 38 = 6 × (5 mamba + shared
attention) + 2 mamba, so a prefill runs 32 Mamba2 blocks and launches
the intra-chunk SSD term 32 times.  The released model's per-invocation
LoRA deltas are omitted, as in the reference.

The decode state keeps the reference's layout: mamba conv/ssm
[g, mpg, B, …], attention K/V [g, B, T, kvh, d], tail conv/ssm
[tail, B, …]; its slot axis is not at the same place in every leaf,
which ``models.api.cache_batch_axes`` finds by probing.

Under tensor parallelism (``distributed.tp.use(mesh)``) the Mamba2
blocks run ``mamba2``'s block of heads, the shared block
``transformer``'s Megatron path (its MLP split over the hidden width),
and the state holds the rank's blocks (``cache_pspec``: conv channels,
ssm heads, K/V kv heads else head_dim).  A batch-1 sequence sharded
over the DP group (``distributed.seq``) runs both: the Mamba2 blocks'
halo and state scan, the shared block's gathered keys; its prefill
keeps the rank's block of each K/V cache's time axis.  Megatron-SP
(``cfg.seq_parallel``) runs in the shared block, as the reference's
``transformer.block`` does; the Mamba2 groups between run on the whole
residual (``tp.sp_split`` before each shared block, ``tp.sp_whole``
after it).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..distributed import seq as SEQ
from ..distributed import tp as TP
from ..kernels.ops import KernelSet, make_kernels
from ..platform import torch_dtype
from . import layers as L
from . import mamba2 as M
from . import transformer as T

Params = L.Params


def _layout(cfg) -> Tuple[int, int, int]:
    """(groups, mamba blocks per group, tail mamba blocks)."""
    per = cfg.attn_period
    groups = cfg.num_layers // per
    return groups, per - 1, cfg.num_layers - groups * per


def init(cfg, generator: torch.Generator, device=None) -> Params:
    """Random weights on ``device`` from ``generator`` (the reference's
    distributions): the grouped Mamba2 blocks [g, mpg, …], the shared
    dense block (unstacked) and the tail blocks [tail, …]."""
    dev = torch.device(device if device is not None else generator.device)
    dt = torch_dtype(cfg.dtype)
    d = cfg.d_model
    groups, mpg, tail = _layout(cfg)
    normal = T.normal_drawer(generator, dev, dt)
    mamba = M.init_blocks(cfg, groups * mpg, normal, dev)
    shared = L.layer_params(T.init_blocks(cfg, 1, normal, dev), 0)
    p = {"embed": {"w": normal((cfg.padded_vocab, d), d ** -0.5)},
         "mamba": _regroup(mamba, groups, mpg),
         "shared": shared,
         "final_norm": {"scale": torch.ones(d, device=dev, dtype=dt)},
         "lm_head": {"w": normal((d, cfg.padded_vocab), d ** -0.5)}}
    if tail:
        p["mamba_tail"] = M.init_blocks(cfg, tail, normal, dev)
    return p


def _regroup(tree, groups: int, mpg: int):
    if isinstance(tree, dict):
        return {k: _regroup(v, groups, mpg) for k, v in tree.items()}
    return tree.view((groups, mpg) + tuple(tree.shape[1:]))


def _mamba_blocks(p: Params, cfg):
    """Every Mamba2 block in layer order, as (group or None, index in
    group or tail, params)."""
    groups, mpg, tail = _layout(cfg)
    for g in range(groups):
        gp = L.layer_params(p["mamba"], g)
        for j in range(mpg):
            yield g, j, L.layer_params(gp, j)
    for j in range(tail):
        yield None, j, L.layer_params(p["mamba_tail"], j)


def forward(p: Params, cfg, tokens: torch.Tensor,
            kernels: Optional[KernelSet] = None) -> torch.Tensor:
    """tokens [B, S] → logits [B, S, V] (the padded vocab tail masked)."""
    _, mpg, _ = _layout(cfg)
    sp = TP.sp_on(cfg, tokens.shape[1])
    x = T.embed(p, cfg, tokens)
    positions = T.positions_of(tokens)
    for g, j, lp in _mamba_blocks(p, cfg):
        x = M.block(lp, x, cfg, kernels)
        if g is not None and j == mpg - 1:
            x = TP.sp_whole(T.block(p["shared"], TP.sp_split(x, sp),
                                    positions, cfg, sp), sp)
    return T.logits_head(p, x, cfg)


def loss_fn(p: Params, cfg, batch, kernels: Optional[KernelSet] = None
            ) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch``; every Mamba2 block and
    every invocation of the shared block under :func:`layers.ckpt`, the
    SSD term through ``kernels`` (see ``mamba2.loss_fn``)."""
    kernels = kernels or make_kernels()
    tokens = batch["tokens"]
    groups, mpg, tail = _layout(cfg)
    sp = TP.sp_on(cfg, tokens.shape[1])
    x = T.embed(p, cfg, tokens)
    positions = T.positions_of(tokens)
    mblock = L.ckpt(M.block, cfg)
    ablock = L.ckpt(T.block, cfg)
    for group in L.unstack2(p["mamba"], groups, mpg):
        for lp in group:
            x = mblock(lp, x, cfg, kernels)
        x = TP.sp_whole(ablock(p["shared"], TP.sp_split(x, sp), positions,
                               cfg, sp), sp)
    if tail:
        for lp in L.unstack(p["mamba_tail"], tail):
            x = mblock(lp, x, cfg, kernels)
    return T.loss_head(p, x, cfg, batch["labels"])


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_state(cfg, batch: int, max_len: int, device=None) -> Params:
    """Zero decode state in the reference's layout (conv and K/V in
    ``cfg.dtype``, ssm float32; under tensor parallelism the rank's
    blocks)."""
    groups, mpg, tail = _layout(cfg)
    conv_ch = TP.conv_width(cfg)
    kvh, hd = T.kv_dims(cfg)
    dt = torch_dtype(cfg.dtype)
    w1, nh, shd, ds = (cfg.ssm_conv_width - 1, TP.ssm_state_heads(cfg),
                       cfg.ssm_head_dim, cfg.ssm_state)

    def z(shape, dtype=dt):
        return torch.zeros(shape, device=device, dtype=dtype)

    st = {"mamba": {"conv": z((groups, mpg, batch, w1, conv_ch)),
                    "ssm": z((groups, mpg, batch, nh, shd, ds),
                             torch.float32)},
          "attn": {"k": z((groups, batch, max_len, kvh, hd)),
                   "v": z((groups, batch, max_len, kvh, hd))}}
    if tail:
        st["tail"] = {"conv": z((tail, batch, w1, conv_ch)),
                      "ssm": z((tail, batch, nh, shd, ds), torch.float32)}
    return st


def _mamba_state(st: Params, g, j):
    """The (conv, ssm) slices of one block of the state tree (views)."""
    if g is None:
        return {"conv": st["tail"]["conv"][j], "ssm": st["tail"]["ssm"][j]}
    return {"conv": st["mamba"]["conv"][g, j],
            "ssm": st["mamba"]["ssm"][g, j]}


def prefill(p: Params, cfg, tokens: torch.Tensor,
            max_len: Optional[int] = None,
            kernels: Optional[KernelSet] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Full forward that also assembles the decode state: each Mamba2
    block's final (conv, ssm) state and each shared-block invocation's
    K/V.  The SSD runs through ``mamba2._ssd_core`` with ``kernels``
    (the CUDA ``ssd_chunk_intra`` on the card).  Returns (last-position
    logits [B, V], state)."""
    kernels = kernels or make_kernels()
    b, s = tokens.shape
    _, mpg, _ = _layout(cfg)
    sp = TP.sp_on(cfg, s)
    x = T.embed(p, cfg, tokens)
    positions = T.positions_of(tokens)
    seq = SEQ.current() is not None
    # sequence-sharded, the K/V leaves are replaced by their blocks below
    st = init_state(cfg, b, 1 if seq else max_len or s,
                    device=tokens.device)
    sh = p["shared"]
    lay = TP.ssm(cfg)
    ks, vs = [], []
    for g, j, lp in _mamba_blocks(p, cfg):
        h_in = L.rmsnorm(lp["norm"], x, cfg.norm_eps)
        inputs = M._ssd_inputs(lp["ssd"], h_in, cfg)
        final = {}
        x = x + M._ssd_core(lp["ssd"], h_in, cfg, kernels, inputs, final)
        M.put_state(_mamba_state(st, g, j),
                    M.final_state(lp, inputs, cfg, lay, final), lay)
        if g is not None and j == mpg - 1:
            x = TP.sp_split(x, sp)
            a, k, v = T._self_attention(sh["attn"],
                                        T.norm(sh["attn_norm"], x, cfg, sp),
                                        cfg, positions, sp=sp)
            ks.append(k)
            vs.append(v)
            x = x + a
            x = TP.sp_whole(x + L.mlp(sh["mlp"],
                                      T.norm(sh["mlp_norm"], x, cfg, sp),
                                      cfg.activation, cfg.d_ff, sp), sp)
    for name, rows in (("k", ks), ("v", vs)):
        if seq and rows:
            st["attn"][name] = T.seq_cache_rows(rows, cfg, max_len, name)
        elif rows:
            st["attn"][name][:, :, :s] = torch.stack(rows)
    if seq:
        x = SEQ.from_last(x[:, -1:, :], "last_hidden")
    return T.logits_head(p, x[:, -1:, :], cfg)[:, 0], st


def decode_step(p: Params, cfg, token: torch.Tensor, state: Params,
                pos: torch.Tensor, live=None) -> Tuple[torch.Tensor, Params]:
    """One-token step: token [B], pos [B] → (logits [B, V], state).  The
    state is updated IN PLACE, one block's slice at a time; a slot whose
    ``live`` (bool [B]) is False writes nothing."""
    _, mpg, _ = _layout(cfg)
    x = T.embed(p, cfg, token)[:, None, :]
    sh = p["shared"]
    for g, j, lp in _mamba_blocks(p, cfg):
        cur = _mamba_state(state, g, j)
        y, new = M.ssd_decode(lp["ssd"], L.rmsnorm(lp["norm"], x,
                                                   cfg.norm_eps), cur, cfg)
        M.write_state(cur, new, cfg, live)
        x = x + y
        if g is not None and j == mpg - 1:
            kv = {"k": state["attn"]["k"][g], "v": state["attn"]["v"][g]}
            x = x + L.decode_attention(sh["attn"],
                                       T.norm(sh["attn_norm"], x, cfg),
                                       kv, pos, cfg, live)
            x = x + L.mlp(sh["mlp"], T.norm(sh["mlp_norm"], x, cfg),
                          cfg.activation, cfg.d_ff)
    return T.logits_head(p, x, cfg)[:, 0], state
