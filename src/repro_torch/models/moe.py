"""Token-choice top-k mixture of experts (olmoe-1b-7b, kimi-k2-1t-a32b).

Counterpart of ``repro.models.moe``: its GSPMD formulation
(:func:`moe_ffn`) and the expert-parallel :func:`moe_ffn_shard_map`,
which every MoE block runs under tensor parallelism
(``distributed.tp.use``).  Dispatch is sort-based with static capacity
buffers:

  1. router top-k → (expert id, gate) per token slot,
  2. rank in expert from sorted runs,
  3. token indices scattered into an [E, C] slot table (a token past its
     expert's capacity C is dropped),
  4. the expert FFN as batched products over [E, C, H] buffers,
  5. combine: gather, then the gate-weighted sum over the k slots.

Every step is a device tensor op with no host read, so a decode step
captures into a CUDA graph.  Where PyTorch's defaults differ from the
JAX ops, the port pins the reference's semantics: ties in the router
break to the lower expert index (``jax.lax.top_k``; a stable descending
sort here), both argsorts are stable (``jnp.argsort``), the per-expert
counts are a ``scatter_add_`` into a fixed [E] tensor (``torch.bincount``
reads its input's max on the host), and the capacity drop writes into a
spare column (``mode="drop"``; an out-of-range index is a device assert
in torch).

kimi-k2 extras: ``first_k_dense`` leading dense blocks and
``n_shared_experts`` always-on shared experts added to the MoE output.
Under Megatron-SP (``cfg.seq_parallel``) the leading dense blocks run it,
as the reference's ``transformer.block`` does, and the residual is
gathered whole once before the MoE blocks (``tp.sp_whole``).
Decode routes the WHOLE slot batch, dead and padding rows included, as
the reference does: their tokens take capacity too.

A call whose tokens are split over the DP group (``distributed.tokens``:
a data-parallel train step's rows or a batch-1 sequence's blocks, a
slot-sharded decode) runs one of the reference's two forms: by default
its GSPMD ``moe_ffn`` (:func:`route`'s statistics over the group:
global capacity, ranks and aux loss, token-equal to the whole call),
with ``cfg.moe_shard_map`` its ``moe_ffn_shard_map`` (each rank's
capacity and aux loss, the aux averaged over the group).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..distributed import seq as SEQ
from ..distributed import sharding as sh
from ..distributed import tokens as TOK
from ..distributed import tp as TP
from ..platform import torch_dtype
from . import layers as L
from . import transformer as T

Params = L.Params

AUX_LOSS_COEF = 0.01


# ---------------------------------------------------------------------------
# Init: the distributions of repro.models.moe (moe_ffn_init, init)
# ---------------------------------------------------------------------------

def moe_ffn_init(cfg, n: int, normal, device) -> Params:
    """The MoE FFNs of ``n`` layers stacked on a leading axis: router,
    gate and up N(0, 1/d_model), down N(0, 1/moe_d_ff), one expert's
    matrix at a time; the shared experts as one gated MLP of width
    ``moe_d_ff · n_shared_experts``."""
    dt = torch_dtype(cfg.dtype)
    e, h, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff

    def experts(shape, std):
        return T.drawn_slices((n, e), shape, std, normal, device, dt)

    def stacked(in_dim, out_dim):
        return {"w": T.drawn_slices((n,), (in_dim, out_dim), in_dim ** -0.5,
                                    normal, device, dt)}

    p = {"router": stacked(h, e),
         "w_gate": experts((h, f), h ** -0.5),
         "w_up": experts((h, f), h ** -0.5),
         "w_down": experts((f, h), f ** -0.5)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"gate": stacked(h, fs), "up": stacked(h, fs),
                       "down": stacked(fs, h)}
    return p


def init(cfg, generator: torch.Generator, device=None) -> Params:
    """Random weights on ``device`` from ``generator`` (the reference's
    distributions; layout: MoE blocks under ``layers``, the leading dense
    blocks under ``dense_layers``)."""
    dev = torch.device(device if device is not None else generator.device)
    dt = torch_dtype(cfg.dtype)
    d = cfg.d_model
    nd, nm = cfg.first_k_dense, cfg.num_layers - cfg.first_k_dense
    normal = T.normal_drawer(generator, dev, dt)
    blocks = T.init_blocks(cfg, nm, normal, dev)
    del blocks["mlp"]
    blocks["moe"] = moe_ffn_init(cfg, nm, normal, dev)
    p = {"embed": {"w": normal((cfg.padded_vocab, d), d ** -0.5)},
         "layers": blocks,
         "final_norm": {"scale": torch.ones(d, device=dev, dtype=dt)},
         "lm_head": {"w": normal((d, cfg.padded_vocab), d ** -0.5)}}
    if nd:
        p["dense_layers"] = T.init_blocks(cfg, nd, normal, dev)
    return p


# ---------------------------------------------------------------------------
# MoE FFN
# ---------------------------------------------------------------------------

def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values, and on
    ties the lower index first (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg, tokens: int) -> int:
    """Slots per expert: ceil(tokens · top_k · capacity_factor / E)."""
    return max(1, math.ceil(tokens * cfg.top_k * cfg.capacity_factor
                            / cfg.num_experts))


def route(p: Params, xf: torch.Tensor, cfg, split=None):
    """Router of ``xf`` [T, H] → (gates [T, k] float32, expert ids [T, k],
    rank of each (token, slot) in its expert [T·k], aux loss).  With
    ``split`` (``distributed.tokens.Split``: ``xf`` is this rank's block
    of a call's tokens) the statistics are the whole call's, as the
    reference's GSPMD ``moe_ffn`` computes them: ``me`` and the top-1
    counts summed over the group and divided by its tokens, and each
    slot's rank offset by the exclusive scan of the per-expert counts
    over the ranks before this one (their tokens come first in the flat
    order: the global stable argsort's rank)."""
    e, k = cfg.num_experts, cfg.top_k
    t = xf.shape[0]
    dev = xf.device
    logits = xf.float() @ p["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)                       # [T, E]
    gate_vals, eidx = top_k(probs, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # Switch-style load-balancing loss
    me = probs.mean(dim=0)
    first = torch.zeros(e, device=dev).scatter_add_(
        0, eidx[:, 0], torch.ones(t, device=dev))
    n_all = t
    if split is not None:
        n_all = t * split.size
        stats = TOK.total(torch.cat([me * (t / n_all), first]), split,
                          "moe_route")
        me, first = stats[:e], stats[e:]
    aux = e * torch.sum(me * (first / n_all)) * AUX_LOSS_COEF

    # rank in expert from sorted runs (both argsorts stable, as jnp's)
    slots_e = eidx.reshape(t * k)
    order = torch.argsort(slots_e, stable=True)
    counts = torch.zeros(e, dtype=torch.long, device=dev).scatter_add_(
        0, slots_e, torch.ones_like(slots_e))
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(t * k, device=dev) - starts[slots_e[order]]
    rank = rank_sorted[torch.argsort(order, stable=True)]
    if split is not None:
        rank = rank + TOK.offsets(counts, split, "moe_counts")[slots_e]
    return gate_vals, eidx, rank, aux


def moe_ffn(p: Params, x: torch.Tensor, cfg) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """x [B, S, H] → (y [B, S, H], aux loss []) on one device: every
    expert, capacity per call, ceil(B·S · top_k · capacity_factor / E)
    slots an expert (:func:`moe_ffn_shard_map` with no mesh)."""
    return moe_ffn_shard_map(p, x, cfg, None)


def shared_width(cfg) -> int:
    """The shared experts' MLP width (one gated MLP)."""
    return cfg.moe_d_ff * cfg.n_shared_experts


def moe_ffn_shard_map(p: Params, x: torch.Tensor, cfg, mesh
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel MoE FFN (the reference's ``moe_ffn_shard_map``,
    with the mesh an argument instead of a module global): ``p`` holds the
    rank's E/M experts (``params_sharding``), ``x`` [B, S, H] is the
    rank's tokens (its block of the DP super-axis), model-replicated.
    Every model rank routes all of ``x``, dispatches locally into buffers
    of its own experts only, and the gate-weighted combine is
    all-reduced over "model" in ``x``'s dtype; the aux loss is averaged
    over the DP super-axis.  Capacity is per call, from the rank's
    tokens: on each data shard this is :func:`moe_ffn` of that shard
    (the reference's documented semantics).  ``expert_sharding="2d"``
    all-gathers the F dim of the expert weights over "data" first (its
    backward reduce-scatters the gradient, which then has the rank's F
    block's shape)."""
    split = TOK.of(mesh) if mesh is not None and sh.dp_size(mesh) > 1 \
        else None
    with TP.use(mesh) as tp:
        return _experts(p, x, cfg, mesh, tp, split, per_shard=True)


def _experts(p: Params, x: torch.Tensor, cfg, mesh, tp, split,
             per_shard: bool):
    """The MoE FFN of ``x``, the rank's block of a call's tokens split
    over ``split`` (None: the whole call).  ``per_shard``: capacity from
    the rank's tokens, the aux loss averaged over the group (the
    reference's ``moe_ffn_shard_map``); else the whole call's capacity,
    ranks and aux loss (its GSPMD ``moe_ffn``: each rank's dispatch
    buffer still holds the global capacity's slots, most of them other
    ranks' tokens)."""
    b, s, h = x.shape
    e, k = cfg.num_experts, cfg.top_k
    m, m_idx = (1, 0) if tp is None else (tp.size, tp.rank)
    if e % m:
        raise ValueError(f"{e} experts do not divide over a 'model' axis "
                         f"of {m}")
    e_loc = e // m
    t = b * s
    glob = None if per_shard else split
    cap = capacity(cfg, t * (1 if glob is None else glob.size))
    dev = x.device
    xf = x.reshape(t, h)
    gate_vals, eidx, rank, aux = (route(p, xf, cfg) if glob is None
                                  else route(p, xf, cfg, glob))
    if per_shard and split is not None:
        aux = TOK.total(aux.reshape(1), split, "aux").reshape(()) \
            / split.size
    slots_e = eidx.reshape(t * k)
    slot_tok = torch.arange(t * k, device=dev) // k

    # this model rank's experts; the others' slots go to the spare row
    local_e = slots_e - m_idx * e_loc
    owned = (local_e >= 0) & (local_e < e_loc) & (rank < cap)
    le = torch.where(owned, local_e, torch.full_like(local_e, e_loc))
    rk = torch.where(owned, rank, torch.full_like(rank, cap))
    table = torch.full((e_loc + 1, cap + 1), t, dtype=torch.long,
                       device=dev)
    table[le, rk] = slot_tok
    xd = TP.copy(xf, "moe_in")            # each rank: its experts' share
    x_pad = torch.cat([xd, xd.new_zeros(1, h)], dim=0)
    buf = x_pad[table[:e_loc, :cap]]                        # [E_loc, C, H]

    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    if mesh is not None and getattr(cfg, "expert_sharding", "1d") == "2d" \
            and sh.axis_size(mesh, "data") > 1 \
            and cfg.moe_d_ff % sh.axis_size(mesh, "data") == 0:
        grp = sh.axis_group(mesh, "data")
        wg = TP.gather_rs(wg, grp, 2, "w_gate_f")
        wu = TP.gather_rs(wu, grp, 2, "w_up_f")
        wd = TP.gather_rs(wd, grp, 1, "w_down_f")
    act = L._ACT[cfg.activation]
    hidden = act(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    out_buf = torch.bmm(hidden, wd)                         # [E_loc, C, H]

    y_slots = out_buf[torch.clamp(le, max=e_loc - 1),
                      torch.clamp(rk, max=cap - 1)]         # [T·k, H]
    y_slots = torch.where(owned[:, None], y_slots,
                          torch.zeros_like(y_slots))
    gv = TP.copy(gate_vals, "moe_gates")
    y = (y_slots.reshape(t, k, h) * gv.to(y_slots.dtype)[..., None]).sum(
        dim=1)
    y = TP.reduce(y.to(x.dtype), "moe_combine").reshape(b, s, h)
    if "shared" in p:
        y = y + L.mlp(p["shared"], x, cfg.activation, shared_width(cfg))
    return y, aux


def _ffn(p: Params, x: torch.Tensor, cfg):
    """The block's MoE FFN: expert-parallel under tensor parallelism; over
    a call whose tokens are split over the DP group
    (``distributed.tokens``), the reference's global form, or with
    ``cfg.moe_shard_map`` its per-shard form."""
    tp = TP.current()
    return _experts(p, x, cfg, None if tp is None else tp.mesh, tp,
                    TOK.current(), cfg.moe_shard_map)


# ---------------------------------------------------------------------------
# Blocks / model
# ---------------------------------------------------------------------------

def moe_block(p: Params, x: torch.Tensor, positions: torch.Tensor,
              cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    x = x + T._self_attention(p["attn"], T.norm(p["attn_norm"], x, cfg),
                              cfg, positions)[0]
    y, aux = _ffn(p["moe"], T.norm(p["mlp_norm"], x, cfg), cfg)
    return x + y, aux


def forward(p: Params, cfg, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] → (logits [B, S, V], summed aux loss).  Under
    Megatron-SP (``tp.sp_on``: a config with leading dense layers) the
    dense blocks run it and the residual is gathered whole before the
    MoE blocks."""
    sp = TP.sp_on(cfg, tokens.shape[1])
    x = T.embed(p, cfg, tokens, sp)
    positions = T.positions_of(tokens)
    for i in range(cfg.first_k_dense):
        x = T.block(L.layer_params(p["dense_layers"], i), x, positions, cfg,
                    sp)
    x = TP.sp_whole(x, sp)
    aux = torch.zeros((), device=tokens.device)
    for i in range(cfg.num_layers - cfg.first_k_dense):
        x, a = moe_block(L.layer_params(p["layers"], i), x, positions, cfg)
        aux = aux + a
    return T.logits_head(p, x, cfg), aux


def loss_fn(p: Params, cfg, batch, kernels=None) -> torch.Tensor:
    """Cross-entropy of ``batch`` plus the summed load-balancing aux loss
    of the MoE blocks; every block under :func:`layers.ckpt` (the dense
    ones under Megatron-SP as in :func:`forward`).  ``kernels`` is unused
    (no port kernel on this path)."""
    del kernels
    tokens = batch["tokens"]
    nd, nm = cfg.first_k_dense, cfg.num_layers - cfg.first_k_dense
    sp = TP.sp_on(cfg, tokens.shape[1])
    x = T.embed(p, cfg, tokens, sp)
    positions = T.positions_of(tokens)
    if nd:
        dense_body = L.ckpt(T.block, cfg)
        for lp in L.unstack(p["dense_layers"], nd):
            x = dense_body(lp, x, positions, cfg, sp)
    x = TP.sp_whole(x, sp)
    body = L.ckpt(moe_block, cfg)
    aux = torch.zeros((), device=tokens.device)
    for lp in L.unstack(p["layers"], nm):
        x, a = body(lp, x, positions, cfg)
        aux = aux + a
    return T.loss_head(p, x, cfg, batch["labels"]) + aux


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device=None) -> Params:
    """Zero KV cache: ``moe`` (and, with leading dense layers, ``dense``)
    K/V [L, batch, max_len, kvh, d]."""
    kvh, hd = T.kv_dims(cfg)
    nd, nm = cfg.first_k_dense, cfg.num_layers - cfg.first_k_dense
    dt = torch_dtype(cfg.dtype)

    def kv(n):
        shape = (n, batch, max_len, kvh, hd)
        return {"k": torch.zeros(shape, device=device, dtype=dt),
                "v": torch.zeros(shape, device=device, dtype=dt)}

    c = {"moe": kv(nm)}
    if nd:
        c["dense"] = kv(nd)
    return c


def prefill(p: Params, cfg, tokens: torch.Tensor,
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
    """Full-sequence forward that also emits the KV cache.  Returns
    (last-position logits [B, V], cache).  Under batch-1 sequence
    sharding (``distributed.seq``; the caller splits the tokens over the
    DP group, ``distributed.tokens``, too) ``tokens`` is the rank's block
    of the prompt, the cache the rank's block of its time axis and the
    logits the last rank's, as ``transformer.prefill``'s."""
    b, s = tokens.shape
    sp = TP.sp_on(cfg, s)
    x = T.embed(p, cfg, tokens, sp)
    positions = T.positions_of(tokens)
    seq = SEQ.current() is not None
    # sequence-sharded, each layer's rows are kept for seq_cache_rows;
    # otherwise written into the cache at once (a row block of a K/V
    # would keep the whole K/V alive)
    cache = None if seq else init_cache(cfg, b, max_len or s,
                                        device=tokens.device)
    rows = {"dense": ([], []), "moe": ([], [])}

    def attn(lp, x, name, i, sp=False):
        a, k, v = T._self_attention(lp["attn"], T.norm(lp["attn_norm"], x,
                                                       cfg, sp),
                                    cfg, positions, sp=sp)
        if seq:
            rows[name][0].append(k)
            rows[name][1].append(v)
        else:
            cache[name]["k"][i, :, :s] = k
            cache[name]["v"][i, :, :s] = v
        return x + a

    for i in range(cfg.first_k_dense):
        lp = L.layer_params(p["dense_layers"], i)
        x = attn(lp, x, "dense", i, sp)
        x = x + L.mlp(lp["mlp"], T.norm(lp["mlp_norm"], x, cfg, sp),
                      cfg.activation, cfg.d_ff, sp)
    x = TP.sp_whole(x, sp)
    for i in range(cfg.num_layers - cfg.first_k_dense):
        lp = L.layer_params(p["layers"], i)
        x = attn(lp, x, "moe", i)
        x = x + _ffn(lp["moe"], T.norm(lp["mlp_norm"], x, cfg), cfg)[0]
    if not seq:
        return T.logits_head(p, x[:, -1:, :], cfg)[:, 0], cache
    cache = {name: {n: T.seq_cache_rows(r, cfg, max_len, n)
                    for n, r in zip(("k", "v"), kv)}
             for name, kv in rows.items() if kv[0]}
    return T.logits_head(p, SEQ.from_last(x[:, -1:, :], "last_hidden"),
                         cfg)[:, 0], cache


def decode_step(p: Params, cfg, token: torch.Tensor, cache: Params,
                pos: torch.Tensor, live=None) -> Tuple[torch.Tensor, Params]:
    """One-token step: token [B], pos [B] → (logits [B, V], cache).  The
    cache is updated IN PLACE; a slot whose ``live`` (bool [B]) is False
    writes nothing, but its token still routes (and takes capacity)."""
    x = T.embed(p, cfg, token)[:, None, :]

    def attn(lp, x, c, i):
        return x + L.decode_attention(
            lp["attn"], T.norm(lp["attn_norm"], x, cfg),
            {"k": c["k"][i], "v": c["v"][i]}, pos, cfg, live)

    for i in range(cfg.first_k_dense):
        lp = L.layer_params(p["dense_layers"], i)
        x = attn(lp, x, cache["dense"], i)
        x = x + L.mlp(lp["mlp"], T.norm(lp["mlp_norm"], x, cfg),
                      cfg.activation, cfg.d_ff)
    for i in range(cfg.num_layers - cfg.first_k_dense):
        lp = L.layer_params(p["layers"], i)
        x = attn(lp, x, cache["moe"], i)
        x = x + _ffn(lp["moe"], T.norm(lp["mlp_norm"], x, cfg), cfg)[0]
    return T.logits_head(p, x, cfg)[:, 0], cache
