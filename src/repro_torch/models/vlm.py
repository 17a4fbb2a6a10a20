"""Llama-3.2-Vision-style VLM backbone: a dense decoder with a tanh-gated
cross-attention block every ``cross_attn_period`` layers.

Counterpart of ``repro.models.vlm``.  The vision frontend is a stub, as
in the reference: prefill takes precomputed image embeddings [B, n_img,
H] (already projected to d_model).  Layout: ``groups`` of (period − 1)
self-attention blocks and one cross block (40 layers at period 5: 8 × (4
self + 1 cross)); the self blocks are stacked [groups, spg, …], the
cross blocks [groups, …], each with two float32 gates (scalars per
group) that scale the cross block's attention and MLP by their tanh.

Cache: ``self`` K/V [groups, spg, B, T, kvh, d] (the slot axis at 2) and
``cross`` K/V [groups, B, n_img, kvh, d], written once at prefill from
the image embeddings and read by every decode step.

Under tensor parallelism (``distributed.tp.use(mesh)``) the self blocks
run ``transformer``'s Megatron path, the cross blocks
``layers.cross_attention`` (the rank's query heads, ``wo``
row-parallel), every MLP is split over its hidden width, and both
caches hold the rank's block of kv heads (else head_dim); the image
embeddings and the gates are replicated.

Megatron-SP (``cfg.seq_parallel``) runs in the self blocks, as the
reference's ``transformer.block`` does; the residual is gathered whole
around each cross block (``tp.sp_whole``/``sp_split``).  A batch-1
prompt sharded over the DP group (``distributed.seq``) runs its block
through the self blocks as the dense family's; the image embeddings are
a second sequence, split where the group divides their length, and the
cross-attention gathers their K/V rows; decode merges each rank's cross
statistics over "data" as self-attention does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..distributed import seq as SEQ
from ..distributed import tp as TP
from ..platform import torch_dtype
from . import layers as L
from . import transformer as T

Params = L.Params


def layout(cfg) -> Tuple[int, int]:
    """(groups, self blocks per group)."""
    per = cfg.cross_attn_period
    groups = cfg.num_layers // per
    if groups * per != cfg.num_layers:
        raise ValueError(f"vlm layout: {cfg.num_layers} layers do not tile "
                         f"by cross_attn_period {per}")
    return groups, per - 1


def _regroup(tree, groups: int, spg: int):
    """Leading axis groups·spg → [groups, spg] on every leaf (views)."""
    if isinstance(tree, dict):
        return {k: _regroup(v, groups, spg) for k, v in tree.items()}
    return tree.reshape((groups, spg) + tuple(tree.shape[1:]))


def init(cfg, generator: torch.Generator, device=None) -> Params:
    """Random weights as :func:`transformer.init` draws them; the cross
    blocks' norms, projections and MLP carry no bias, and their gates
    start at 0 (tanh(0) = 0: the cross path is closed), as in the
    reference."""
    dev = torch.device(device if device is not None else generator.device)
    dt = torch_dtype(cfg.dtype)
    d = cfg.d_model
    groups, spg = layout(cfg)
    normal = T.normal_drawer(generator, dev, dt)
    zeros = torch.zeros(groups, device=dev, dtype=torch.float32)
    return {
        "embed": {"w": normal((cfg.padded_vocab, d), d ** -0.5)},
        "self": _regroup(T.init_blocks(cfg, groups * spg, normal, dev),
                         groups, spg),
        "cross": {
            "attn_norm": T.stacked_norm(groups, d, dev, dt),
            "xattn": T.stacked_attention(cfg, groups, normal, dev, False),
            "gate_attn": zeros,
            "mlp_norm": T.stacked_norm(groups, d, dev, dt),
            "mlp": T.stacked_mlp(cfg, groups, normal, dev, False),
            "gate_mlp": zeros.clone()},
        "final_norm": T.final_norm(cfg, dev),
        "lm_head": {"w": normal((d, cfg.padded_vocab), d ** -0.5)},
    }


def cross_block(cp: Params, x: torch.Tensor, kv, cfg,
                cached: bool = False, split: bool = False) -> torch.Tensor:
    """x + tanh(g_a)·xattn(rmsnorm(x), kv), then + tanh(g_m)·mlp(·);
    ``kv`` is ``layers.memory_kv``'s (whole: gathered where the memory is
    split), or with ``cached`` the cross cache's (``split``: the rank's
    rows over "data", decode)."""
    h = L.cross_attention(cp["xattn"], L.rmsnorm(cp["attn_norm"], x,
                                                 cfg.norm_eps), kv, cfg,
                          cached, split)
    x = x + torch.tanh(cp["gate_attn"]).to(x.dtype) * h
    m = L.mlp(cp["mlp"], L.rmsnorm(cp["mlp_norm"], x, cfg.norm_eps),
              cfg.activation, cfg.d_ff)
    return x + torch.tanh(cp["gate_mlp"]).to(x.dtype) * m


def _self_block(lp: Params, x, cfg, positions, sp: int = 0):
    """One self block → (x, its RoPE'd K and V)."""
    a, k, v = T._self_attention(lp["attn"], T.norm(lp["attn_norm"], x, cfg,
                                                   sp),
                                cfg, positions, sp=sp)
    x = x + a
    return x + L.mlp(lp["mlp"], T.norm(lp["mlp_norm"], x, cfg, sp),
                     cfg.activation, cfg.d_ff, sp), k, v


def forward(p: Params, cfg, tokens: torch.Tensor,
            image_embeds: torch.Tensor) -> torch.Tensor:
    """tokens [B, S]; image_embeds [B, n_img, H] → logits [B, S, V]."""
    return T.logits_head(p, _run(p, cfg, tokens, image_embeds, None)[0],
                         cfg)


def _cross_from_embeds(cp: Params, x, image_embeds, cfg, split: bool):
    """A cross block that projects its own K/V from the image embeddings
    (the reference's ``cross_block``: the training form); ``split``: the
    embeddings are the rank's rows, their K/V gathered whole."""
    kv = SEQ.gather_memory(L.memory_kv(cp["xattn"], image_embeds, cfg),
                           split)
    return cross_block(cp, x, kv, cfg)


def loss_fn(p: Params, cfg, batch, kernels=None) -> torch.Tensor:
    """Cross-entropy of ``batch`` (``tokens``, ``labels``,
    ``image_embeds`` [B, n_img, H]); every self and cross block under
    :func:`layers.ckpt`.  The embeddings are cast to the weights' dtype:
    the reference promotes bf16 weights against float32 embeddings to
    float32, and the port's matmuls take one dtype (the same values in
    float32).  Under batch-1 sequence sharding the embeddings come whole
    and the rank keeps its rows where the group divides them
    (``seq.memory``).  ``kernels`` is unused."""
    del kernels
    tokens = batch["tokens"]
    groups, spg = layout(cfg)
    img, split = SEQ.memory(batch["image_embeds"].to(
        p["embed"]["w"].dtype))
    sp = TP.sp_on(cfg, tokens.shape[1])
    x = T.embed(p, cfg, tokens, sp)
    positions = T.positions_of(tokens)
    sblock = L.ckpt(T.block, cfg)
    xblock = L.ckpt(_cross_from_embeds, cfg)
    crosses = L.unstack(p["cross"], groups)
    for g, group in enumerate(L.unstack2(p["self"], groups, spg)):
        x = TP.sp_split(x, sp if g else 0)
        for lp in group:
            x = sblock(lp, x, positions, cfg, sp)
        x = TP.sp_whole(x, sp)
        x = xblock(crosses[g], x, img, cfg, split)
    return T.loss_head(p, x, cfg, batch["labels"])


def prefill_inputs(cfg, tokens, make, mem_len=None):
    """``ModelFns.prefill_inputs``: tokens plus the image-embedding block
    (``num_image_tokens`` rows, the cross cache's contract)."""
    return (tokens, make((tokens.shape[0], cfg.num_image_tokens,
                          cfg.d_model), torch_dtype(cfg.dtype)))


def batch_extras(cfg, b, s, make):
    """``ModelFns.batch_extras``: training batches carry image
    embeddings."""
    return {"image_embeds": make((b, cfg.num_image_tokens, cfg.d_model),
                                 torch_dtype(cfg.dtype))}


def init_cache(cfg, batch: int, max_len: int, device=None,
               mem_len: Optional[int] = None) -> Params:
    """Zero caches (under tensor parallelism, the rank's blocks); the
    cross K/V hold ``mem_len`` rows (``num_image_tokens`` by default,
    the serving contract)."""
    groups, spg = layout(cfg)
    kvh, hd = T.kv_dims(cfg)
    dt = torch_dtype(cfg.dtype)
    z = lambda *shape: torch.zeros(shape, device=device, dtype=dt)
    n_img = cfg.num_image_tokens if mem_len is None else mem_len
    return {"self": {"k": z(groups, spg, batch, max_len, kvh, hd),
                     "v": z(groups, spg, batch, max_len, kvh, hd)},
            "cross": {"k": z(groups, batch, n_img, kvh, hd),
                      "v": z(groups, batch, n_img, kvh, hd)}}


def _run(p: Params, cfg, tokens, image_embeds, cache, max_len=None):
    """The blocks over ``tokens``; writes the self and cross K/V into
    ``cache`` when given.  Returns (final hidden [B, S, H], cache).
    Under Megatron-SP the self blocks run it, the residual gathered
    whole around each cross block; under batch-1 sequence sharding the
    rank runs its block of the prompt and of the image embeddings
    (whole where the group does not divide them), and the cache's self
    K/V become the rank's blocks of ``max_len`` rows
    (``transformer.seq_cache_rows``)."""
    b, s = tokens.shape
    groups, spg = layout(cfg)
    seq = cache is not None and SEQ.current() is not None
    img, split = SEQ.memory(image_embeds)
    sp = TP.sp_on(cfg, s)
    x = T.embed(p, cfg, tokens, sp)
    positions = T.positions_of(tokens)
    rows = ([], [])
    for g in range(groups):
        gp = L.layer_params(p["self"], g)
        x = TP.sp_split(x, sp if g else 0)
        for j in range(spg):
            x, k, v = _self_block(L.layer_params(gp, j), x, cfg, positions,
                                  sp)
            if seq:
                rows[0].append(k)
                rows[1].append(v)
            elif cache is not None:
                cache["self"]["k"][g, j, :, :s] = k
                cache["self"]["v"][g, j, :, :s] = v
        x = TP.sp_whole(x, sp)
        cp = L.layer_params(p["cross"], g)
        kv = L.memory_kv(cp["xattn"], img, cfg)
        if cache is not None:
            cache["cross"]["k"][g], cache["cross"]["v"][g] = \
                L.cross_cache(kv, cfg)
        x = cross_block(cp, x, SEQ.gather_memory(kv, split), cfg)
    if seq:
        for name, r in zip(("k", "v"), rows):
            r = T.seq_cache_rows(r, cfg, max_len, name)
            cache["self"][name] = r.reshape((groups, spg)
                                            + tuple(r.shape[1:]))
    return x, cache


def prefill(p: Params, cfg, tokens: torch.Tensor, image_embeds: torch.Tensor,
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
    """→ (last-position logits [B, V], cache with ``max_len`` self rows;
    under batch-1 sequence sharding the last rank's logits and the
    rank's blocks of the cache's time axes)."""
    b, s = tokens.shape
    seq = SEQ.current() is not None
    # sequence-sharded, the self K/V leaves are replaced by their blocks
    cache = init_cache(cfg, b, 1 if seq else max_len or s,
                       device=tokens.device,
                       mem_len=SEQ.memory(image_embeds)[0].shape[1])
    x, cache = _run(p, cfg, tokens, image_embeds, cache, max_len)
    if seq:
        x = SEQ.from_last(x[:, -1:, :], "last_hidden")
    return T.logits_head(p, x[:, -1:], cfg)[:, 0], cache


def decode_step(p: Params, cfg, token: torch.Tensor, cache: Params,
                pos: torch.Tensor, live=None) -> Tuple[torch.Tensor, Params]:
    """One token per slot: the self caches are written IN PLACE (a slot
    whose ``live`` is False writes nothing), the cross caches only
    read."""
    groups, spg = layout(cfg)
    x = T.embed(p, cfg, token)[:, None, :]
    split = SEQ.current() is not None and SEQ.cached_memory(
        cache["cross"]["k"].shape[2], cfg.num_image_tokens)
    for g in range(groups):
        sp = L.layer_params(p["self"], g)
        for j in range(spg):
            lp = L.layer_params(sp, j)
            c = {"k": cache["self"]["k"][g, j], "v": cache["self"]["v"][g, j]}
            x = x + L.decode_attention(lp["attn"],
                                       T.norm(lp["attn_norm"], x, cfg), c,
                                       pos, cfg, live)
            x = x + L.mlp(lp["mlp"], T.norm(lp["mlp_norm"], x, cfg),
                          cfg.activation, cfg.d_ff)
        x = cross_block(L.layer_params(p["cross"], g), x,
                        (cache["cross"]["k"][g], cache["cross"]["v"][g]), cfg,
                        cached=True, split=split)
    return T.logits_head(p, x, cfg)[:, 0], cache
