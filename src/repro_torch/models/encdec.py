"""Seamless-M4T-medium-style encoder-decoder backbone (the ``audio``
family).

Counterpart of ``repro.models.encdec``: a bidirectional transformer
encoder over STUBBED audio frame embeddings [B, M, H] (the conformer
frontend is replaced by precomputed frames, as in the reference), then
an autoregressive text decoder whose every block runs self-attention,
cross-attention over the encoder memory and the MLP.  Both stacks use
RoPE on self-attention; cross-attention has none.

Cache: ``self`` K/V [dec_layers, B, T, kvh, d] and ``cross`` K/V
[dec_layers, B, num_audio_frames, kvh, d], the latter written once at
prefill from the encoder memory and read by every decode step.

Under tensor parallelism (``distributed.tp.use(mesh)``) the encoder and
decoder self-attention run ``transformer``'s Megatron path, the
cross-attention ``layers.cross_attention``, every MLP is split over its
hidden width, and both caches hold the rank's block of kv heads (else
head_dim); the frames and the encoder memory are replicated.

The reference's encoder and decoder blocks are its own, not
``transformer.block``, so ``seq_parallel`` changes nothing here, in
either package.  A batch-1 prompt sharded over the DP group
(``distributed.seq``) runs its block through the decoder as the dense
family's; the frames are a second sequence, split where the group
divides their length, the encoder's self-attention over the rank's
frames reading every frame's keys (no mask) and the cross-attention
gathering the memory's K/V rows; decode merges each rank's cross
statistics over "data" as self-attention does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..distributed import seq as SEQ
from ..platform import torch_dtype
from . import layers as L
from . import transformer as T

Params = L.Params


def init(cfg, generator: torch.Generator, device=None) -> Params:
    """Random weights as :func:`transformer.init` draws them: ``enc``
    (``enc_layers`` blocks), ``enc_norm``, ``dec`` (``dec_layers``
    blocks, each with ``xattn_norm`` and ``xattn`` besides), the final
    norm and an untied head; biases (``use_bias``) start at zero."""
    dev = torch.device(device if device is not None else generator.device)
    dt = torch_dtype(cfg.dtype)
    d, nd = cfg.d_model, cfg.dec_layers
    normal = T.normal_drawer(generator, dev, dt)
    dec = T.init_blocks(cfg, nd, normal, dev)
    dec["xattn_norm"] = T.stacked_norm(nd, d, dev, dt, cfg.use_bias)
    dec["xattn"] = T.stacked_attention(cfg, nd, normal, dev, cfg.use_bias)
    return {"embed": {"w": normal((cfg.padded_vocab, d), d ** -0.5)},
            "enc": T.init_blocks(cfg, cfg.enc_layers, normal, dev),
            "enc_norm": T.final_norm(cfg, dev),
            "dec": dec,
            "final_norm": T.final_norm(cfg, dev),
            "lm_head": {"w": normal((d, cfg.padded_vocab), d ** -0.5)}}


def enc_block(lp: Params, x: torch.Tensor, positions: torch.Tensor,
              cfg, whole: bool = True) -> torch.Tensor:
    """One encoder block: bidirectional self-attention, then the MLP
    (``whole`` False: ``x`` is the rank's frames of a batch-1 memory
    split over the DP group, attending to every frame's keys)."""
    x = x + T._self_attention(lp["attn"], T.norm(lp["attn_norm"], x, cfg),
                              cfg, positions, causal=False, whole=whole)[0]
    return x + L.mlp(lp["mlp"], T.norm(lp["mlp_norm"], x, cfg),
                     cfg.activation, cfg.d_ff)


def encode(p: Params, cfg, frames: torch.Tensor,
           train: bool = False) -> Tuple[torch.Tensor, bool]:
    """frames [B, M, H] → (encoder memory [B, M, H], whether it is the
    rank's rows): bidirectional self-attention, then the encoder's final
    norm.  Under batch-1 sequence sharding the frames come whole and the
    rank encodes its block of them where the group divides M
    (``seq.memory``).  ``train``: each block under :func:`layers.ckpt`,
    over one unbind of the stack."""
    x, split = SEQ.memory(frames)
    b, m, _ = x.shape
    positions = (SEQ.offset(m) if split else 0) + torch.arange(
        m, device=frames.device).expand(b, m)
    if train:
        body = L.ckpt(enc_block, cfg)
        for lp in L.unstack(p["enc"], cfg.enc_layers):
            x = body(lp, x, positions, cfg, not split)
    else:
        for i in range(cfg.enc_layers):
            x = enc_block(L.layer_params(p["enc"], i), x, positions, cfg,
                          not split)
    return T.norm(p["enc_norm"], x, cfg), split


def dec_block(lp: Params, x: torch.Tensor, memory: torch.Tensor,
              positions: torch.Tensor, cfg, split: bool = False
              ) -> torch.Tensor:
    """One decoder block (the training form): causal self-attention,
    cross-attention over K/V it projects from ``memory`` (``split``: the
    rank's rows, their K/V gathered whole), the MLP."""
    x = x + T._self_attention(lp["attn"], T.norm(lp["attn_norm"], x, cfg),
                              cfg, positions)[0]
    kv = SEQ.gather_memory(L.memory_kv(lp["xattn"], memory, cfg), split)
    x = x + L.cross_attention(lp["xattn"], T.norm(lp["xattn_norm"], x, cfg),
                              kv, cfg)
    return x + L.mlp(lp["mlp"], T.norm(lp["mlp_norm"], x, cfg),
                     cfg.activation, cfg.d_ff)


def loss_fn(p: Params, cfg, batch, kernels=None) -> torch.Tensor:
    """Cross-entropy of ``batch`` (``frames`` [B, M, H], ``tokens``,
    ``labels``); every encoder and decoder block under
    :func:`layers.ckpt`.  The frames are cast to the weights' dtype (see
    ``vlm.loss_fn``).  ``kernels`` is unused."""
    del kernels
    tokens = batch["tokens"]
    memory, split = encode(p, cfg, batch["frames"].to(
        p["embed"]["w"].dtype), train=True)
    x = T.embed(p, cfg, tokens)
    positions = T.positions_of(tokens)
    body = L.ckpt(dec_block, cfg)
    for lp in L.unstack(p["dec"], cfg.dec_layers):
        x = body(lp, x, memory, positions, cfg, split)
    return T.loss_head(p, x, cfg, batch["labels"])


def _decode_stack(p: Params, cfg, tokens, memory, cache, max_len=None):
    """The decoder over ``tokens`` [B, S] against ``encode``'s (memory,
    split); writes the self and cross K/V into ``cache`` when given →
    (hidden, cache).  Under batch-1 sequence sharding the cache's self
    K/V become the rank's blocks of ``max_len`` rows and its cross K/V
    the rank's memory rows."""
    memory, split = memory
    b, s = tokens.shape
    seq = cache is not None and SEQ.current() is not None
    x = T.embed(p, cfg, tokens)
    positions = T.positions_of(tokens)
    rows = ([], [])
    for i in range(cfg.dec_layers):
        lp = L.layer_params(p["dec"], i)
        a, k, v = T._self_attention(lp["attn"],
                                    T.norm(lp["attn_norm"], x, cfg), cfg,
                                    positions)
        x = x + a
        kv = L.memory_kv(lp["xattn"], memory, cfg)
        if seq:
            rows[0].append(k)
            rows[1].append(v)
        elif cache is not None:
            cache["self"]["k"][i, :, :s] = k
            cache["self"]["v"][i, :, :s] = v
        if cache is not None:
            cache["cross"]["k"][i], cache["cross"]["v"][i] = \
                L.cross_cache(kv, cfg)
        x = x + L.cross_attention(lp["xattn"],
                                  T.norm(lp["xattn_norm"], x, cfg),
                                  SEQ.gather_memory(kv, split), cfg)
        x = x + L.mlp(lp["mlp"], T.norm(lp["mlp_norm"], x, cfg),
                      cfg.activation, cfg.d_ff)
    if seq:
        for name, r in zip(("k", "v"), rows):
            cache["self"][name] = T.seq_cache_rows(r, cfg, max_len, name)
    return x, cache


def forward(p: Params, cfg, frames: torch.Tensor,
            tokens: torch.Tensor) -> torch.Tensor:
    """frames [B, M, H]; decoder tokens [B, S] → logits [B, S, V]."""
    x, _ = _decode_stack(p, cfg, tokens, encode(p, cfg, frames), None)
    return T.logits_head(p, x, cfg)


def prefill_inputs(cfg, tokens, make, mem_len=None):
    """``ModelFns.prefill_inputs``: encoder frames FIRST, then tokens.
    ``mem_len`` None (the serving engine) is ``num_audio_frames``, the
    cross cache's contract, not the prompt length."""
    m = cfg.num_audio_frames if mem_len is None else mem_len
    return (make((tokens.shape[0], m, cfg.d_model), torch_dtype(cfg.dtype)),
            tokens)


def batch_extras(cfg, b, s, make):
    """``ModelFns.batch_extras``: training batches carry audio frames."""
    return {"frames": make((b, s, cfg.d_model), torch_dtype(cfg.dtype))}


def init_cache(cfg, batch: int, max_len: int, device=None,
               mem_len: Optional[int] = None) -> Params:
    """Zero caches (under tensor parallelism, the rank's blocks); the
    cross K/V hold ``mem_len`` encoder rows (``num_audio_frames`` by
    default, the serving contract)."""
    kvh, hd = T.kv_dims(cfg)
    nd = cfg.dec_layers
    m = cfg.num_audio_frames if mem_len is None else mem_len
    dt = torch_dtype(cfg.dtype)
    z = lambda *shape: torch.zeros(shape, device=device, dtype=dt)
    return {"self": {"k": z(nd, batch, max_len, kvh, hd),
                     "v": z(nd, batch, max_len, kvh, hd)},
            "cross": {"k": z(nd, batch, m, kvh, hd),
                      "v": z(nd, batch, m, kvh, hd)}}


def prefill(p: Params, cfg, frames: torch.Tensor, tokens: torch.Tensor,
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
    """Encode the frames, run the decoder over the prompt, emit both
    caches → (last-position logits [B, V], cache); the cross cache holds
    as many rows as ``frames`` (as the reference's)."""
    b, s = tokens.shape
    seq = SEQ.current() is not None
    memory = encode(p, cfg, frames)
    # sequence-sharded, the self K/V leaves are replaced by their blocks
    cache = init_cache(cfg, b, 1 if seq else max_len or s,
                       device=tokens.device, mem_len=memory[0].shape[1])
    x, cache = _decode_stack(p, cfg, tokens, memory, cache, max_len)
    if seq:
        x = SEQ.from_last(x[:, -1:, :], "last_hidden")
    return T.logits_head(p, x[:, -1:], cfg)[:, 0], cache


def decode_step(p: Params, cfg, token: torch.Tensor, cache: Params,
                pos: torch.Tensor, live=None) -> Tuple[torch.Tensor, Params]:
    """One token per slot: self K/V written IN PLACE (a slot whose
    ``live`` is False writes nothing), the cross K/V only read."""
    x = T.embed(p, cfg, token)[:, None, :]
    split = SEQ.current() is not None and SEQ.cached_memory(
        cache["cross"]["k"].shape[2], cfg.num_audio_frames)
    for i in range(cfg.dec_layers):
        lp = L.layer_params(p["dec"], i)
        c = {"k": cache["self"]["k"][i], "v": cache["self"]["v"][i]}
        x = x + L.decode_attention(lp["attn"], T.norm(lp["attn_norm"], x, cfg),
                                   c, pos, cfg, live)
        x = x + L.cross_attention(
            lp["xattn"], T.norm(lp["xattn_norm"], x, cfg),
            (cache["cross"]["k"][i], cache["cross"]["v"][i]), cfg,
            cached=True, split=split)
        x = x + L.mlp(lp["mlp"], T.norm(lp["mlp_norm"], x, cfg),
                      cfg.activation, cfg.d_ff)
    return T.logits_head(p, x, cfg)[:, 0], cache
