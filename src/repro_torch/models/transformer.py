"""Dense decoder-only transformer (llama2 / deepseek / starcoder2 /
gemma / granite).

Counterpart of ``repro.models.transformer``: the same parameter tree
(layers stacked on a leading L axis), prefill that also emits the KV
cache, and one-token decode.  The layer loop is a Python loop over views
of the stacked weights (the JAX version scans).  The config's variant
fields act where the reference's do: ``use_bias`` (biased linears,
layernorm with a bias in place of rmsnorm), ``gated_mlp`` and
``activation`` (SwiGLU, GeGLU or an ungated GELU MLP), and
``tie_embeddings`` (no ``lm_head``: the head is the embedding table, and
embeddings are scaled by √d_model rounded to the config's dtype).

Megatron-SP (``cfg.seq_parallel`` on a "model" axis larger than 1):
training, the forward and prefill keep the residual stream sequence
sharded between the TP products (``distributed.tp.sp_on``).  A batch-1
sequence sharded over the DP group (``distributed.seq``) attends to the
keys gathered from every rank at global positions; its prefill emits
the rank's block of the cache's time axis.

Under tensor parallelism (``distributed.tp.use(mesh)``; parameters are
the rank's ``params_sharding`` blocks) the embedding and the head are
vocab-parallel when M divides the padded vocab (a lookup over the
rank's rows, all-reduced; the rank's logit columns, all-gathered for
serving and reduced by ``tp.cross_entropy`` for the loss), the blocks
run ``layers``' Megatron layout, and a decode cache holds the rank's
block of k/v (``cache_pspec``: kv heads over "model", else head_dim).
"""
from __future__ import annotations

import itertools
from typing import Optional, Tuple

import torch

from ..distributed import seq as SEQ
from ..distributed import tp as TP
from ..platform import torch_dtype
from . import layers as L

Params = L.Params


# ---------------------------------------------------------------------------
# Init: the distributions of repro.models.layers (dense/embed/norm init)
# ---------------------------------------------------------------------------

def normal_drawer(generator: torch.Generator, device, dtype):
    """``normal(shape, std)``: N(0, std²) drawn in float32 on ``device``
    from ``generator`` and stored in ``dtype``."""
    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * std).to(dtype)
    return normal


def drawn_slices(lead: tuple, shape: tuple, std: float, normal, device,
                 dt) -> torch.Tensor:
    """A [*lead, *shape] tensor whose [*shape] slices are drawn one at a
    time by ``normal`` in row-major order of ``lead``; on the ``meta``
    device nothing is drawn (an abstract tree of a 1T-parameter model
    takes no time)."""
    w = torch.empty(tuple(lead) + tuple(shape), device=device, dtype=dt)
    if w.device.type != "meta":
        for idx in itertools.product(*map(range, lead)):
            w[idx] = normal(tuple(shape), std)
    return w


def stacked_dense(n: int, in_dim: int, out_dim: int, normal, device, dt,
                  bias: bool = False) -> Params:
    """``n`` projections [in, out] stacked on a leading axis: N(0, 1/in)
    one matrix at a time, and zero biases [n, out] when ``bias``."""
    p = {"w": drawn_slices((n,), (in_dim, out_dim), in_dim ** -0.5, normal,
                           device, dt)}
    if bias:
        p["b"] = torch.zeros(n, out_dim, device=device, dtype=dt)
    return p


def stacked_norm(n: int, d: int, device, dt, bias: bool = False) -> Params:
    """``n`` norms: ones for the scales, zeros for the biases."""
    p = {"scale": torch.ones(n, d, device=device, dtype=dt)}
    if bias:
        p["bias"] = torch.zeros(n, d, device=device, dtype=dt)
    return p


def stacked_attention(cfg, n: int, normal, device, bias: bool) -> Params:
    dt = torch_dtype(cfg.dtype)
    d = cfg.d_model
    nh, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    def lin(i, o):
        return stacked_dense(n, i, o, normal, device, dt, bias)
    return {"wq": lin(d, nh * hd), "wk": lin(d, kvh * hd),
            "wv": lin(d, kvh * hd), "wo": lin(nh * hd, d)}


def stacked_mlp(cfg, n: int, normal, device, bias: bool) -> Params:
    dt = torch_dtype(cfg.dtype)
    d, f = cfg.d_model, cfg.d_ff

    def lin(i, o):
        return stacked_dense(n, i, o, normal, device, dt, bias)
    p = {"up": lin(d, f), "down": lin(f, d)}
    if cfg.gated_mlp:
        p["gate"] = lin(d, f)
    return p


def init_blocks(cfg, n: int, normal, device) -> Params:
    """``n`` dense blocks stacked on a leading axis: N(0, 1/in) for the
    projections, ones for norm scales, zeros for biases (``use_bias``);
    no ``gate`` when the MLP is ungated."""
    dt, bias = torch_dtype(cfg.dtype), cfg.use_bias
    return {
        "attn_norm": stacked_norm(n, cfg.d_model, device, dt, bias),
        "attn": stacked_attention(cfg, n, normal, device, bias),
        "mlp_norm": stacked_norm(n, cfg.d_model, device, dt, bias),
        "mlp": stacked_mlp(cfg, n, normal, device, bias),
    }


def init(cfg, generator: torch.Generator, device=None) -> Params:
    """Random weights on ``device`` from ``generator``: N(0, 1/in) for
    projections, N(0, 1/d_model) for the embedding, ones for norm scales
    and zeros for biases (the reference's distributions); no ``lm_head``
    when the embeddings are tied.  Each layer's slice is drawn in float32
    and stored in ``cfg.dtype``, so a full-width model never holds more
    than one float32 matrix."""
    dev = torch.device(device if device is not None else generator.device)
    dt = torch_dtype(cfg.dtype)
    d = cfg.d_model
    normal = normal_drawer(generator, dev, dt)
    p = {"embed": {"w": normal((cfg.padded_vocab, d), d ** -0.5)},
         "layers": init_blocks(cfg, cfg.num_layers, normal, dev),
         "final_norm": final_norm(cfg, dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": normal((d, cfg.padded_vocab), d ** -0.5)}
    return p


def final_norm(cfg, device) -> Params:
    """The final norm's parameters (a bias with ``use_bias``)."""
    return L.layer_params(stacked_norm(1, cfg.d_model, device,
                                       torch_dtype(cfg.dtype),
                                       cfg.use_bias), 0)


def param_bytes(p) -> int:
    if isinstance(p, dict):
        return sum(param_bytes(v) for v in p.values())
    return p.numel() * p.element_size()


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------

def norm(p: Params, x: torch.Tensor, cfg, sp: int = 0) -> torch.Tensor:
    """layernorm with ``use_bias`` (starcoder2, seamless), else rmsnorm
    (under Megatron-SP on the rank's rows: its parameters pass
    ``tp.sp_rep``)."""
    if sp:
        p = {k: TP.sp_rep(v, sp) for k, v in p.items()}
    if cfg.use_bias:
        return L.layernorm(p, x, cfg.norm_eps)
    return L.rmsnorm(p, x, cfg.norm_eps)


def embed(p: Params, cfg, tokens: torch.Tensor, sp: int = 0
          ) -> torch.Tensor:
    """Embedding rows, times √d_model rounded to the config's dtype when
    the embeddings are tied (the reference multiplies by
    ``jnp.asarray(√d, dtype)``); under Megatron-SP the rank's block of
    the sequence."""
    if vocab_sharded(cfg):
        x = TP.embed(p["embed"]["w"], tokens, sp)
    else:
        x = TP.sp_split(p["embed"]["w"][tokens], sp)
    if cfg.tie_embeddings:
        x = x * L._const(cfg.d_model ** 0.5, x)
    return x


def vocab_sharded(cfg) -> bool:
    """Whether the embedding and head run vocab-parallel (under tensor
    parallelism, when M divides the padded vocab: the rule's condition)."""
    return TP.width_sharded(cfg.padded_vocab)


def logits_head(p: Params, x: torch.Tensor, cfg,
                whole: bool = True, sp: int = 0) -> torch.Tensor:
    """Final norm, then the head: ``lm_head``, or the embedding table
    [V, H] itself when tied (``einsum("...h,vh->...v")``).  Vocab-parallel,
    the rank's columns, all-gathered unless ``whole`` is False; under
    Megatron-SP ``x`` is the rank's block of the sequence, the logits
    every position's."""
    h = norm(p["final_norm"], x, cfg, sp)
    sharded = vocab_sharded(cfg)
    h = TP.sp_in(h, sp) if sharded else TP.sp_whole(h, sp)
    if cfg.tie_embeddings:
        logits = h @ p["embed"]["w"].t()
    else:
        logits = L.dense(p["lm_head"], h)
    if cfg.padded_vocab != cfg.vocab:          # mask the padding tail
        v_l = logits.shape[-1]
        lo = TP.current().rank * v_l if sharded else 0
        iota = torch.arange(lo, lo + v_l, device=logits.device)
        logits = torch.where(iota < cfg.vocab, logits,
                             torch.full_like(logits, -1e30))
    return TP.gather(logits, -1, "logits") if sharded and whole else logits


def _self_attention(lp: Params, h: torch.Tensor, cfg,
                    positions: torch.Tensor, causal: bool = True,
                    sp: int = 0, whole: bool = False):
    """Self-attention of one block (causal unless asked otherwise, as an
    encoder's is); also returns its RoPE'd K and V [B, S, kvh, d] (the
    prefill cache rows; under tensor parallelism the rank's cache block
    of them).  ``positions`` are the queries' (global: a batch-1
    sequence sharded over the DP group, ``distributed.seq``, attends to
    the keys gathered from every rank, unless ``whole`` says this
    sequence is whole on every rank: an encoder memory the group does
    not divide)."""
    q, k, v, lay = L.qkv(lp, h, cfg, positions, sp)
    kk, vv = TP.my_heads(k, lay), TP.my_heads(v, lay)
    kpos = None
    if SEQ.current() is not None and not whole:
        kk, vv = (SEQ.gather_time(kk, 1, "k_rows"),
                  SEQ.gather_time(vv, 1, "v_rows"))
        kpos = torch.arange(kk.shape[1], device=h.device).expand(
            h.shape[0], -1)
    out = L.attend(q, kk, vv, positions, causal=causal, out_dtype=h.dtype,
                   k_positions=kpos)
    return (L.o_proj(lp, out, cfg, sp), TP.cache_block(k, lay),
            TP.cache_block(v, lay))


def block(p: Params, x: torch.Tensor, positions: torch.Tensor,
          cfg, sp: int = 0) -> torch.Tensor:
    """One dense block: x [B, S, H] → x + attn(norm(x)) + mlp(norm(·));
    under Megatron-SP (``sp``) x is the rank's block of the sequence and
    ``positions`` the whole sequence's."""
    x = x + _self_attention(p["attn"], norm(p["attn_norm"], x, cfg, sp),
                            cfg, positions, sp=sp)[0]
    return x + L.mlp(p["mlp"], norm(p["mlp_norm"], x, cfg, sp),
                     cfg.activation, cfg.d_ff, sp)


def positions_of(tokens: torch.Tensor) -> torch.Tensor:
    """The global positions [B, S] of ``tokens`` (offset by the rank's
    block under batch-1 sequence sharding)."""
    b, s = tokens.shape
    return (SEQ.offset(s) + torch.arange(s, device=tokens.device)).expand(
        b, s)


def forward(p: Params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, S] → logits [B, S, V] (the padded vocab tail masked)."""
    sp = TP.sp_on(cfg, tokens.shape[1])
    x = embed(p, cfg, tokens, sp)
    positions = positions_of(tokens)
    for i in range(cfg.num_layers):
        x = block(L.layer_params(p["layers"], i), x, positions, cfg, sp)
    return logits_head(p, x, cfg, sp=sp)


def loss_fn(p: Params, cfg, batch, kernels=None) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``tokens`` [B, S],
    ``labels`` [B, S], −1 ignored), each block under :func:`layers.ckpt`
    (the reference's ``loss_fn``).  ``kernels`` is unused: no kernel of
    the port is on the dense training path."""
    del kernels
    tokens = batch["tokens"]
    sp = TP.sp_on(cfg, tokens.shape[1])
    x = embed(p, cfg, tokens, sp)
    positions = positions_of(tokens)
    body = L.ckpt(block, cfg)
    for lp in L.unstack(p["layers"], cfg.num_layers):
        x = body(lp, x, positions, cfg, sp)
    return loss_head(p, x, cfg, batch["labels"], sp)


def loss_head(p: Params, x: torch.Tensor, cfg, labels: torch.Tensor,
              sp: int = 0) -> torch.Tensor:
    """The head and the mean cross-entropy of the final hidden ``x``
    (vocab-parallel: over the rank's logit columns; under Megatron-SP
    ``x`` is the rank's rows, ``labels`` every position's)."""
    if vocab_sharded(cfg):
        return TP.cross_entropy(logits_head(p, x, cfg, whole=False, sp=sp),
                                labels)
    return L.cross_entropy(logits_head(p, x, cfg, sp=sp), labels)


def forward_layers(p: Params, cfg, tokens: torch.Tensor):
    """Run every block over ``tokens`` [B, S] → (final hidden [B, S, H],
    per-layer K list, per-layer V list).  Under Megatron-SP the final
    hidden is gathered whole (the K/V rows are every position's)."""
    sp = TP.sp_on(cfg, tokens.shape[1])
    x = embed(p, cfg, tokens, sp)
    positions = positions_of(tokens)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = L.layer_params(p["layers"], i)
        a, k, v = _self_attention(lp["attn"],
                                  norm(lp["attn_norm"], x, cfg, sp), cfg,
                                  positions, sp=sp)
        x = x + a
        x = x + L.mlp(lp["mlp"], norm(lp["mlp_norm"], x, cfg, sp),
                      cfg.activation, cfg.d_ff, sp)
        ks.append(k)
        vs.append(v)
    if sp:
        x = TP.gather(x, 1, "sp_hidden").narrow(1, 0, sp)
    return x, ks, vs


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def kv_dims(cfg) -> Tuple[int, int]:
    """(kv heads, head_dim) of a K/V cache leaf on this rank: the whole
    without tensor parallelism, else the rank's block (``cache_pspec``)."""
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    dim = TP.layout(cfg).cache
    if dim == -2:
        return kvh // TP.current().size, hd
    if dim == -1:
        return kvh, hd // TP.current().size
    return kvh, hd


def init_cache(cfg, batch: int, max_len: int, device=None) -> Params:
    shape = (cfg.num_layers, batch, max_len) + kv_dims(cfg)
    dt = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, device=device, dtype=dt),
            "v": torch.zeros(shape, device=device, dtype=dt)}


def prefill(p: Params, cfg, tokens: torch.Tensor,
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
    """Full-sequence forward that also emits the KV cache.
    Returns (last-position logits [B, V], cache [L, B, T, kvh, d]).
    Under batch-1 sequence sharding ``tokens`` is the rank's block of
    the prompt, the cache the rank's block of T = ``max_len`` (default:
    the whole prompt) rows, and the logits the last rank's."""
    b, s = tokens.shape
    x, ks, vs = forward_layers(p, cfg, tokens)
    if SEQ.current() is not None:
        cache = {n: seq_cache_rows(rows, cfg, max_len, n)
                 for n, rows in (("k", ks), ("v", vs))}
        return logits_head(p, SEQ.from_last(x[:, -1:, :], "last_hidden"),
                           cfg)[:, 0], cache
    t = max_len or s
    cache = init_cache(cfg, b, t, device=tokens.device)
    cache["k"][:, :, :s] = torch.stack(ks)
    cache["v"][:, :, :s] = torch.stack(vs)
    return logits_head(p, x[:, -1:, :], cfg)[:, 0], cache


def seq_cache_rows(rows, cfg, max_len: Optional[int], what: str
                   ) -> torch.Tensor:
    """A prefill cache leaf [n, B, T/D, kvh, d] from the rank's K or V
    rows (a list of n layers' blocks [B, S/D, kvh, d]) under batch-1
    sequence sharding: with T = ``max_len`` the prompt's length (or
    None) the rank's block of T is its own rows, with no collective;
    a longer T moves each layer's rows to the ranks whose blocks hold
    them (``seq.to_blocks``), zeros past the prompt."""
    dt = torch_dtype(cfg.dtype)
    s = rows[0].shape[1] * SEQ.current().size
    if max_len is None or max_len == s:
        return torch.stack(rows).to(dt)
    return torch.stack([SEQ.to_blocks(r.to(dt), max_len, "prefill_" + what)
                        for r in rows])


def decode_step(p: Params, cfg, token: torch.Tensor, cache: Params,
                pos: torch.Tensor, live=None) -> Tuple[torch.Tensor, Params]:
    """One-token step: token [B], pos [B] → (logits [B, V], cache).  The
    cache is updated IN PLACE (one row per slot per layer); a slot whose
    ``live`` (bool [B]) is False writes nothing."""
    x = embed(p, cfg, token)[:, None, :]
    for i in range(cfg.num_layers):
        lp = L.layer_params(p["layers"], i)
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
        x = x + L.decode_attention(lp["attn"],
                                   norm(lp["attn_norm"], x, cfg),
                                   layer_cache, pos, cfg, live)
        x = x + L.mlp(lp["mlp"], norm(lp["mlp_norm"], x, cfg),
                      cfg.activation, cfg.d_ff)
    return logits_head(p, x, cfg)[:, 0], cache
