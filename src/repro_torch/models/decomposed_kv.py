"""Decomposed KV cache — the slab half of ``repro.models.decomposed_kv``.

After prefill each layer's K and V [T, kvh·hd] are factorized by the
DecomposeEngine into (U [B, T, r], Vᵀ [B, r, kvw]); decode attends
THROUGH the factors plus an exact dense tail of recent tokens, and the
serving engine folds a slot's tail back into its prefix (rank-concat +
retruncate) when the tail fills.  All tail state is per slot:
``frozen_len`` is an int32 [B] tensor, prefix rows at or past a slot's
``frozen_len`` are masked out of the softmax, and ``compress_tail``
takes a per-slot ``fold`` mask.

Decode has two attention routes with one meaning:

* ``"kernel"`` (default): the rank-space flash statistics
  (``kernels.dkv_attention.dkv_attention_stats`` — the CUDA kernel on
  the card, its plain version on the host) merged with the exact tail by
  ``merge_with_tail``;
* ``"plain"``: :func:`_lowrank_attention`, the joint-softmax contraction
  of the JAX package — the kernel route's oracle, used for comparisons.

Tail writes, splices and decode updates work IN PLACE on the cache
tensors (the JAX version rebuilds them functionally).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.lowrank import LowRank, retruncate
from ..engine import DecomposeEngine
from ..kernels.dkv_attention import NEG, dkv_attention_stats, merge_with_tail
from ..platform import torch_dtype
from . import layers as L
from . import transformer as T

Params = Dict[str, Any]


def init_cache(cfg, batch: int, frozen_len: int, rank: int, *, tail: int,
               device=None) -> Params:
    """Zeroed cache; ``tail`` is the dense recent-token buffer length
    (``EngineConfig.kv_tail`` when serving)."""
    kvw = cfg.kv_width
    nl, dt = cfg.num_layers, torch_dtype(cfg.dtype)
    z = lambda *shape: torch.zeros(shape, device=device, dtype=dt)
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {"k_u": z(nl, batch, frozen_len, rank),
            "k_vt": z(nl, batch, rank, kvw),
            "v_u": z(nl, batch, frozen_len, rank),
            "v_vt": z(nl, batch, rank, kvw),
            "tail": {"k": z(nl, batch, tail, kvh, hd),
                     "v": z(nl, batch, tail, kvh, hd)}}


def prefill_dkv(p: Params, cfg, tokens: torch.Tensor, rank: int, *,
                tail: int, exact: bool = False,
                engine: Optional[DecomposeEngine] = None
                ) -> Tuple[torch.Tensor, Params]:
    """Dense prefill that emits a decomposed KV cache: every layer's K
    and V of every prompt factorize in ONE batched ``decompose_kv`` call
    each ([L·B, S, kvw] — the re-orth kernels see B = L·prompts)."""
    if rank < 1:
        raise ValueError(f"prefill_dkv needs rank >= 1, got {rank}")
    engine = engine or DecomposeEngine()
    b, s = tokens.shape
    nl, kvw = cfg.num_layers, cfg.kv_width
    x, ks, vs = T.forward_layers(p, cfg, tokens)
    logits = T.logits_head(p, x[:, -1:, :], cfg)[:, 0]

    def one(rows):
        flat = torch.stack(rows).reshape(nl * b, s, kvw)
        u, vt = engine.decompose_kv(flat, rank, exact=exact)
        r_eff = u.shape[-1]         # rank caps at min(s, kvw)
        return (u.reshape(nl, b, s, r_eff).contiguous(),
                vt.reshape(nl, b, r_eff, kvw).contiguous())

    k_u, k_vt = one(ks)
    v_u, v_vt = one(vs)
    zt = torch.zeros(nl, b, tail, cfg.num_kv_heads, cfg.resolved_head_dim,
                     device=tokens.device, dtype=torch_dtype(cfg.dtype))
    return logits, {"k_u": k_u, "k_vt": k_vt, "v_u": v_u, "v_vt": v_vt,
                    "tail": {"k": zt, "v": zt.clone()}}


def _lowrank_attention(q, c: Params, tail_kv: Params, pos, frozen_len,
                       cfg) -> torch.Tensor:
    """q [B, 1, nh, d]; low-rank prefix + dense tail → out [B, 1, nh·d]
    through one joint softmax (the JAX package's contraction)."""
    nh, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    g = nh // kvh
    b = q.shape[0]
    scale = hd ** -0.5
    qg = q[:, 0].reshape(b, kvh, g, hd).float()
    t_pre = c["k_u"].shape[1]
    dev = q.device

    k_vt = c["k_vt"].float().reshape(b, -1, kvh, hd)
    inner = torch.einsum("bkgd,brkd->bkgr", qg, k_vt)
    sc_pre = torch.einsum("bkgr,btr->bkgt", inner, c["k_u"].float()) * scale
    pre_valid = torch.arange(t_pre, device=dev)[None, :] \
        < frozen_len[:, None]
    sc_pre = torch.where(pre_valid[:, None, None, :], sc_pre,
                         torch.full_like(sc_pre, NEG))

    tk = tail_kv["k"].float()
    sc_tail = torch.einsum("bkgd,btkd->bkgt", qg, tk) * scale
    tail_pos = frozen_len[:, None] + torch.arange(tk.shape[1],
                                                  device=dev)[None, :]
    valid = tail_pos <= pos[:, None]
    sc_tail = torch.where(valid[:, None, None, :], sc_tail,
                          torch.full_like(sc_tail, NEG))

    pr = torch.softmax(torch.cat([sc_pre, sc_tail], dim=-1), dim=-1)
    p_pre, p_tail = pr[..., :t_pre], pr[..., t_pre:]
    tmp = torch.einsum("bkgt,btr->bkgr", p_pre, c["v_u"].float())
    v_vt = c["v_vt"].float().reshape(b, -1, kvh, hd)
    out = torch.einsum("bkgr,brkd->bkgd", tmp, v_vt)
    out = out + torch.einsum("bkgt,btkd->bkgd", p_tail,
                             tail_kv["v"].float())
    return out.reshape(b, 1, nh * hd)


def _factored_attention(q, c: Params, tail_kv: Params, pos, frozen_len,
                        cfg) -> torch.Tensor:
    """Same contract as :func:`_lowrank_attention`, computed as rank-space
    flash statistics of the prefix (the dkv kernel) merged with the exact
    tail (``merge_with_tail``)."""
    nh, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    g = nh // kvh
    b = q.shape[0]
    r = c["k_vt"].shape[1]
    scale = hd ** -0.5
    qg = q[:, 0].reshape(b, kvh, g, hd).float()
    k_vt = c["k_vt"].float().reshape(b, r, kvh, hd)
    inner = torch.einsum("bkgd,brkd->bkgr", qg, k_vt) * scale
    a, m, l_ = dkv_attention_stats(inner.reshape(b, nh, r).contiguous(),
                                   c["k_u"].contiguous(),
                                   c["v_u"].contiguous(), frozen_len)

    tk = tail_kv["k"].float()
    sc_tail = torch.einsum("bkgd,btkd->bkgt", qg, tk) * scale
    tail_pos = frozen_len[:, None] + torch.arange(tk.shape[1],
                                                  device=q.device)[None, :]
    valid = tail_pos <= pos[:, None]
    sc_tail = torch.where(valid[:, None, None, :], sc_tail,
                          torch.full_like(sc_tail, NEG))
    v_vt = c["v_vt"].float().reshape(b, r, kvh, hd).permute(0, 2, 1, 3)
    tail_v = tail_kv["v"].float().permute(0, 2, 1, 3)        # [B,kvh,tl,d]
    out = merge_with_tail(a.reshape(b, kvh, g, r), m.reshape(b, kvh, g, 1),
                          l_.reshape(b, kvh, g, 1), v_vt, sc_tail, tail_v)
    return out.reshape(b, 1, nh * hd)


_ATTENTION = {"kernel": _factored_attention, "plain": _lowrank_attention}


def decode_step_dkv(p: Params, cfg, token: torch.Tensor, cache: Params,
                    pos: torch.Tensor, frozen_len: torch.Tensor, *,
                    attention: str = "kernel"
                    ) -> Tuple[torch.Tensor, Params]:
    """One-token decode over the decomposed cache.  ``pos`` and
    ``frozen_len`` are int32 [B]; each slot writes its new K/V row at tail
    row ``pos − frozen_len`` (clamped into the tail, as JAX's
    ``dynamic_update_slice`` clamps).  Returns (logits [B, V], cache)."""
    attend = _ATTENTION[attention]
    kvh, nh = cfg.num_kv_heads, cfg.num_heads
    tl = cache["tail"]["k"].shape[2]
    rows = torch.arange(token.shape[0], device=token.device)
    slot = torch.clamp(pos - frozen_len, 0, tl - 1).long()
    x = T.embed(p, cfg, token)[:, None, :]
    for i in range(cfg.num_layers):
        lp = L.layer_params(p["layers"], i)
        h = T.norm(lp["attn_norm"], x, cfg)
        q = L.split_heads(L.dense(lp["attn"]["wq"], h), nh)
        k_new = L.split_heads(L.dense(lp["attn"]["wk"], h), kvh)
        v_new = L.split_heads(L.dense(lp["attn"]["wv"], h), kvh)
        q = L.apply_rope(q, pos[:, None], cfg.rope_theta)
        k_new = L.apply_rope(k_new, pos[:, None], cfg.rope_theta)
        tail = {"k": cache["tail"]["k"][i], "v": cache["tail"]["v"][i]}
        tail["k"][rows, slot] = k_new[:, 0].to(tail["k"].dtype)
        tail["v"][rows, slot] = v_new[:, 0].to(tail["v"].dtype)
        layer_c = {key: cache[key][i]
                   for key in ("k_u", "k_vt", "v_u", "v_vt")}
        a = attend(q, layer_c, tail, pos, frozen_len, cfg)
        x = x + L.dense(lp["attn"]["wo"], a.to(x.dtype))
        x = x + L.mlp(lp["mlp"], T.norm(lp["mlp_norm"], x, cfg),
                      cfg.activation)
    return T.logits_head(p, x, cfg)[:, 0], cache


def fold_rank(rank: int, r_in: int, t_frozen: int, tl: int) -> int:
    """The rank a fold retruncates to (host-side mirror of the cap inside
    :func:`compress_tail`)."""
    return min(rank, r_in + tl, t_frozen + tl)


def _pad_axis(a: torch.Tensor, axis: int, size: int) -> torch.Tensor:
    """Zero-pad ``axis`` of ``a`` at the end up to ``size``."""
    if a.shape[axis] >= size:
        return a
    widths = [0, 0] * (a.dim() - 1 - axis) + [0, size - a.shape[axis]]
    return F.pad(a, widths)


def compress_tail(cache: Params, cfg, rank: int, frozen_len, fold,
                  new_frozen) -> Params:
    """Fold the dense tail into the low-rank prefix per slot (rank-concat
    + retruncate).  ``frozen_len`` int32 [B] and ``fold`` bool [B]: each
    folding slot's tail rows land at ITS ``frozen_len`` offset of the row
    space; non-folding slots keep prefix, factors and tail (the time axis
    still grows by ``tl``).  ``new_frozen`` int32 [B] zeroes retruncated U
    rows at or past each slot's new prefix length (they reconstruct to ~0
    anyway; the zero keeps "rows past frozen_len are zero" exact)."""
    nl, b, tl, kvh, hd = cache["tail"]["k"].shape
    kvw = kvh * hd
    r_in = cache["k_u"].shape[-1]
    t_frozen = cache["k_u"].shape[2]
    dev = cache["k_u"].device
    r_fold = fold_rank(rank, r_in, t_frozen, tl)
    r_out = max(r_in, r_fold)      # non-folding slots keep r_in columns
    fold_m = torch.as_tensor(fold, device=dev).bool().reshape(b)
    # identity block per slot, E[offset+i, i] = 1 → [B, T+tl, tl]; the
    # offset clamps so the block fits (dynamic_update_slice semantics)
    offsets = torch.clamp(
        torch.as_tensor(frozen_len, device=dev).long().reshape(b),
        0, t_frozen)
    scat = torch.zeros(b, t_frozen + tl, tl, device=dev)
    ar = torch.arange(tl, device=dev)
    scat[torch.arange(b, device=dev)[:, None], offsets[:, None] + ar,
         ar[None, :]] = 1.0
    nf = torch.as_tensor(new_frozen, device=dev).long().reshape(b)
    row_ok = torch.arange(t_frozen + tl, device=dev)[None, :] < nf[:, None]

    def one(u, vt, tail):
        tail2 = tail.reshape(nl, b, tl, kvw).float()
        u_pad = _pad_axis(u.float(), 2, t_frozen + tl)
        u_cat = torch.cat([u_pad, scat.expand(nl, -1, -1, -1)], dim=-1)
        vt_cat = torch.cat([vt.float(), tail2], dim=-2)
        ones = torch.ones(u_cat.shape[:-2] + (u_cat.shape[-1],), device=dev)
        lr = retruncate(LowRank(u_cat, ones, vt_cat), r_fold)
        u_new = _pad_axis(lr.scaled_u(), 3, r_out)
        vt_new = _pad_axis(lr.vt, 2, r_out)
        u_new = torch.where(row_ok[None, :, :, None], u_new,
                            torch.zeros_like(u_new))
        fm = fold_m[None, :, None, None]
        return (torch.where(fm, u_new, _pad_axis(u_pad, 3, r_out)),
                torch.where(fm, vt_new, _pad_axis(vt.float(), 2, r_out)))

    k_u, k_vt = one(cache["k_u"], cache["k_vt"], cache["tail"]["k"])
    v_u, v_vt = one(cache["v_u"], cache["v_vt"], cache["tail"]["v"])
    fm = fold_m[None, :, None, None, None]
    new_tail = {k: torch.where(fm, torch.zeros_like(v), v)
                for k, v in cache["tail"].items()}
    return {"k_u": k_u.to(cache["k_u"].dtype).contiguous(),
            "k_vt": k_vt.to(cache["k_vt"].dtype).contiguous(),
            "v_u": v_u.to(cache["v_u"].dtype).contiguous(),
            "v_vt": v_vt.to(cache["v_vt"].dtype).contiguous(),
            "tail": new_tail}


def splice_dkv(live: Params, fresh: Params, slot_indices) -> Params:
    """Scatter the first n batch rows of a freshly prefilled cache into
    ``live`` at the n ``slot_indices`` — admission into a
    live cache without re-prefilling occupied slots.  Time and rank axes
    are zero-padded to the pairwise max first (zero U rows/columns and
    zero Vᵀ rows are inert).  Writes into ``live``'s tensors in place
    where no padding was needed."""
    dev = live["k_u"].device
    idx = torch.as_tensor(slot_indices, device=dev).long()
    src = torch.arange(idx.shape[0], device=dev)
    t = max(live["k_u"].shape[2], fresh["k_u"].shape[2])
    r = max(live["k_u"].shape[-1], fresh["k_u"].shape[-1])
    out: Params = {}
    for key in ("k_u", "v_u"):
        old = _pad_axis(_pad_axis(live[key], 2, t), 3, r)
        new = _pad_axis(_pad_axis(fresh[key], 2, t), 3, r)
        old[:, idx] = new[:, src].to(old.dtype)
        out[key] = old
    for key in ("k_vt", "v_vt"):
        old = _pad_axis(live[key], 2, r)
        new = _pad_axis(fresh[key], 2, r)
        old[:, idx] = new[:, src].to(old.dtype)
        out[key] = old
    out["tail"] = {}
    for key, old in live["tail"].items():
        old[:, idx] = fresh["tail"][key][:, src].to(old.dtype)
        out["tail"][key] = old
    return out
