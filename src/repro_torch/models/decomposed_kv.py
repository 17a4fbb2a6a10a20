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

The paged half (below :func:`splice_dkv`) keeps the prefix U rows and
the dense tail in page pools indexed by per-slot block tables; its decode
reads U through the block table inside the kernel
(``dkv_attention_stats_paged``) instead of gathering a slab every step.

Under tensor parallelism (``distributed.tp.use(mesh)``) a rank holds
``cache_pspec``'s blocks: U (and its page pools) whole, the kv width of
``k_vt``/``v_vt`` sharded over "model", the tail's kv heads (else
head_dim) sharded.  Prefill and folds all-gather K/V (or the Vᵀ factor
and the tail) to the whole kv width, so every model rank decomposes the
same matrix and keeps its columns; decode runs the dkv kernel on the
rank's query heads, [slots, nh/M, r] against the whole U (under a head
split the heads its column block touches, ``tp.HeadLayout``), and the
layout's ``aligned`` flag says whether the rank's block holds its kv
heads or it gathers them (kvh % M ≠ 0).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.lowrank import LowRank, retruncate
from ..distributed import seq as SEQ
from ..distributed import sharding as sh
from ..distributed import tp as TP
from ..engine import DecomposeEngine
from ..kernels.dkv_attention import (NEG, dkv_attention_stats,
                                     dkv_attention_stats_paged,
                                     merge_with_tail)
from ..platform import torch_dtype
from ..sampling import greedy_sampler
from . import layers as L
from . import transformer as T

Params = Dict[str, Any]


def init_cache(cfg, batch: int, frozen_len: int, rank: int, *, tail: int,
               device=None) -> Params:
    """Zeroed cache; ``tail`` is the dense recent-token buffer length
    (``EngineConfig.kv_tail`` when serving)."""
    kvw = _local_width(cfg)
    nl, dt = cfg.num_layers, torch_dtype(cfg.dtype)
    z = lambda *shape: torch.zeros(shape, device=device, dtype=dt)
    kvh, hd = T.kv_dims(cfg)
    return {"k_u": z(nl, batch, frozen_len, rank),
            "k_vt": z(nl, batch, rank, kvw),
            "v_u": z(nl, batch, frozen_len, rank),
            "v_vt": z(nl, batch, rank, kvw),
            "tail": {"k": z(nl, batch, tail, kvh, hd),
                     "v": z(nl, batch, tail, kvh, hd)}}


def _local_width(cfg) -> int:
    """The kv width of a rank's ``k_vt``/``v_vt`` block."""
    kvw = cfg.kv_width
    return kvw // TP.current().size if TP.width_sharded(kvw) else kvw


def _vt(vt: torch.Tensor, lay, cfg, what: str) -> torch.Tensor:
    """The Vᵀ columns the rank's queries read, from its block."""
    return TP.vt_heads(vt, lay, cfg.kv_width, cfg.resolved_head_dim, what)


def _whole_cache(cache: Params, cfg) -> Params:
    """A slab cache with every kv column and tail head (all-gathered over
    "model" under tensor parallelism; the cache's own tensors without)."""
    lay = TP.layout(cfg)
    out = {k: cache[k] for k in ("k_u", "v_u")}
    for k in ("k_vt", "v_vt"):
        out[k] = TP.vt_whole(cache[k], cfg.kv_width, k)
    out["tail"] = {k: TP.kv_whole(v, lay, "tail_" + k)
                   for k, v in cache["tail"].items()}
    return out


def _local_cache(cache: Params, cfg) -> Params:
    """The rank's blocks of a whole slab cache (:func:`_whole_cache`'s
    inverse)."""
    lay = TP.layout(cfg)
    out = {k: cache[k] for k in ("k_u", "v_u")}
    for k in ("k_vt", "v_vt"):
        out[k] = TP.vt_local(cache[k], cfg.kv_width).contiguous()
    out["tail"] = {k: TP.kv_local(v, lay).contiguous()
                   for k, v in cache["tail"].items()}
    return out


def prefill_dkv(p: Params, cfg, tokens: torch.Tensor, rank: int, *,
                tail: int, exact: bool = False,
                engine: Optional[DecomposeEngine] = None
                ) -> Tuple[torch.Tensor, Params]:
    """Dense prefill that emits a decomposed KV cache: every layer's K
    and V of every prompt factorize in ONE batched ``decompose_kv`` call
    each ([L·B, S, kvw] — the re-orth kernels see B = L·prompts).

    Under batch-1 sequence sharding (``distributed.seq``: ``tokens`` is
    the rank's block of the prompt) the rank's K/V rows [L, S/D, kvw]
    decompose in the reference's layout (:func:`_decompose_blocks`): the
    cache holds the rank's block of U·Σ's time axis and the whole Vᵀ
    (``cache_pspec`` at B = 1), its tail the rank's block of the tail's
    rows, and the logits are the last rank's."""
    if rank < 1:
        raise ValueError(f"prefill_dkv needs rank >= 1, got {rank}")
    engine = engine or DecomposeEngine()
    b, s = tokens.shape
    nl, kvw = cfg.num_layers, cfg.kv_width
    x, ks, vs = T.forward_layers(p, cfg, tokens)
    seq = SEQ.current()
    if seq is not None:
        x = SEQ.from_last(x[:, -1:, :], "last_hidden")
    logits = T.logits_head(p, x[:, -1:, :], cfg)[:, 0]
    lay = TP.layout(cfg)

    def one(rows, what):
        # every model rank decomposes the whole kv width, keeps its block
        stacked = TP.kv_whole(torch.stack(rows), lay, "prefill_kv")
        rows.clear()                  # the layers' rows: freed here
        flat = stacked.reshape(nl * b, s, kvw)
        del stacked
        if seq is not None:
            u, vt = _decompose_blocks(flat, rank, exact, engine, seq, what)
        else:
            u, vt = engine.decompose_kv(flat, rank, exact=exact)
        del flat
        r_eff = u.shape[-1]         # rank caps at min(S, kvw)
        vt = TP.vt_local(vt.reshape(nl, b, r_eff, kvw), kvw)
        return (u.reshape(nl, b, -1, r_eff).contiguous(), vt.contiguous())

    k_u, k_vt = one(ks, "k")
    v_u, v_vt = one(vs, "v")
    t_l = tail // seq.size if SEQ.splits(tail) else tail
    zt = torch.zeros((nl, b, t_l) + T.kv_dims(cfg),
                     device=tokens.device, dtype=torch_dtype(cfg.dtype))
    return logits, {"k_u": k_u, "k_vt": k_vt, "v_u": v_u, "v_vt": v_vt,
                    "tail": {"k": zt, "v": zt.clone()}}


def _decompose_blocks(rows: torch.Tensor, rank: int, exact: bool,
                      engine: DecomposeEngine, seq, what: str):
    """The factors of every layer's K (or V) of a batch-1 prompt sharded
    over the group ``seq``, from the rank's rows [L, n, kvw] (its block
    of n = S/D time rows): (the rank's rows of U·Σ [L, n, r], the whole
    Vᵀ [L, r, kvw]).

    Where D divides L (the reference's layout: its engine shards the
    flat [L·B] decomposition batch over DP, ``cache_pspec`` puts U's
    time axis on "data"): one all-to-all turns the time blocks into
    layer blocks [L/D, S, kvw], the rank decomposes its layers' whole
    K/V through the engine's kernels (its batch alone, the engine's one
    start vector), a second all-to-all returns U·Σ to the rank's time
    block and Vᵀ is all-gathered.  Else every rank gathers the whole
    K/V and decomposes every layer (the engine's replication fallback)
    and keeps its rows.  Per element the arithmetic is the unsharded
    call's."""
    d, i = seq.size, seq.rank
    nl, n, kvw = rows.shape
    if nl % d:
        whole = SEQ.gather_rows(rows, 1, f"dkv_{what}_rows")
        u, vt = engine.decompose_kv(whole, rank, exact=exact, local=True)
        return u.narrow(1, i * n, n), vt
    lb = nl // d
    got = rows.new_empty((d * lb, n, kvw))    # rank j's rows of my layers
    sh.all_to_all(got, rows.contiguous(), [lb] * d, [lb] * d, seq.group,
                  f"dkv_{what}_rows")
    block = got.view(d, lb, n, kvw).transpose(0, 1).reshape(lb, d * n, kvw)
    del got
    u, vt = engine.decompose_kv(block, rank, exact=exact, local=True)
    del block
    r = u.shape[-1]
    src = u.view(lb, d, n, r).transpose(0, 1).reshape(d * lb, n, r)
    mine = u.new_empty((d * lb, n, r))      # my rows of rank j's layers
    sh.all_to_all(mine, src.contiguous(), [lb] * d, [lb] * d, seq.group,
                  f"dkv_{what}_u")
    return mine, sh.gather_dim(vt.contiguous(), seq.group, f"dkv_{what}_vt",
                               0)


def _lowrank_attention(q, c: Params, tail_kv: Params, pos, frozen_len,
                       cfg) -> torch.Tensor:
    """q [B, 1, nh, d]; low-rank prefix + dense tail → out [B, 1, nh·d]
    through one joint softmax (the JAX package's contraction).  The head
    counts are ``q``'s and the tail's (a rank's, under tensor
    parallelism)."""
    nh, kvh, hd = q.shape[2], tail_kv["k"].shape[2], q.shape[-1]
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


def _merge_attention(q, k_vt, v_vt, tail_kv: Params, pos, frozen_len,
                     cfg, prefix_stats) -> torch.Tensor:
    """Rank-space flash statistics of the prefix (``prefix_stats(inner)``
    → (a, m, l), a dkv kernel) merged with the exact tail
    (``merge_with_tail``); k_vt, v_vt [B, r, kvw] are the slot factors
    (the head counts: ``q``'s and the tail's)."""
    nh, kvh, hd = q.shape[2], tail_kv["k"].shape[2], q.shape[-1]
    g = nh // kvh
    b = q.shape[0]
    r = k_vt.shape[1]
    scale = hd ** -0.5
    qg = q[:, 0].reshape(b, kvh, g, hd).float()
    k_vt = k_vt.float().reshape(b, r, kvh, hd)
    inner = torch.einsum("bkgd,brkd->bkgr", qg, k_vt) * scale
    a, m, l_ = prefix_stats(inner.reshape(b, nh, r).contiguous())

    tk = tail_kv["k"].float()
    sc_tail = torch.einsum("bkgd,btkd->bkgt", qg, tk) * scale
    tail_pos = frozen_len[:, None] + torch.arange(tk.shape[1],
                                                  device=q.device)[None, :]
    valid = tail_pos <= pos[:, None]
    sc_tail = torch.where(valid[:, None, None, :], sc_tail,
                          torch.full_like(sc_tail, NEG))
    v_vt = v_vt.float().reshape(b, r, kvh, hd).permute(0, 2, 1, 3)
    tail_v = tail_kv["v"].float().permute(0, 2, 1, 3)        # [B,kvh,tl,d]
    out = merge_with_tail(a.reshape(b, kvh, g, r), m.reshape(b, kvh, g, 1),
                          l_.reshape(b, kvh, g, 1), v_vt, sc_tail, tail_v)
    return out.reshape(b, 1, nh * hd)


def _factored_attention(q, c: Params, tail_kv: Params, pos, frozen_len,
                        cfg) -> torch.Tensor:
    """Same contract as :func:`_lowrank_attention`, computed as rank-space
    flash statistics of the prefix (the dkv kernel) merged with the exact
    tail (``merge_with_tail``)."""
    k_u, v_u = c["k_u"].contiguous(), c["v_u"].contiguous()
    # under batch-1 sequence sharding: the rank's block of prefix rows,
    # its valid count relative to the block, the ranks' statistics merged
    # (without a group the whole prefix, and the merge the identity)
    t_l = k_u.shape[1]
    t_valid = torch.clamp(frozen_len - SEQ.offset(t_l), 0, t_l).to(
        torch.int32)

    def stats(inner):
        a, m, l_ = dkv_attention_stats(inner, k_u, v_u, t_valid)
        a, m, l_ = SEQ.merge_stats(a, m[..., None], l_[..., None],
                                   "dkv_stats")
        return a, m[..., 0], l_[..., 0]
    return _merge_attention(q, c["k_vt"], c["v_vt"], tail_kv, pos,
                            frozen_len, cfg, stats)


_ATTENTION = {"kernel": _factored_attention, "plain": _lowrank_attention}


def decode_step_dkv(p: Params, cfg, token: torch.Tensor, cache: Params,
                    pos: torch.Tensor, frozen_len: torch.Tensor, *,
                    attention: str = "kernel", live=None
                    ) -> Tuple[torch.Tensor, Params]:
    """One-token decode over the decomposed cache.  ``pos`` and
    ``frozen_len`` are int32 [B]; each slot writes its new K/V row at tail
    row ``pos − frozen_len`` (clamped into the tail, as JAX's
    ``dynamic_update_slice`` clamps), unless its ``live`` (bool [B]) is
    False.  Returns (logits [B, V], cache).  Under batch-1 sequence
    sharding (``distributed.seq``) the cache holds the rank's block of
    the prefix rows and of the tail's: ``dkv_attention_stats`` runs on
    the block, the ranks' statistics merge across the group, and the
    tail, gathered whole, merges once (``merge_with_tail``)."""
    attend = _ATTENTION[attention]
    tl = cache["tail"]["k"].shape[2]
    rows = torch.arange(token.shape[0], device=token.device)
    if SEQ.current() is not None and attention != "kernel":
        raise ValueError("a decomposed cache sharded over the DP group "
                         "decodes through the flash statistics "
                         "(attention='kernel')")
    # sequence-sharded, the tail's rows are too: the row's owner writes it
    slot, live = SEQ.owner_rows(pos - frozen_len, tl, live)
    x = T.embed(p, cfg, token)[:, None, :]
    for i in range(cfg.num_layers):
        lp = L.layer_params(p["layers"], i)
        h = T.norm(lp["attn_norm"], x, cfg)
        q, k_new, v_new, lay = L.qkv(lp["attn"], h, cfg, pos[:, None])
        tail = {"k": cache["tail"]["k"][i], "v": cache["tail"]["v"][i]}
        L.write_rows(tail["k"], (rows, slot),
                     TP.cache_block(k_new, lay)[:, 0], live)
        L.write_rows(tail["v"], (rows, slot),
                     TP.cache_block(v_new, lay)[:, 0], live)
        tail = {k: TP.compute_heads(SEQ.gather_rows(v, 1, "tail_" + k),
                                    lay, "tail_" + k)
                for k, v in tail.items()}
        layer_c = {key: cache[key][i] for key in ("k_u", "v_u")}
        for key in ("k_vt", "v_vt"):
            layer_c[key] = _vt(cache[key][i], lay, cfg, key)
        a = attend(q, layer_c, tail, pos, frozen_len, cfg)
        x = x + L.o_proj(lp["attn"], a.to(x.dtype), cfg)
        x = x + L.mlp(lp["mlp"], T.norm(lp["mlp_norm"], x, cfg),
                      cfg.activation, cfg.d_ff)
    return T.logits_head(p, x, cfg)[:, 0], cache


def decode_block_dkv(p: Params, cfg, token: torch.Tensor, cache: Params,
                     pos: torch.Tensor, frozen_len: torch.Tensor, n_steps,
                     stop_table: torch.Tensor, *, max_block: int,
                     attention: str = "kernel", slot_live=None,
                     sampler=greedy_sampler, key=None, round0=0):
    """Up to ``n_steps`` (≤ ``max_block``) decode steps over the slab
    cache as one fixed-length loop (``api.run_decode_block``, whose
    ``slot_live`` freezes dead slots and whose ``sampler``/``key``/
    ``round0`` draw the tokens), the form a CUDA graph captures.
    ``frozen_len`` is loop-invariant: the
    serving engine caps ``n_steps`` at the fold horizon, so every fold
    still happens between blocks, at the occupancy the single-step engine
    folds at.  Returns ``(buf [max_block, B], steps, done, cache)``."""
    from . import api

    def step(t, c, ps, live):
        return decode_step_dkv(p, cfg, t, c, ps, frozen_len,
                               attention=attention, live=live)
    return api.run_decode_block(step, max_block, token, cache, pos,
                                n_steps, stop_table, slot_live,
                                sampler=sampler, key=key,
                                round0=round0)


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
    anyway; the zero keeps "rows past frozen_len are zero" exact).  Under
    tensor parallelism the fold runs on the whole kv width (Vᵀ and the
    tail all-gathered over "model"), on every model rank alike, and the
    rank keeps its blocks."""
    return _local_cache(_compress_tail(_whole_cache(cache, cfg), rank,
                                       frozen_len, fold, new_frozen), cfg)


def _compress_tail(cache: Params, rank: int, frozen_len, fold,
                   new_frozen) -> Params:
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


def splice_dkv(live: Params, fresh: Params, slot_indices,
               src_indices=None) -> Params:
    """Scatter batch rows ``src_indices`` (default the first n) of a
    freshly prefilled cache into ``live`` at the n ``slot_indices`` —
    admission into a live cache without re-prefilling occupied slots.
    Time and rank axes are zero-padded to the pairwise max first (zero U
    rows/columns and zero Vᵀ rows are inert), also when no row is
    spliced.  Writes into ``live``'s tensors in place where no padding
    was needed."""
    dev = live["k_u"].device
    idx = torch.as_tensor(slot_indices, device=dev).long()
    src = torch.arange(idx.shape[0], device=dev) if src_indices is None \
        else torch.as_tensor(src_indices, device=dev).long()
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


# ---------------------------------------------------------------------------
# Paged layout (block tables over the decomposed cache)
# ---------------------------------------------------------------------------
#
# The low-rank prefix U rows and the dense tail live in fixed-size PAGE
# POOLS indexed by per-slot page lists (block tables, host-side):
#
#   k_u_pages / v_u_pages  [nl, P,  page, r]          prefix U row pool
#   k_vt / v_vt            [nl, B,  r,    kvw]        per-slot factors
#   tail.k_pages / v_pages [nl, TP, page, kvh, hd]    dense tail row pool
#
# Page id 0 is the WRITE SINK: block-table padding and the fold-scatter
# targets of non-folding slots point at it.  The U sink stays ALL-ZERO
# (fold scatters write zeros for non-folding rows), because a block
# table's padding reads it as zero rows.  A page holds the same row range
# for every layer (one block table per slot).  ``gather_pages`` sliced to
# the slot engine's slab geometry (``t_need``/``r_need``, mirrored on the
# host by ``serving.paged.PagedDKV``) reproduces the slab arrays bit for
# bit, so paged decode and folds do the slot engine's arithmetic; folds
# write into FRESH pages (copy-on-write), so prefix pages shared between
# slots and the prefix cache are never rewritten.


def init_paged_cache(cfg, batch: int, num_pages: int, page: int, rank: int,
                     num_tail_pages: int, device=None) -> Params:
    """Zeroed page pools + per-slot factor rows of the paged cache."""
    nl, dt = cfg.num_layers, torch_dtype(cfg.dtype)
    kvh, hd = T.kv_dims(cfg)
    z = lambda *shape: torch.zeros(shape, device=device, dtype=dt)
    return {"k_u_pages": z(nl, num_pages, page, rank),
            "v_u_pages": z(nl, num_pages, page, rank),
            "k_vt": z(nl, batch, rank, _local_width(cfg)),
            "v_vt": z(nl, batch, rank, _local_width(cfg)),
            "tail": {"k_pages": z(nl, num_tail_pages, page, kvh, hd),
                     "v_pages": z(nl, num_tail_pages, page, kvh, hd)}}


def gather_pages(pool: torch.Tensor, bt: torch.Tensor,
                 rows: Optional[int] = None) -> torch.Tensor:
    """pool [nl, P, page, …], bt int [B, n] → rows [nl, B, t, …]: each
    slot's pages concatenated along time; ``rows`` zero-pads or slices
    the time axis to a target slab length."""
    g = pool[:, bt.long()]                          # [nl, B, n, page, ...]
    nl, b, n, pg = g.shape[:4]
    g = g.reshape(nl, b, n * pg, *g.shape[4:])
    return g if rows is None else _pad_axis(g[:, :, :rows], 2, rows)


def scatter_pages(pool: torch.Tensor, rows: torch.Tensor,
                  bt: torch.Tensor) -> torch.Tensor:
    """Write rows [nl, B, t, …] into pool pages ``bt`` [B, n] IN PLACE
    (``t`` zero-padded or sliced to n·page) and return the pool.
    Duplicate ids (the sink) are allowed: every U-sink write is zeros."""
    nl, b = rows.shape[:2]
    n, page = bt.shape[1], pool.shape[2]
    rows = _pad_axis(rows[:, :, :n * page], 2, n * page)
    pool[:, bt.long()] = rows.reshape(nl, b, n, page,
                                      *rows.shape[3:]).to(pool.dtype)
    return pool


def write_prefix_pages(pool: torch.Tensor, u: torch.Tensor,
                       bt: torch.Tensor, src) -> torch.Tensor:
    """Scatter freshly prefilled U factors (batch rows ``src`` of
    u [nl, nb, s, r_eff]) into pool pages ``bt`` [m, n] in place; the
    rank axis is zero-padded to the pool width (zero columns are inert)."""
    u = u[:, torch.as_tensor(src, device=u.device).long()]
    return scatter_pages(pool, _pad_axis(u, 3, pool.shape[-1]), bt)


def _gathered_cache(cache: Params, bt_u, bt_t, t_need: int, r_need: int,
                    tail_len: int) -> Params:
    """The slot engine's slab view of a paged cache, sliced to the
    mirrored slab geometry (so the arithmetic on it is the slab's)."""
    tail = cache["tail"]
    return {
        "k_u": gather_pages(cache["k_u_pages"], bt_u,
                            t_need)[..., :r_need].contiguous(),
        "v_u": gather_pages(cache["v_u_pages"], bt_u,
                            t_need)[..., :r_need].contiguous(),
        "k_vt": cache["k_vt"][:, :, :r_need].contiguous(),
        "v_vt": cache["v_vt"][:, :, :r_need].contiguous(),
        "tail": {"k": gather_pages(tail["k_pages"], bt_t, tail_len),
                 "v": gather_pages(tail["v_pages"], bt_t, tail_len)},
    }


def _tail_rows(bt_t: torch.Tensor, page: int, tail_len: int) -> torch.Tensor:
    """Each slot's first ``tail_len`` tail rows as flat row ids [B,
    tail_len] into a layer's tail pool viewed as [TP·page, kvh, hd]."""
    rows = bt_t.long()[:, :, None] * page + torch.arange(
        page, device=bt_t.device)
    return rows.reshape(bt_t.shape[0], -1)[:, :tail_len]


def _paged_views(cache: Params, r_need: int) -> Params:
    """Per-step views of a paged cache, indexed by layer: U pools
    [nl, P, page, r], slot factors sliced to ``r_need`` columns
    [nl, B, r_need, kvw] (contiguous, as the slab's), tail pools
    flattened to [nl, TP·page, kvh, hd] (views: tail writes land in the
    pools)."""
    t = cache["tail"]
    return {"k_u_pages": cache["k_u_pages"],
            "v_u_pages": cache["v_u_pages"],
            "k_vt": cache["k_vt"][:, :, :r_need].contiguous(),
            "v_vt": cache["v_vt"][:, :, :r_need].contiguous(),
            "tail_k": t["k_pages"].flatten(1, 2),
            "tail_v": t["v_pages"].flatten(1, 2)}


def _paged_tail(c: Params, tail_rows, cfg) -> Params:
    """The tail rows ``tail_rows`` of one layer's pools, on the kv heads
    the rank's queries read."""
    lay = TP.layout(cfg)
    return {k: TP.compute_heads(c["tail_" + k][tail_rows], lay, "tail_" + k)
            for k in ("k", "v")}


def _paged_attention(q, c: Params, pos, frozen_len, bt_u, tail_rows,
                     t_need: int, cfg) -> torch.Tensor:
    """Attention of one layer (``c``: :func:`_paged_views` at one layer)
    on the kernel route: U read through ``bt_u`` inside the paged dkv
    kernel (rows below ``frozen_len``, so ``t_need`` is not needed),
    merged with the exact tail rows ``tail_rows`` (:func:`_tail_rows`)."""
    ku, vu, r = c["k_u_pages"], c["v_u_pages"], c["k_vt"].shape[1]
    return _merge_attention(
        q, c["k_vt"], c["v_vt"], _paged_tail(c, tail_rows, cfg), pos,
        frozen_len, cfg,
        lambda inner: dkv_attention_stats_paged(inner, ku, vu, bt_u,
                                                frozen_len, r))


def _paged_lowrank_attention(q, c: Params, pos, frozen_len, bt_u,
                             tail_rows, t_need: int, cfg) -> torch.Tensor:
    """The oracle route: the gathered slab view (``t_need`` rows, the
    factors' columns) + ``_lowrank_attention``."""
    r = c["k_vt"].shape[1]
    u = {k: gather_pages(c[k + "_pages"][None], bt_u,
                         t_need)[0][..., :r] for k in ("k_u", "v_u")}
    return _lowrank_attention(
        q, dict(u, k_vt=c["k_vt"], v_vt=c["v_vt"]),
        _paged_tail(c, tail_rows, cfg), pos, frozen_len, cfg)


_PAGED_ATTENTION = {"kernel": _paged_attention,
                    "plain": _paged_lowrank_attention}


def decode_step_dkv_paged(p: Params, cfg, token: torch.Tensor,
                          cache: Params, pos: torch.Tensor,
                          frozen_len: torch.Tensor, bt_u: torch.Tensor,
                          bt_t: torch.Tensor, t_need: int, r_need: int,
                          tail_len: int, *, attention: str = "kernel",
                          live=None) -> Tuple[torch.Tensor, Params]:
    """One-token decode through the block tables (int32 [B, n] and
    [B, ntp]).  Each slot's new K/V row is written IN PLACE into its tail
    page (row ``clamp(pos − frozen_len, 0, tail_len − 1)``, as the slab
    step clamps).  ``"kernel"`` reads the prefix U rows through ``bt_u``
    inside ``dkv_attention_stats_paged`` (``r_need`` columns, rows below
    ``frozen_len``); ``"plain"`` gathers the slab view and runs
    ``_lowrank_attention``, the oracle.  ``t_need``/``r_need``/
    ``tail_len`` are the slot engine's slab dims (the kernel route reads
    no ``t_need``).  A slot whose ``live`` (bool [B]) is False writes
    nothing.  Returns (logits [B, V], cache)."""
    attend = _PAGED_ATTENTION[attention]
    page = cache["tail"]["k_pages"].shape[2]
    views = _paged_views(cache, r_need)
    tail_rows = _tail_rows(bt_t, page, tail_len)
    slot = torch.clamp(pos - frozen_len, 0, tail_len - 1).long()
    wrow = tail_rows[torch.arange(token.shape[0], device=token.device),
                     slot]
    x = T.embed(p, cfg, token)[:, None, :]
    for i in range(cfg.num_layers):
        lp = L.layer_params(p["layers"], i)
        h = T.norm(lp["attn_norm"], x, cfg)
        q, k_new, v_new, lay = L.qkv(lp["attn"], h, cfg, pos[:, None])
        c = {k: v[i] for k, v in views.items()}
        L.write_rows(c["tail_k"], wrow, TP.cache_block(k_new, lay)[:, 0],
                     live)
        L.write_rows(c["tail_v"], wrow, TP.cache_block(v_new, lay)[:, 0],
                     live)
        for key in ("k_vt", "v_vt"):
            c[key] = _vt(c[key], lay, cfg, key)
        a = attend(q, c, pos, frozen_len, bt_u, tail_rows, t_need, cfg)
        x = x + L.o_proj(lp["attn"], a.to(x.dtype), cfg)
        x = x + L.mlp(lp["mlp"], T.norm(lp["mlp_norm"], x, cfg),
                      cfg.activation, cfg.d_ff)
    return T.logits_head(p, x, cfg)[:, 0], cache


def decode_block_dkv_paged(p: Params, cfg, token: torch.Tensor,
                           cache: Params, pos: torch.Tensor,
                           frozen_len: torch.Tensor, bt_u: torch.Tensor,
                           bt_t: torch.Tensor, n_steps,
                           stop_table: torch.Tensor, t_need: int,
                           r_need: int, tail_len: int, *, max_block: int,
                           attention: str = "kernel", slot_live=None,
                           sampler=greedy_sampler, key=None, round0=0):
    """The paged twin of :func:`decode_block_dkv`: each step is
    :func:`decode_step_dkv_paged`, so the kernel route reads U through
    the block tables inside the paged kernel at every step (the
    reference gathers the slab view once per block; the tokens are the
    same, since the gathered rows are the slab's).  The block tables and
    the prefix pools are loop-invariant: folds and admissions, their only
    writers, run between blocks."""
    from . import api

    def step(t, c, ps, live):
        return decode_step_dkv_paged(p, cfg, t, c, ps, frozen_len, bt_u,
                                     bt_t, t_need, r_need, tail_len,
                                     attention=attention, live=live)
    return api.run_decode_block(step, max_block, token, cache, pos,
                                n_steps, stop_table, slot_live,
                                sampler=sampler, key=key,
                                round0=round0)


def compress_tail_paged(cache: Params, cfg, rank: int, frozen_len, fold,
                        new_frozen, bt_u, bt_u_new, bt_t, t_need: int,
                        r_need: int, tail_len: int) -> Params:
    """Paged tail fold: gather the slab view, run :func:`compress_tail`
    (the slab's arithmetic), then scatter the retruncated prefix rows into
    FRESH pages ``bt_u_new`` — old pages are never written, so pages
    shared with other slots or the prefix cache stay intact
    (copy-on-write).  Non-folding slots' ``bt_u_new`` rows point at the
    sink and scatter ZEROS, so the sink stays all-zero.  Updates the
    pools and factor rows in place and returns the cache; the caller
    swaps block tables and releases the folded slots' old pages."""
    slab = _gathered_cache(cache, bt_u, bt_t, t_need, r_need, tail_len)
    folded = compress_tail(slab, cfg, rank, frozen_len=frozen_len,
                           fold=fold, new_frozen=new_frozen)
    r_pool = cache["k_u_pages"].shape[-1]
    fm = torch.as_tensor(fold, device=cache["k_vt"].device).bool()
    fm = fm.reshape(-1)[None, :, None, None]
    for key in ("k_u", "v_u"):
        u = _pad_axis(folded[key], 3, r_pool)
        scatter_pages(cache[key + "_pages"],
                      torch.where(fm, u, torch.zeros_like(u)), bt_u_new)
    for key in ("k_vt", "v_vt"):
        vt = _pad_axis(folded[key], 2, r_pool).to(cache[key].dtype)
        cache[key] = torch.where(fm, vt, cache[key])
    for key in ("k", "v"):
        scatter_pages(cache["tail"][key + "_pages"], folded["tail"][key],
                      bt_t)
    return cache


def prefill_suffix_dkv(p: Params, cfg, tokens: torch.Tensor,
                       prefix: Params, start, slen, tail_len: int
                       ) -> Tuple[torch.Tensor, Params]:
    """Tail-only prefill for a prefix-cache hit: no prefix forward and no
    Lanczos.  ``tokens`` [B, S] is each slot's suffix beyond its matched
    frozen prefix, RIGHT-padded (rows at or past ``slen[b]`` are pad);
    ``prefix`` holds the gathered cached factors {k_u/v_u [nl, B, L, r],
    k_vt/v_vt [nl, B, r, kvw]}; ``start`` [B] (the matched prefix length,
    the slot's frozen_len) sets RoPE positions ``start + i``.  Returns
    (logits at each slot's last real row [B, V], dense tails {k, v}
    [nl, B, tail_len, kvh, hd] with rows ≥ slen zeroed).  Its products
    are plain einsums, as in the reference."""
    b, s = tokens.shape
    hd = cfg.resolved_head_dim
    scale = hd ** -0.5
    dev, dt = tokens.device, torch_dtype(cfg.dtype)
    start = torch.as_tensor(start, device=dev).long().reshape(b)
    slen = torch.as_tensor(slen, device=dev).long().reshape(b)
    x = T.embed(p, cfg, tokens)
    positions = start[:, None] + torch.arange(s, device=dev)[None, :]
    row = torch.arange(s, device=dev)
    live_row = row[None, :] < slen[:, None]              # [B, S] real rows
    causal = row[:, None] >= row[None, :]                # [S, S]
    t_pre = prefix["k_u"].shape[2]
    pre_valid = torch.arange(t_pre, device=dev)[None, :] < start[:, None]
    tails = {"k": [], "v": []}
    for i in range(cfg.num_layers):
        lp = L.layer_params(p["layers"], i)
        h = T.norm(lp["attn_norm"], x, cfg)
        q, k, v, lay = L.qkv(lp["attn"], h, cfg, positions)
        k, v = TP.cache_block(k, lay), TP.cache_block(v, lay)
        kc, vc = TP.compute_heads(k, lay, "k"), TP.compute_heads(v, lay, "v")
        nh, kvh = q.shape[2], kc.shape[2]
        g = nh // kvh
        qg = q.reshape(b, s, kvh, g, hd).float()
        # prefix scores through the cached factors
        kvt4 = _vt(prefix["k_vt"][i], lay, cfg, "k_vt").float().reshape(
            b, -1, kvh, hd)
        inner = torch.einsum("bskgd,brkd->bskgr", qg, kvt4)
        sc_pre = torch.einsum("bskgr,btr->bskgt", inner,
                              prefix["k_u"][i].float()) * scale
        sc_pre = torch.where(pre_valid[:, None, None, None, :], sc_pre,
                             torch.full_like(sc_pre, NEG))
        # within-suffix causal scores (exact)
        sc_suf = torch.einsum("bskgd,btkd->bskgt", qg, kc.float()) * scale
        sc_suf = torch.where(causal[None, :, None, None, :], sc_suf,
                             torch.full_like(sc_suf, NEG))
        pr = torch.softmax(torch.cat([sc_pre, sc_suf], dim=-1), dim=-1)
        p_pre, p_suf = pr[..., :t_pre], pr[..., t_pre:]
        tmp = torch.einsum("bskgt,btr->bskgr", p_pre,
                           prefix["v_u"][i].float())
        vvt4 = _vt(prefix["v_vt"][i], lay, cfg, "v_vt").float().reshape(
            b, -1, kvh, hd)
        out = torch.einsum("bskgr,brkd->bskgd", tmp, vvt4)
        out = out + torch.einsum("bskgt,btkd->bskgd", p_suf, vc.float())
        x = x + L.o_proj(lp["attn"],
                         out.reshape(b, s, nh * hd).to(x.dtype), cfg)
        x = x + L.mlp(lp["mlp"], T.norm(lp["mlp_norm"], x, cfg),
                      cfg.activation, cfg.d_ff)
        # suffix K/V become the slot's dense tail; pad rows zeroed so
        # later folds see what a full prefill would have left
        zmask = live_row[:, :, None, None]
        for key, val in (("k", k), ("v", v)):
            t_ = torch.where(zmask, val, torch.zeros_like(val)).to(dt)
            tails[key].append(_pad_axis(t_, 1, tail_len))
    x_last = x[torch.arange(b, device=dev), torch.clamp(slen - 1, min=0)]
    logits = T.logits_head(p, x_last[:, None], cfg)[:, 0]
    return logits, {k: torch.stack(v) for k, v in tails.items()}
