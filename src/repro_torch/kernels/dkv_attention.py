"""Flash-decoding through the low-rank KV factors, CUDA on the card.

Counterpart of ``repro.kernels.dkv_attention``.  The decomposed-KV decode
step contracts through the factors:

    s_t = inner · U_k[t]ᵀ          inner = (q · Vᵀ_k) · hd^-½   [G, r]
    out = softmax(s) · U_v · Vᵀ_v

:func:`dkv_attention_stats` returns the rank-space flash statistics of
the low-rank prefix for every slot and every query head at once —
(a = Σ p·U_v [B, G, r], m, l [B, G]) with rows at or past the slot's
``t_valid`` masked exactly — and :func:`merge_with_tail` flash-combines
them with exact attention over the dense tail.  Unlike the Pallas kernel
(one (batch, kv-head) slice, a static ``t_valid``), ``t_valid`` is a
per-slot int32 tensor: serving's ``frozen_len`` is per slot.

:func:`dkv_attention_stats_paged` computes the same statistics with the
U rows read THROUGH a block table out of page pools (paged serving); on
the card it is the same kernel with another row loader, bit-identical to
:func:`dkv_attention_stats` on the gathered rows at equal rank.

Each wrapper dispatches on the device of ``inner``: CPU takes the plain
version; CUDA launches ``csrc/dkv_attention.cu`` or raises.  One call is
one launch: the time axis is cut into blocks over CTAs, and the last CTA
of each (slot, head group) merges the blocks in order (it takes a ticket
from a per-device counter buffer that it leaves zeroed, so launches that
share it run one after another on one stream).

The slab statistics take the reference's operating point ``expansion``
(``dkv_attention.py:90-139``): f blocks per (slot, head group) of
ceil(t_valid / f) rows each, which a CTA walks in 32-row tiles with the
online-softmax update.  A call without it cuts the rows into 32-row
chunks, one CTA each — what serving runs, bit-equal to the paged twin,
which takes no knob (as in the reference).  The tunable space registered
below names the reference's default point (f 8); the tuner times it, no
path consults it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .build import SMEM_LIMIT, library, tickets

NEG = -1e30

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


MAX_EXPANSION = 1 << 20


def _check_expansion(expansion) -> Optional[int]:
    if expansion is None:
        return None
    f = int(expansion)
    if f != expansion or not 1 <= f <= MAX_EXPANSION:
        raise ValueError(f"dkv_attention_stats: expansion must be an int in "
                         f"1..{MAX_EXPANSION}, got {expansion!r}")
    return f


def block_rows(t_valid: int, expansion: int) -> int:
    """Rows of each of the ``expansion`` time blocks of a slot with
    ``t_valid`` rows: ceil(t_valid / f) (the reference's blocks of a time
    axis padded to a multiple of f), at least 1."""
    return max(1, -(-int(t_valid) // int(expansion)))


def dkv_attention_stats_plain(inner, k_u, v_u, t_valid, *,
                              expansion: Optional[int] = None) -> Stats:
    """Plain version: the masked softmax statistics of each slot over
    exactly its ``t_valid`` rows, one slot at a time — so the result
    does not depend on how many rows follow ``t_valid`` or how they are
    laid out (the paged plain version, on gathered rows, is this one bit
    for bit).  inner [B,G,r]; k_u, v_u [B,T,r]; t_valid int [B].
    With ``expansion`` f: each of the f blocks' statistics
    (:func:`block_rows`), merged in block order."""
    f = _check_expansion(expansion)
    if f is not None:
        return _blocked_plain(inner, k_u, v_u, t_valid, f)
    b, g, r = inner.shape
    f32 = dict(device=inner.device, dtype=torch.float32)
    a = torch.zeros(b, g, r, **f32)
    m = torch.full((b, g), NEG, **f32)
    l_ = torch.zeros(b, g, **f32)
    for i, n in enumerate(t_valid.clamp(0, k_u.shape[1]).tolist()):
        if n == 0:
            continue            # every row masked: a = 0, m = NEG, l = 0
        s = inner[i].float() @ k_u[i, :n].float().T          # [G, n]
        m[i] = s.amax(-1)
        p = torch.exp(s - m[i][:, None])
        a[i] = p @ v_u[i, :n].float()
        l_[i] = p.sum(-1)
    return a, m, l_


def _blocked_plain(inner, k_u, v_u, t_valid, f: int) -> Stats:
    b, g, r = inner.shape
    f32 = dict(device=inner.device, dtype=torch.float32)
    a = torch.zeros(b, g, r, **f32)
    m = torch.full((b, g), NEG, **f32)
    l_ = torch.zeros(b, g, **f32)
    for i, n in enumerate(t_valid.clamp(0, k_u.shape[1]).tolist()):
        if n == 0:
            continue
        step = block_rows(n, f)
        parts = []
        for lo in range(0, n, step):
            hi = min(lo + step, n)
            s = inner[i].float() @ k_u[i, lo:hi].float().T
            mc = s.amax(-1)
            p = torch.exp(s - mc[:, None])
            parts.append((mc, p.sum(-1), p @ v_u[i, lo:hi].float()))
        m[i] = torch.stack([mc for mc, _, _ in parts]).amax(0)
        for mc, lc, ac in parts:
            e = torch.exp(mc - m[i])
            l_[i] = l_[i] + lc * e
            a[i] = a[i] + ac * e[:, None]
    return a, m, l_


_BOUND = False


def _lib() -> ctypes.CDLL:
    global _BOUND
    lib = library("dkv_attention")
    if not _BOUND:
        vp, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.dcom_dkv_stats_f32, lib.dcom_dkv_stats_bf16):
            fn.argtypes = [vp] * 9 + [i] * 5 + [vp]
            fn.restype = i
        for fn in (lib.dcom_dkv_stats_paged_f32,
                   lib.dcom_dkv_stats_paged_bf16):
            fn.argtypes = [vp] * 10 + [i] * 6 + [vp]
            fn.restype = i
        lib.dcom_dkv_smem_bytes.argtypes = [i, i, i]
        lib.dcom_dkv_scratch_floats.argtypes = [i, i, i, i, i]
        lib.dcom_dkv_smem_bytes.restype = ctypes.c_size_t
        lib.dcom_dkv_scratch_floats.restype = ctypes.c_size_t
        lib.dcom_dkv_tickets.argtypes = [i, i]
        lib.dcom_dkv_tickets.restype = i
        _BOUND = True
    return lib


def dkv_attention_stats(inner, k_u, v_u, t_valid, *,
                        expansion: Optional[int] = None) -> Stats:
    """Rank-space flash statistics of the low-rank prefix.

    inner [B, G, r] float32 (scaled q·Vᵀ_k for all G query heads);
    k_u, v_u [B, T, r] float32 or bfloat16; t_valid int32 [B] →
    (a [B, G, r], m [B, G], l [B, G]) float32.  ``expansion`` f: f time
    blocks per slot and head group (None: 32-row chunks)."""
    if inner.device.type == "cpu":
        return dkv_attention_stats_plain(inner, k_u, v_u, t_valid,
                                         expansion=expansion)
    if inner.device.type != "cuda":
        raise ValueError(f"dkv_attention_stats: unsupported device "
                         f"{inner.device}")
    b, g, r = inner.shape
    t = k_u.shape[1]
    if inner.dtype != torch.float32:
        raise ValueError(f"inner must be float32, got {inner.dtype}")
    if k_u.dtype != v_u.dtype or k_u.dtype not in (torch.float32,
                                                   torch.bfloat16):
        raise ValueError(f"U factors must share float32 or bfloat16, got "
                         f"{k_u.dtype}/{v_u.dtype}")
    if tuple(k_u.shape) != (b, t, r) or tuple(v_u.shape) != (b, t, r) \
            or tuple(t_valid.shape) != (b,) or t_valid.dtype != torch.int32:
        raise ValueError(f"dkv_attention_stats: inner {tuple(inner.shape)}, "
                         f"k_u {tuple(k_u.shape)}, v_u {tuple(v_u.shape)}, "
                         f"t_valid {tuple(t_valid.shape)} {t_valid.dtype}")
    for t_ in (inner, k_u, v_u, t_valid):
        if not t_.is_contiguous() or t_.device != inner.device:
            raise ValueError("dkv_attention_stats: inputs must be "
                             f"contiguous and on {inner.device}")
    f = _check_expansion(expansion) or 0
    lib = _lib()
    part, tk, a, m, l_ = _buffers(lib, "dkv_attention_stats", inner, t, f)
    fn = lib.dcom_dkv_stats_f32 if k_u.dtype == torch.float32 \
        else lib.dcom_dkv_stats_bf16
    err = fn(inner.data_ptr(), k_u.data_ptr(), v_u.data_ptr(),
             t_valid.data_ptr(), part.data_ptr(), tk.data_ptr(),
             a.data_ptr(), m.data_ptr(), l_.data_ptr(), b, g, t, r, f,
             torch.cuda.current_stream(inner.device).cuda_stream)
    if err:
        raise RuntimeError(f"dkv_attention_stats kernel launch failed "
                           f"(cudaError {err})")
    dkv_attention_stats.launches += 1
    return a, m, l_


dkv_attention_stats.launches = 0


def _buffers(lib, name: str, inner, t: int, f: int = 0):
    """Check the CTA's shared memory for T = ``t`` rows at expansion
    ``f`` (0: 32-row chunks) and allocate the blocks' float32 scratch,
    the ticket counters and (a, m, l)."""
    b, g, r = inner.shape
    smem = lib.dcom_dkv_smem_bytes(r, t, f)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: r={r} over T={t} rows at expansion "
                         f"{f or None} needs {smem} B of shared memory per "
                         f"block (limit {SMEM_LIMIT})")
    f32 = dict(device=inner.device, dtype=torch.float32)
    return (torch.empty(lib.dcom_dkv_scratch_floats(b, g, t, r, f), **f32),
            tickets(inner.device, lib.dcom_dkv_tickets(b, g), "dkv"),
            torch.empty(b, g, r, **f32), torch.empty(b, g, **f32),
            torch.empty(b, g, **f32))


def gather_rows(pool, block_table, r: int) -> torch.Tensor:
    """pool [P, page, r_pool], block_table [B, n] → the slab view
    [B, n·page, r] (each slot's pages in table order, first r columns)."""
    b, n = block_table.shape
    g = pool[block_table.long()]                    # [B, n, page, r_pool]
    return g.reshape(b, n * pool.shape[1], pool.shape[2])[..., :r]


def dkv_attention_stats_paged_plain(inner, k_u_pages, v_u_pages,
                                    block_table, t_valid, r: int) -> Stats:
    """Plain version: gather the rows, then the slab plain version."""
    return dkv_attention_stats_plain(
        inner, gather_rows(k_u_pages, block_table, r),
        gather_rows(v_u_pages, block_table, r), t_valid)


def dkv_attention_stats_paged(inner, k_u_pages, v_u_pages, block_table,
                              t_valid, r: int) -> Stats:
    """Rank-space flash statistics with U read through a block table.

    inner [B, G, r] float32; k_u_pages, v_u_pages [P, page, r_pool]
    float32 or bfloat16 (one layer's pools); block_table int32 [B, n]
    (page id 0 is the all-zero sink); t_valid int32 [B]; ``r`` ≤ r_pool
    columns are read → (a [B, G, r], m [B, G], l [B, G]) float32, the
    statistics of :func:`dkv_attention_stats` over the gathered rows
    ``pool[block_table[b, t // page], t % page, :r]``, t < n·page."""
    if inner.device.type == "cpu":
        return dkv_attention_stats_paged_plain(inner, k_u_pages, v_u_pages,
                                               block_table, t_valid, r)
    if inner.device.type != "cuda":
        raise ValueError(f"dkv_attention_stats_paged: unsupported device "
                         f"{inner.device}")
    b, g, r_in = inner.shape
    if inner.dtype != torch.float32:
        raise ValueError(f"inner must be float32, got {inner.dtype}")
    if k_u_pages.dtype != v_u_pages.dtype or k_u_pages.dtype not in (
            torch.float32, torch.bfloat16):
        raise ValueError(f"U pools must share float32 or bfloat16, got "
                         f"{k_u_pages.dtype}/{v_u_pages.dtype}")
    if k_u_pages.dim() != 3 or v_u_pages.shape != k_u_pages.shape:
        raise ValueError(f"U pools must be [P, page, r_pool], got "
                         f"{tuple(k_u_pages.shape)}/"
                         f"{tuple(v_u_pages.shape)}")
    _, page, r_pool = k_u_pages.shape
    if not 1 <= r == r_in <= r_pool:
        raise ValueError(f"dkv_attention_stats_paged: r={r} must equal "
                         f"inner's {r_in} and be in 1..r_pool={r_pool}")
    if block_table.dim() != 2 or block_table.shape[0] != b \
            or block_table.dtype != torch.int32 \
            or tuple(t_valid.shape) != (b,) or t_valid.dtype != torch.int32:
        raise ValueError(f"dkv_attention_stats_paged: block_table "
                         f"{tuple(block_table.shape)} {block_table.dtype}, "
                         f"t_valid {tuple(t_valid.shape)} {t_valid.dtype} "
                         f"(int32 [B, n] and [B] with B={b})")
    for t_ in (inner, k_u_pages, v_u_pages, block_table, t_valid):
        if not t_.is_contiguous() or t_.device != inner.device:
            raise ValueError("dkv_attention_stats_paged: inputs must be "
                             f"contiguous and on {inner.device}")
    lib = _lib()
    n = block_table.shape[1]
    part, tk, a, m, l_ = _buffers(lib, "dkv_attention_stats_paged", inner,
                                  n * page)
    fn = lib.dcom_dkv_stats_paged_f32 if k_u_pages.dtype == torch.float32 \
        else lib.dcom_dkv_stats_paged_bf16
    err = fn(inner.data_ptr(), k_u_pages.data_ptr(), v_u_pages.data_ptr(),
             block_table.data_ptr(), t_valid.data_ptr(), part.data_ptr(),
             tk.data_ptr(), a.data_ptr(), m.data_ptr(), l_.data_ptr(),
             b, g, n, page, r_pool, r,
             torch.cuda.current_stream(inner.device).cuda_stream)
    if err:
        raise RuntimeError(f"dkv_attention_stats_paged kernel launch "
                           f"failed (cudaError {err})")
    dkv_attention_stats_paged.launches += 1
    return a, m, l_


dkv_attention_stats_paged.launches = 0


def merge_with_tail(a, m, l, v_vt, tail_scores, tail_v) -> torch.Tensor:
    """Flash-combine prefix rank-space stats with exact dense-tail
    attention, batched over any leading dims:
    a [..., g, r], m, l [..., g, 1], v_vt [..., r, d],
    tail_scores [..., g, tl] (already masked), tail_v [..., tl, d]
    → out [..., g, d], the softmax over [prefix ∪ tail] exactly."""
    m_t = tail_scores.amax(-1, keepdim=True)
    p_t = torch.exp(tail_scores - m_t)
    l_t = p_t.sum(-1, keepdim=True)
    o_t = p_t @ tail_v.float()
    m_all = torch.maximum(m, m_t)
    c_pre, c_t = torch.exp(m - m_all), torch.exp(m_t - m_all)
    out_pre = (a @ v_vt.float()) * c_pre
    denom = l * c_pre + l_t * c_t
    return (out_pre + o_t * c_t) / torch.clamp(denom, min=1e-30)


# -- tunable space (see repro_torch.tune): time blocks of the slab
# statistics; the default names the reference's, a call without the knob
# runs 32-row chunks -----------------------------------------------------
from ..tune.space import (EXPANSION_GRID, TunableParam,  # noqa: E402
                          TunableSpace, register_space)

register_space(TunableSpace("dkv_attention", (
    TunableParam("expansion", EXPANSION_GRID, default=8),
)))
