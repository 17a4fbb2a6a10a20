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

The wrapper dispatches on the device of ``inner``: CPU takes the plain
version; CUDA launches ``csrc/dkv_attention.cu`` or raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .build import SMEM_LIMIT, library

NEG = -1e30

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def dkv_attention_stats_plain(inner, k_u, v_u, t_valid) -> Stats:
    """Plain version: full-score masked softmax statistics.
    inner [B,G,r]; k_u, v_u [B,T,r]; t_valid int [B]."""
    t = k_u.shape[1]
    s = torch.einsum("bgr,btr->bgt", inner.float(), k_u.float())
    valid = (torch.arange(t, device=inner.device)[None, :]
             < t_valid.to(inner.device).long()[:, None])[:, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG))
    m = s.amax(-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), torch.zeros_like(s))
    a = torch.einsum("bgt,btr->bgr", p, v_u.float())
    return a, m, p.sum(-1)


_BOUND = False


def _lib() -> ctypes.CDLL:
    global _BOUND
    lib = library("dkv_attention")
    if not _BOUND:
        vp, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.dcom_dkv_stats_f32, lib.dcom_dkv_stats_bf16):
            fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, i, i, i, i, vp]
            fn.restype = i
        lib.dcom_dkv_smem_bytes.argtypes = [i, i]
        lib.dcom_dkv_smem_bytes.restype = ctypes.c_size_t
        _BOUND = True
    return lib


def dkv_attention_stats(inner, k_u, v_u, t_valid) -> Stats:
    """Rank-space flash statistics of the low-rank prefix.

    inner [B, G, r] float32 (scaled q·Vᵀ_k for all G query heads);
    k_u, v_u [B, T, r] float32 or bfloat16; t_valid int32 [B] →
    (a [B, G, r], m [B, G], l [B, G]) float32."""
    if inner.device.type == "cpu":
        return dkv_attention_stats_plain(inner, k_u, v_u, t_valid)
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
    lib = _lib()
    smem = lib.dcom_dkv_smem_bytes(g, r)
    if smem > SMEM_LIMIT:
        raise ValueError(f"dkv_attention_stats: G={g}, r={r} needs {smem} B "
                         f"of shared memory per block (limit {SMEM_LIMIT})")
    f32 = dict(device=inner.device, dtype=torch.float32)
    a = torch.empty(b, g, r, **f32)
    m = torch.empty(b, g, **f32)
    l_ = torch.empty(b, g, **f32)
    fn = lib.dcom_dkv_stats_f32 if k_u.dtype == torch.float32 \
        else lib.dcom_dkv_stats_bf16
    err = fn(inner.data_ptr(), k_u.data_ptr(), v_u.data_ptr(),
             t_valid.data_ptr(), a.data_ptr(), m.data_ptr(), l_.data_ptr(),
             b, g, t, r, torch.cuda.current_stream(inner.device).cuda_stream)
    if err:
        raise RuntimeError(f"dkv_attention_stats kernel launch failed "
                           f"(cudaError {err})")
    dkv_attention_stats.launches += 1
    return a, m, l_


dkv_attention_stats.launches = 0


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
