"""Intra-chunk term of the Mamba2 SSD scan, CUDA on the card.

Counterpart of ``repro.kernels.ssd_chunk.ssd_chunk_intra``: per chunk g
and head n,

    y[g, q, n] = Σ_{s ≤ q} cb[g, q, s] · exp(l[g, q, n] − l[g, s, n])
                 · dt[g, s, n] · x[g, s, n]

with cb [G, Q, Q] (C·Bᵀ of the chunk), l/dt [G, Q, nh] and x [G, Q, nh, hd],
all float32, giving y [G, Q, nh, hd] float32.  ``models.mamba2.ssd_apply``
computes its intra-chunk term through it (the JAX model computes the
same lines with einsums).

The wrapper dispatches on the device of ``x``: a CPU tensor takes the
plain PyTorch version beside it; a CUDA tensor launches the kernel in
``csrc/ssd_chunk.cu`` or raises — there is no fallback.
``ssd_chunk_intra.launches`` counts its kernel launches.  The kernel's
work items are (chunk, pair of 64-row query tiles, block of heads, 64
columns of hd); :func:`heads_per_item` picks the block of heads that
shares one staging of cb.
"""
from __future__ import annotations

import ctypes
import functools
import heapq

import torch

from .build import library, sm_count, tickets

TILE = 64          # query rows, keys per stage and columns of one item


def ssd_chunk_intra_plain(cb: torch.Tensor, l: torch.Tensor,
                          dt: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version (``repro.kernels.ref.ssd_chunk_intra``): the masked
    decay tensor [G, Q, Q, nh] materialized, then one contraction."""
    q = cb.shape[-1]
    decay = torch.exp(l[:, :, None, :] - l[:, None, :, :])     # [G,Q,Q,nh]
    tril = torch.tril(torch.ones(q, q, dtype=torch.bool,
                                 device=cb.device))[None, :, :, None]
    m = cb[..., None] * torch.where(tril, decay, 0.0) * dt[:, None, :, :]
    return torch.einsum("gqsn,gsnd->gqnd", m, x.float())


_BOUND = False


def _lib() -> ctypes.CDLL:
    global _BOUND
    lib = library("ssd_chunk")
    if not _BOUND:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.dcom_ssd_chunk_intra_f32.argtypes = [vp, vp, vp, vp, vp, i, i, i,
                                                 i, i, i, vp, i, vp]
        lib.dcom_ssd_chunk_intra_f32.restype = i
        lib.dcom_ssd_cb_slots.restype = i
        _BOUND = True
    return lib


@functools.lru_cache(maxsize=256)
def heads_per_item(g: int, q: int, nh: int, hd: int, ctas: int,
                   cb_slots: int = 4) -> int:
    """Heads an item of the kernel takes (1..4): the block whose greedy
    schedule of items over ``ctas`` CTAs, heaviest first as the kernel
    takes them, ends soonest (counted in 64-key stages), the larger block
    on a tie, since a block of heads stages cb once.  More than one head
    only where an item's cb boxes fit in the kernel's ``cb_slots``."""
    nt = -(-q // TILE)
    pairs = [(nt - p) + (p + 1 if p != nt - 1 - p else 0)
             for p in range((nt + 1) // 2)]
    ncs = -(-hd // TILE)
    best, best_hb = None, 1
    for hb in range(1, 5):
        if hb > 1 and nt + 1 > cb_slots:
            break
        nhb = -(-nh // hb)
        free = [0] * min(ctas, len(pairs) * g * nhb * ncs)
        heapq.heapify(free)
        for stages in pairs:
            for _ in range(g):
                for b in range(nhb):
                    w = min(hb, nh - b * hb) * stages
                    for _ in range(ncs):
                        heapq.heappush(free, heapq.heappop(free) + w)
        span = max(free)
        if best is None or span <= best:
            best, best_hb = span, hb
    return best_hb


def heads_for(g: int, q: int, nh: int, hd: int,
              device: torch.device) -> int:
    """:func:`heads_per_item` for the kernel's grid on ``device`` (one CTA
    an SM)."""
    return heads_per_item(g, q, nh, hd, sm_count(device.index),
                          _lib().dcom_ssd_cb_slots())


def _check(cb, l, dt, x) -> None:
    ok = x.dim() == 4 and cb.dim() == 3 and l.dim() == 3
    if ok:
        g, q, nh, _ = x.shape
        ok = (tuple(cb.shape) == (g, q, q) and tuple(l.shape) == (g, q, nh)
              and tuple(dt.shape) == (g, q, nh))
    if not ok:
        raise ValueError(
            f"ssd_chunk_intra: want cb [G,Q,Q], l/dt [G,Q,nh], x "
            f"[G,Q,nh,hd], got {tuple(cb.shape)}, {tuple(l.shape)}, "
            f"{tuple(dt.shape)}, {tuple(x.shape)}")
    for name, t in (("cb", cb), ("l", l), ("dt", dt), ("x", x)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(f"ssd_chunk_intra: {name} must be a contiguous "
                             f"float32 tensor on {x.device}, got {t.dtype} "
                             f"on {t.device} contiguous={t.is_contiguous()}")


def _pad_last(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` with its last dimension zero-padded to ``n`` (TMA rows are
    multiples of 16 bytes)."""
    out = t.new_zeros(t.shape[:-1] + (n,))
    out[..., :t.shape[-1]] = t
    return out


def ssd_chunk_intra(cb: torch.Tensor, l: torch.Tensor, dt: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """y [G, Q, nh, hd] = Σ_{s ≤ q} cb·exp(l_q − l_s)·dt_s·x_s per head,
    float32."""
    if x.device.type == "cpu":
        return ssd_chunk_intra_plain(cb, l, dt, x)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_intra: unsupported device {x.device}")
    _check(cb, l, dt, x)
    g, q, nh, hd = x.shape
    if x.numel() == 0:
        return torch.empty_like(x)
    # rows of cb and of x's heads must be whole 16-byte units for TMA,
    # at 16-byte aligned addresses; odd widths (not on the model's path: Q
    # is 64 or a bucketed length, hd 64) and unaligned views are padded or
    # copied here
    qp, hdp = -(-q // 4) * 4, -(-hd // 4) * 4
    cbk = cb if qp == q and cb.data_ptr() % 16 == 0 else _pad_last(cb, qp)
    xk = x if hdp == hd and x.data_ptr() % 16 == 0 else _pad_last(x, hdp)
    y = torch.empty_like(xk)
    err = _lib().dcom_ssd_chunk_intra_f32(
        cbk.data_ptr(), l.data_ptr(), dt.data_ptr(), xk.data_ptr(),
        y.data_ptr(), g, q, nh, hdp, qp, heads_for(g, q, nh, hdp, x.device),
        tickets(x.device, 2, "ssd").data_ptr(), sm_count(x.device.index),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_chunk_intra kernel launch failed "
                           f"(error {err})")
    ssd_chunk_intra.launches += 1
    return y if hdp == hd else y[..., :hd].contiguous()


ssd_chunk_intra.launches = 0
