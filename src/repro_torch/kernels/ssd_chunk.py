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
output has no autograd history, so a bare launch whose inputs require a
gradient (under grad mode) raises: training goes through
:class:`SSDChunkIntra`, whose backward is the hand-written kernel of
``csrc/ssd_chunk_bwd.cu`` (:func:`ssd_chunk_intra_bwd`, counted in
``ssd_chunk_intra_bwd.launches``; its plain version
:func:`ssd_chunk_intra_bwd_plain` beside it).  The forward kernel's
work items are (chunk, pair of 64-row query tiles, block of heads, 64
columns of hd); :func:`heads_per_item` picks the block of heads that
shares one staging of cb.  The backward kernel's items are (key tile,
chunk, block of heads) in the order of :func:`bwd_items`;
:func:`bwd_plan` picks the block and sizes the scratch.
"""
from __future__ import annotations

import ctypes
import functools
import heapq
from typing import List, NamedTuple, Tuple

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


def ssd_chunk_intra_bwd_plain(cb: torch.Tensor, l: torch.Tensor,
                              dt: torch.Tensor, x: torch.Tensor,
                              dy: torch.Tensor):
    """Plain backward of :func:`ssd_chunk_intra_plain` → (dcb, dl, ddt,
    dx).  With E = exp(l_q − l_s) masked to s ≤ q (the exponent masked
    to −inf, so it never overflows above the diagonal), M = cb·E·dt and
    G[q, s, n] = Σ_d dy[q, n, d]·x[s, n, d]:

    dx[s] = Σ_q M[q, s]·dy[q];   dcb[q, s] = Σ_n G·E·dt;
    ddt[s] = Σ_q G·cb·E;         dl[q] = Σ_s (G∘M)[q, s] − Σ_q' (G∘M)[q', q].
    """
    q = cb.shape[-1]
    tril = torch.tril(torch.ones(q, q, dtype=torch.bool,
                                 device=cb.device))[None, :, :, None]
    diff = l[:, :, None, :] - l[:, None, :, :]                 # [G,Q,Q,nh]
    e = torch.exp(torch.where(tril, diff, torch.full_like(diff,
                                                          float("-inf"))))
    dtk = dt[:, None, :, :]                                    # keys' dt
    m = cb[..., None] * e * dtk
    g = torch.einsum("gqnd,gsnd->gqsn", dy.float(), x.float())
    gm = g * m
    dx = torch.einsum("gqsn,gqnd->gsnd", m, dy.float())
    dcb = (g * e * dtk).sum(dim=-1)
    ddt = (g * cb[..., None] * e).sum(dim=1)
    dl = gm.sum(dim=2) - gm.sum(dim=1)
    return dcb, dl, ddt, dx


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


_BOUND_BWD = False


def _lib_bwd() -> ctypes.CDLL:
    global _BOUND_BWD
    lib = library("ssd_chunk_bwd")
    if not _BOUND_BWD:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.dcom_ssd_chunk_intra_bwd_f32.argtypes = [vp] * 11 + [i] * 7 \
            + [vp, i, vp]
        lib.dcom_ssd_chunk_intra_bwd_f32.restype = i
        lib.dcom_ssd_bwd_max_hd.restype = i
        lib.dcom_ssd_bwd_ctas_per_sm.argtypes = [i]
        lib.dcom_ssd_bwd_ctas_per_sm.restype = i
        _BOUND_BWD = True
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


def bwd_items(g: int, q: int, nh: int,
              hb: int) -> List[Tuple[int, int, int, int]]:
    """The backward kernel's items in the order its CTAs take them (the
    first by CTA index, the rest from a ticket): (key tile j, chunk, first
    head, heads) with key tile 0 first (it meets every query tile: the
    heaviest), then per key tile each chunk's full blocks of ``hb`` heads
    and then every chunk's remainder block.  An item walks query tiles j
    .. ⌈q / 64⌉ − 1 for each of its heads."""
    nt = -(-q // TILE)
    full, rem = divmod(nh, hb)
    out = []
    for j in range(nt):
        out += [(j, c, b * hb, hb) for c in range(g) for b in range(full)]
        out += [(j, c, full * hb, rem) for c in range(g) if rem]
    return out


def _span(weights, ctas: int) -> int:
    """When the last of ``weights`` (in ticket order) ends on ``ctas``
    CTAs, each taking the next item as it frees up."""
    free = [0] * min(ctas, len(weights))
    heapq.heapify(free)
    for w in weights:
        heapq.heappush(free, heapq.heappop(free) + w)
    return max(free)


class BwdPlan(NamedTuple):
    hb: int           # heads an item takes
    items: int
    dcb_work: int     # floats of per-block dcb partials
    dl_work: int      # floats of per-item dl partials (0: one query tile)
    tickets: int      # counters: item ticket, exits, tiles, chunks


#: the time one CTA takes to add one block's dcb partial of a tile, in
#: units of one (head, tile pair) stage (ssd_timeline.py's backward
#: lines on the H100: ~0.46 µs a partial, ~4 µs a stage)
BWD_PARTIAL_COST = 0.12


def bwd_cost(g: int, q: int, nh: int, hb: int, ctas: int) -> float:
    """The backward's modelled time with blocks of ``hb`` heads, in
    stages: the greedy schedule of :func:`bwd_items` (tile pairs × heads)
    plus the combines of the blocks' dcb partials that can fall on the
    heaviest items' CTAs (one a query tile: the last CTA to finish a
    tile adds its partials, and a CTA late for one tile is late for the
    next)."""
    nt = -(-q // TILE)
    span = _span([(nt - j) * h for j, _, _, h in bwd_items(g, q, nh, hb)],
                 ctas)
    return span + BWD_PARTIAL_COST * -(-nh // hb) * nt


@functools.lru_cache(maxsize=256)
def bwd_plan(g: int, q: int, nh: int, ctas: int) -> BwdPlan:
    """The backward kernel's launch on ``ctas`` resident CTAs: the block
    of heads of least :func:`bwd_cost` (the larger block on a tie), its
    items, scratch and ticket counters."""
    best, hb = None, 1
    for cand in range(1, min(nh, 16) + 1):
        cost = bwd_cost(g, q, nh, cand, ctas)
        if best is None or cost <= best:
            best, hb = cost, cand
    nt, nhb = -(-q // TILE), -(-nh // hb)
    return BwdPlan(hb=hb, items=nt * g * nhb,
                   dcb_work=g * nt * nt * nhb * TILE * TILE,
                   dl_work=g * nh * nt * q if nt > 1 else 0,
                   tickets=2 + g * nt * nt + g)


@functools.lru_cache(maxsize=None)
def bwd_ctas(device_index: int, hd: int) -> int:
    """Resident CTAs of the backward kernel on the device (SMs × CTAs an
    SM holds at head width ``hd``)."""
    per_sm = _lib_bwd().dcom_ssd_bwd_ctas_per_sm(hd)
    if per_sm < 1:
        raise RuntimeError(f"ssd_chunk_intra_bwd: the kernel does not fit "
                           f"an SM at hd {hd}")
    return per_sm * sm_count(device_index)


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
    float32.  On the card the output has no gradient: with grad mode on
    and an input that requires one, this raises (use
    :func:`ssd_chunk_intra_diff`)."""
    if x.device.type == "cpu":
        return ssd_chunk_intra_plain(cb, l, dt, x)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_intra: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (cb, l, dt, x)):
        raise RuntimeError(
            "ssd_chunk_intra: the kernel's output carries no gradient, and "
            "an input requires one; call ssd_chunk_intra_diff (the "
            "SSDChunkIntra autograd Function, make_kernels('cuda')"
            ".ssd_chunk_intra) instead")
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


def ssd_chunk_intra_bwd(cb: torch.Tensor, l: torch.Tensor, dt: torch.Tensor,
                        x: torch.Tensor, dy: torch.Tensor):
    """Gradients (dcb [G, Q, Q], dl [G, Q, nh], ddt [G, Q, nh], dx [G, Q,
    nh, hd]) of the intra-chunk term given dy [G, Q, nh, hd], float32: the
    plain version for CPU tensors, the kernel of ``csrc/ssd_chunk_bwd.cu``
    for CUDA tensors (or a raise), one launch.  dcb sums over the heads in
    a fixed order (no float atomics): reruns are bit-identical."""
    if x.device.type == "cpu":
        return ssd_chunk_intra_bwd_plain(cb, l, dt, x, dy)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_intra_bwd: unsupported device "
                         f"{x.device}")
    _check(cb, l, dt, x)
    if dy.shape != x.shape or dy.dtype != torch.float32 \
            or not dy.is_contiguous() or dy.device != x.device:
        raise ValueError(f"ssd_chunk_intra_bwd: dy must be a contiguous "
                         f"float32 tensor shaped like x {tuple(x.shape)}, "
                         f"got {tuple(dy.shape)} {dy.dtype}")
    g, q, nh, hd = x.shape
    lib = _lib_bwd()
    if hd > lib.dcom_ssd_bwd_max_hd():
        raise ValueError(f"ssd_chunk_intra_bwd: hd {hd} > "
                         f"{lib.dcom_ssd_bwd_max_hd()}")
    dcb = torch.empty(g, q, q, device=x.device, dtype=torch.float32)
    dl, ddt, dx = torch.empty_like(l), torch.empty_like(dt), \
        torch.empty_like(x)
    if x.numel() == 0:
        return dcb.zero_(), dl.zero_(), ddt.zero_(), dx
    # TMA rows must be whole 16-byte units at 16-byte aligned addresses:
    # odd widths and unaligned views (dy from autograd may be one) are
    # padded or copied here; dx is written at its own width
    qp, hdp = -(-q // 4) * 4, -(-hd // 4) * 4
    cbk = cb if qp == q and cb.data_ptr() % 16 == 0 else _pad_last(cb, qp)
    xk, dyk = (t if hdp == hd and t.data_ptr() % 16 == 0
               else _pad_last(t, hdp) for t in (x, dy))
    ctas = bwd_ctas(x.device.index, hd)
    plan = bwd_plan(g, q, nh, ctas)
    dcbw = torch.empty(plan.dcb_work, device=x.device, dtype=torch.float32)
    dlw = torch.empty(max(plan.dl_work, 1), device=x.device,
                      dtype=torch.float32)
    err = lib.dcom_ssd_chunk_intra_bwd_f32(
        cbk.data_ptr(), l.data_ptr(), dt.data_ptr(), xk.data_ptr(),
        dyk.data_ptr(), dcb.data_ptr(), dl.data_ptr(), ddt.data_ptr(),
        dx.data_ptr(), dcbw.data_ptr(), dlw.data_ptr(), g, q, nh, hdp, hd,
        qp, plan.hb, tickets(x.device, plan.tickets, "ssd_bwd").data_ptr(),
        ctas, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_chunk_intra_bwd kernel launch failed "
                           f"(error {err})")
    ssd_chunk_intra_bwd.launches += 1
    return dcb, dl, ddt, dx


ssd_chunk_intra_bwd.launches = 0


class SSDChunkIntra(torch.autograd.Function):
    """The intra-chunk term with a gradient: the forward is
    :func:`ssd_chunk_intra` (the CUDA kernel on the card), the backward
    :func:`ssd_chunk_intra_bwd` (the backward kernel on the card; the
    plain formulas on the host).  Saves cb, l, dt and x."""

    @staticmethod
    def forward(ctx, cb, l, dt, x):
        ctx.save_for_backward(cb, l, dt, x)
        return ssd_chunk_intra(cb, l, dt, x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        cb, l, dt, x = ctx.saved_tensors
        return ssd_chunk_intra_bwd(cb, l, dt, x, dy.contiguous())


def ssd_chunk_intra_diff(cb: torch.Tensor, l: torch.Tensor, dt: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """:func:`ssd_chunk_intra` through :class:`SSDChunkIntra`: the
    ``"cuda"`` kernel set's entry, differentiable on every device."""
    return SSDChunkIntra.apply(cb, l, dt, x)
