"""Preserved-compute GEMM Vᵀ* = Vᵀ @ W (paper Eq. 6), CUDA on the card.

Counterpart of ``repro.kernels.lowrank_matmul.lowrank_matmul``:
Vᵀ [..., k, H] @ W [H, N] accumulated in float32.  The batch of Vᵀ is
flattened into M = B·k rows of one launch (the TPU kernel takes one
[k, H]).  The result is returned in ``vt.dtype``, as the einsum at
``repro/core/preserved.py:143`` returns it: the kernel accumulates in
float32 and rounds once, where it writes the output.

The operating point is the reference's (``lowrank_matmul.py:59-70``):
``expansion`` f cuts the H reduction into f splits of
:func:`split_rows` rows (ceil(H / f), rounded up to 8 so that each split
starts a 16-byte vector of Vᵀ), whose float32 partial products are added
in split order; ``n_block`` is
the number of W columns one CTA owns (a multiple of 128: the CTA walks
n_block / 128 tiles).  A call with neither runs the card's own plan (at
most 8 splits of whole 64-row stages, sized to about one wave of SMs,
128 columns a CTA) — what every model path runs.  The tunable space
registered below names the reference's default point (f 8, n_block
512); the tuner times the knobs, no path consults them.  On the card a
split shorter than one 64-row ring stage is out of the kernel's reach
(``ValueError``; :func:`reaches`), f = 1 excepted.

The wrapper dispatches on the device of ``vt``: a CPU tensor takes the
plain PyTorch version beside it; a CUDA tensor launches the kernel in
``csrc/lowrank_matmul.cu`` or raises — there is no fallback.
``lowrank_matmul.launches`` counts its kernel launches (the fixed-order
combine of the H splits — through the cluster's shared memory up to 8
splits, past that by the last CTA of each tile, on a ticket — is part of
the same launch).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import library, sm_count, tickets

STAGE_ROWS = 64          # rows of W per ring stage (kTileH)
TILE_COLS = 128          # columns of W per tile (kTileN)
SPLIT_ALIGN = 8          # split length granule (16 bytes of bf16)
MAX_EXPANSION = 65535    # CUDA's limit on gridDim.y


def split_rows(h: int, expansion: int) -> int:
    """Rows of H per split at ``expansion`` f: ceil(H / f) (the
    reference's blocks of an H padded to a multiple of f) rounded up to
    :data:`SPLIT_ALIGN`; the last splits may be short or empty."""
    per = -(-int(h) // int(expansion))
    return -(-per // SPLIT_ALIGN) * SPLIT_ALIGN


def reaches(h: int, expansion: Optional[int]) -> bool:
    """Whether the card's kernel takes ``expansion`` at reduction length
    ``h``: every split at least one ring stage long (f = 1, one split of
    all of H, and the card's own plan always)."""
    return expansion is None or int(expansion) == 1 \
        or split_rows(h, expansion) >= STAGE_ROWS


def _check_knobs(expansion, n_block):
    if expansion is not None:
        f = int(expansion)
        if f != expansion or not 1 <= f <= MAX_EXPANSION:
            raise ValueError(f"lowrank_matmul: expansion must be an int in "
                             f"1..{MAX_EXPANSION}, got {expansion!r}")
    if n_block is not None:
        nb = int(n_block)
        if nb != n_block or nb < TILE_COLS or nb % TILE_COLS:
            raise ValueError(f"lowrank_matmul: n_block must be a positive "
                             f"multiple of {TILE_COLS}, got {n_block!r}")


def lowrank_matmul_plain(vt: torch.Tensor, w: torch.Tensor,
                         expansion: Optional[int] = None,
                         n_block: Optional[int] = None) -> torch.Tensor:
    """Plain version: float32 product, cast to ``vt.dtype``.  With
    ``expansion`` f: the float32 products of the f splits of H
    (:func:`split_rows` rows each) added in split order, rounded once.
    ``n_block`` does not change the arithmetic."""
    _check_knobs(expansion, n_block)
    if expansion is None:
        return (vt.float() @ w.float()).to(vt.dtype)
    h = w.shape[0]
    step = max(1, split_rows(h, expansion))
    out = torch.zeros(vt.shape[:-1] + w.shape[1:], dtype=torch.float32,
                      device=vt.device)
    for lo in range(0, h, step):
        out = out + vt[..., lo:lo + step].float() @ w[lo:lo + step].float()
    return out.to(vt.dtype)


_BOUND = False


def _lib() -> ctypes.CDLL:
    global _BOUND
    lib = library("lowrank_matmul")
    if not _BOUND:
        vp, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.dcom_lrmm_f32, lib.dcom_lrmm_bf16):
            fn.argtypes = [vp, vp, vp, i, i, i, i, i, i, vp, vp, vp]
            fn.restype = i
        lib.dcom_lrmm_scratch_floats.argtypes = [i, i, i]
        lib.dcom_lrmm_scratch_floats.restype = ctypes.c_size_t
        lib.dcom_lrmm_tickets.argtypes = [i, i]
        lib.dcom_lrmm_tickets.restype = i
        _BOUND = True
    return lib


def lowrank_matmul(vt: torch.Tensor, w: torch.Tensor, *,
                   expansion: Optional[int] = None,
                   n_block: Optional[int] = None) -> torch.Tensor:
    """Vᵀ [..., k, H] @ W [H, N] → [..., k, N] in ``vt.dtype``
    (float32 accumulation; both bfloat16 or both float32 on the card),
    at the operating point (``expansion``, ``n_block``), or the card's
    own plan where they are None."""
    if vt.device.type == "cpu":
        return lowrank_matmul_plain(vt, w, expansion, n_block)
    if vt.device.type != "cuda":
        raise ValueError(f"lowrank_matmul: unsupported device {vt.device}")
    if vt.dim() < 2 or w.dim() != 2 or vt.shape[-1] != w.shape[0]:
        raise ValueError(f"lowrank_matmul: shapes vt {tuple(vt.shape)} and "
                         f"w {tuple(w.shape)} do not chain")
    if vt.dtype != w.dtype or vt.dtype not in (torch.float32,
                                               torch.bfloat16):
        raise ValueError(f"lowrank_matmul: vt and w must both be float32 or "
                         f"both bfloat16, got {vt.dtype}/{w.dtype}")
    for name, t in (("vt", vt), ("w", w)):
        if not t.is_contiguous() or t.device != vt.device:
            raise ValueError(f"lowrank_matmul: {name} must be contiguous "
                             f"and on {vt.device}")
    _check_knobs(expansion, n_block)
    h, n = w.shape
    m = vt.numel() // max(h, 1)
    shape = vt.shape[:-1] + (n,)
    if m == 0 or n == 0 or h == 0:
        return torch.zeros(shape, device=vt.device, dtype=vt.dtype)
    if not reaches(h, expansion):
        raise ValueError(f"lowrank_matmul: expansion {expansion} cuts H={h} "
                         f"(vt {tuple(vt.shape)}, w {tuple(w.shape)}) into "
                         f"splits of {split_rows(h, expansion)} rows, "
                         f"shorter than the kernel's {STAGE_ROWS}-row stage")
    out = torch.empty(shape, device=vt.device, dtype=vt.dtype)
    lib = _lib()
    f = expansion or 0
    part = tk = None
    floats = lib.dcom_lrmm_scratch_floats(m, n, f)
    if floats:                    # past the cluster: a ticket per tile
        part = torch.empty(floats, device=vt.device, dtype=torch.float32)
        tk = tickets(vt.device, lib.dcom_lrmm_tickets(m, n), "lrmm")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = lib.dcom_lrmm_f32 if vt.dtype == torch.float32 \
        else lib.dcom_lrmm_bf16
    err = fn(vt.data_ptr(), w.data_ptr(), out.data_ptr(), m, h, n,
             sm_count(vt.device.index), f, n_block or 0, ptr(part), ptr(tk),
             torch.cuda.current_stream(vt.device).cuda_stream)
    if err:
        raise RuntimeError(f"lowrank_matmul kernel launch failed "
                           f"(cudaError or, for its tensor maps, CUresult "
                           f"{err})")
    lowrank_matmul.launches += 1
    return out


lowrank_matmul.launches = 0


# -- tunable space (see repro_torch.tune): the Eq. 6 GEMM operating point;
# the default names the reference's, a call without knobs runs the card's
# plan ----------------------------------------------------------------------
from ..tune.space import (BLOCK_GRID, EXPANSION_GRID,  # noqa: E402
                          TunableParam, TunableSpace, register_space)

register_space(TunableSpace("lowrank_matmul", (
    TunableParam("expansion", EXPANSION_GRID, default=8),
    TunableParam("n_block", BLOCK_GRID, default=512),
)))
