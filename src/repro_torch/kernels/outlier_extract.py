"""Channel-wise outlier statistics (paper §4), CUDA on the card.

Counterpart of ``repro.kernels.outlier_extract.outlier_stats``: per
prompt and channel of X [..., S, H] (float32 or bfloat16, as the
reference casts either), count(|x| > T) and max |x| over the S token
rows, both float32 [..., H].  They feed the outlier-channel selection of
``core.outlier``.

The wrapper dispatches on the device of ``x``: a CPU tensor takes the
plain PyTorch version beside it; a CUDA tensor launches the kernel in
``csrc/outlier_extract.cu`` or raises — there is no fallback.
``outlier_stats.launches`` counts its kernel launches; a call is one
launch (the S splits combine inside it, see the source).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .build import library, sm_count, tickets

Pair = Tuple[torch.Tensor, torch.Tensor]

MAX_ROWS = 1 << 24      # counts are float32 integers: exact below 2^24


def outlier_stats_plain(x: torch.Tensor, threshold: float) -> Pair:
    """Plain version: (count(|x| > T), max |x|) over S, float32 [..., H]."""
    a = x.float().abs()
    return (a > threshold).float().sum(-2), a.amax(-2)


_BOUND = False


def _lib() -> ctypes.CDLL:
    global _BOUND
    lib = library("outlier_extract")
    if not _BOUND:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.dcom_outlier_stats.argtypes = [vp, i, ctypes.c_float, vp, vp, vp,
                                           vp, i, i, i, i, vp]
        lib.dcom_outlier_stats.restype = i
        lib.dcom_outlier_splits.argtypes = [i, i, i, i, i]
        lib.dcom_outlier_splits.restype = i
        lib.dcom_outlier_tile.argtypes = [i]
        lib.dcom_outlier_tile.restype = i
        _BOUND = True
    return lib


def outlier_stats(x: torch.Tensor, threshold: float) -> Pair:
    """(count(|x| > T), max |x|) over the token rows of x [..., S, H]
    float32 or bfloat16 → float32 [..., H] each."""
    if x.device.type == "cpu":
        return outlier_stats_plain(x, threshold)
    if x.device.type != "cuda":
        raise ValueError(f"outlier_stats: unsupported device {x.device}")
    if x.dim() < 2 or x.dtype not in (torch.float32, torch.bfloat16) \
            or not x.is_contiguous():
        raise ValueError(f"outlier_stats: x must be a contiguous float32 or "
                         f"bfloat16 [..., S, H] tensor, got {x.dtype} "
                         f"{tuple(x.shape)} contiguous={x.is_contiguous()}")
    s, h = x.shape[-2:]
    if s >= MAX_ROWS:
        raise ValueError(f"outlier_stats: S={s} rows would make float32 "
                         f"counts inexact (limit {MAX_ROWS})")
    lead = x.shape[:-2]
    out = torch.empty((2,) + lead + (h,), device=x.device,
                      dtype=torch.float32)
    if x.numel() == 0:
        return out[0].zero_(), out[1].zero_()
    b = x.numel() // (s * h)
    lib, elem = _lib(), x.element_size()
    splits = lib.dcom_outlier_splits(elem, b, s, h, sm_count(x.device.index))
    tiles = -(-h // lib.dcom_outlier_tile(elem))
    part = torch.empty(2 * b * splits * h if splits > 1 else 1,
                       device=x.device, dtype=torch.float32)
    err = lib.dcom_outlier_stats(
        x.data_ptr(), elem, float(threshold), out[0].data_ptr(),
        out[1].data_ptr(), part.data_ptr(),
        tickets(x.device, b * tiles, "outlier").data_ptr(), b, s, h, splits,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"outlier_stats kernel launch failed "
                           f"(cudaError {err})")
    outlier_stats.launches += 1
    return out[0], out[1]


outlier_stats.launches = 0
