"""Channel-wise outlier statistics (paper §4), CUDA on the card.

Counterpart of ``repro.kernels.outlier_extract.outlier_stats``: per
prompt and channel of X [..., S, H], count(|x| > T) and max |x| over the
S token rows, both float32 [..., H].  They feed the outlier-channel
selection of ``core.outlier``.

The wrapper dispatches on the device of ``x``: a CPU tensor takes the
plain PyTorch version beside it; a CUDA tensor launches the kernel in
``csrc/outlier_extract.cu`` or raises — there is no fallback.
``outlier_stats.launches`` counts its kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .build import library

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
        lib.dcom_outlier_stats_f32.argtypes = [vp, ctypes.c_float, vp, vp,
                                               i, i, i, vp]
        lib.dcom_outlier_stats_f32.restype = i
        _BOUND = True
    return lib


def outlier_stats(x: torch.Tensor, threshold: float) -> Pair:
    """(count(|x| > T), max |x|) over the token rows of x [..., S, H]
    float32 → float32 [..., H] each."""
    if x.device.type == "cpu":
        return outlier_stats_plain(x, threshold)
    if x.device.type != "cuda":
        raise ValueError(f"outlier_stats: unsupported device {x.device}")
    if x.dim() < 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"outlier_stats: x must be a contiguous float32 "
                         f"[..., S, H] tensor, got {x.dtype} "
                         f"{tuple(x.shape)} contiguous={x.is_contiguous()}")
    s, h = x.shape[-2:]
    if s >= MAX_ROWS:
        raise ValueError(f"outlier_stats: S={s} rows would make float32 "
                         f"counts inexact (limit {MAX_ROWS})")
    lead = x.shape[:-2]
    b = x.numel() // max(s * h, 1)
    out = torch.zeros((2,) + lead + (h,), device=x.device,
                      dtype=torch.float32)
    if x.numel() == 0:
        return out[0], out[1]
    err = _lib().dcom_outlier_stats_f32(
        x.data_ptr(), float(threshold), out[0].data_ptr(),
        out[1].data_ptr(), b, s, h,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"outlier_stats kernel launch failed "
                           f"(cudaError {err})")
    outlier_stats.launches += 1
    return out[0], out[1]


outlier_stats.launches = 0
