"""Preserved-compute GEMM Vᵀ* = Vᵀ @ W (paper Eq. 6), CUDA on the card.

Counterpart of ``repro.kernels.lowrank_matmul.lowrank_matmul``:
Vᵀ [..., k, H] @ W [H, N] accumulated in float32.  The batch of Vᵀ is
flattened into M = B·k rows of one launch (the TPU kernel takes one
[k, H]).  The result is returned in ``vt.dtype``, as the einsum at
``repro/core/preserved.py:143`` returns it: the kernel accumulates in
float32 and rounds once, where it writes the output.

The wrapper dispatches on the device of ``vt``: a CPU tensor takes the
plain PyTorch version beside it; a CUDA tensor launches the kernel in
``csrc/lowrank_matmul.cu`` or raises — there is no fallback.
``lowrank_matmul.launches`` counts its kernel launches (the fixed-order
combine of the H splits, through the cluster's shared memory, is part of
the same launch).
"""
from __future__ import annotations

import ctypes

import torch

from .build import library, sm_count


def lowrank_matmul_plain(vt: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: float32 product, cast to ``vt.dtype``."""
    return (vt.float() @ w.float()).to(vt.dtype)


_BOUND = False


def _lib() -> ctypes.CDLL:
    global _BOUND
    lib = library("lowrank_matmul")
    if not _BOUND:
        vp, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.dcom_lrmm_f32, lib.dcom_lrmm_bf16):
            fn.argtypes = [vp, vp, vp, i, i, i, i, vp]
            fn.restype = i
        _BOUND = True
    return lib


def lowrank_matmul(vt: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Vᵀ [..., k, H] @ W [H, N] → [..., k, N] in ``vt.dtype``
    (float32 accumulation; both bfloat16 or both float32 on the card)."""
    if vt.device.type == "cpu":
        return lowrank_matmul_plain(vt, w)
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
    h, n = w.shape
    m = vt.numel() // max(h, 1)
    shape = vt.shape[:-1] + (n,)
    if m == 0 or n == 0 or h == 0:
        return torch.zeros(shape, device=vt.device, dtype=vt.dtype)
    out = torch.empty(shape, device=vt.device, dtype=vt.dtype)
    lib = _lib()
    fn = lib.dcom_lrmm_f32 if vt.dtype == torch.float32 \
        else lib.dcom_lrmm_bf16
    err = fn(vt.data_ptr(), w.data_ptr(), out.data_ptr(), m, h, n,
             sm_count(vt.device.index),
             torch.cuda.current_stream(vt.device).cuda_stream)
    if err:
        raise RuntimeError(f"lowrank_matmul kernel launch failed "
                           f"(cudaError or, for its tensor maps, CUresult "
                           f"{err})")
    lowrank_matmul.launches += 1
    return out


lowrank_matmul.launches = 0
