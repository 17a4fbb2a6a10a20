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
``ssd_chunk_intra.launches`` counts its kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .build import library


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
        lib.dcom_ssd_chunk_intra_f32.argtypes = [vp, vp, vp, vp, vp,
                                                 i, i, i, i, vp]
        lib.dcom_ssd_chunk_intra_f32.restype = i
        _BOUND = True
    return lib


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
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    err = _lib().dcom_ssd_chunk_intra_f32(
        cb.data_ptr(), l.data_ptr(), dt.data_ptr(), x.data_ptr(),
        y.data_ptr(), g, q, nh, hd,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_chunk_intra kernel launch failed "
                           f"(cudaError {err})")
    ssd_chunk_intra.launches += 1
    return y


ssd_chunk_intra.launches = 0
