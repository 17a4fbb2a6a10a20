"""Fused Lanczos re-orthogonalization steps (paper §5.3), CUDA on the card.

Counterpart of ``repro.kernels.lanczos_reorth.reorth_right_batched`` /
``reorth_left_batched``:

* right: z_b = CGS2(A_bᵀ u_b, V_b) → (z [B, H], ‖z‖² [B])
* left : w_b = CGS2(A_b v_b, U_b)  → (w [B, S], ‖w‖² [B])

and the scalar ``reorth_right``/``reorth_left`` (one A [S, H]), which are
B = 1 calls of the batched kernels, not kernels of their own.

Each wrapper dispatches on the device of ``a``: a CPU tensor takes the
plain PyTorch version beside it; a CUDA tensor launches the kernel in
``csrc/lanczos_reorth.cu`` (one CTA per batch element, ``expansion``
warps each) or raises — there is no fallback.  ``launches`` on each
wrapper counts its kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..core.lanczos import _reorth_cgs2_batched as _cgs2
from .build import SMEM_LIMIT, library

Pair = Tuple[torch.Tensor, torch.Tensor]


def reorth_right_batched_plain(a, u, v_buf) -> Pair:
    """Plain version: z = CGS2(Aᵀu, V), float32."""
    z = _cgs2(torch.einsum("bsh,bs->bh", a.float(), u.float()), v_buf.float())
    return z, (z * z).sum(-1)


def reorth_left_batched_plain(a, v, u_buf) -> Pair:
    """Plain version: w = CGS2(A v, U), float32."""
    w = _cgs2(torch.einsum("bsh,bh->bs", a.float(), v.float()), u_buf.float())
    return w, (w * w).sum(-1)


_BOUND = False


def _lib() -> ctypes.CDLL:
    global _BOUND
    lib = library("lanczos_reorth")
    if not _BOUND:
        vp, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.dcom_reorth_right_f32, lib.dcom_reorth_left_f32):
            fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, vp]
            fn.restype = i
        lib.dcom_reorth_smem_bytes.argtypes = [i, i, i, i]
        lib.dcom_reorth_smem_bytes.restype = ctypes.c_size_t
        lib.dcom_reorth_max_k.restype = i
        _BOUND = True
    return lib


def _launch(side: str, a, x, q, n_out: int, expansion: int) -> Pair:
    if a.device.type != "cuda":
        raise ValueError(f"reorth_{side}_batched: unsupported device "
                         f"{a.device}")
    b, s, h = a.shape
    k = q.shape[-1]
    for name, t in (("a", a), ("vector", x), ("basis", q)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != a.device:
            raise ValueError(f"reorth_{side}_batched: {name} must be a "
                             f"contiguous float32 tensor on {a.device}, got "
                             f"{t.dtype} contiguous={t.is_contiguous()} "
                             f"on {t.device}")
    vec_len = s if side == "right" else h
    if tuple(x.shape) != (b, vec_len) or q.dim() != 3 \
            or tuple(q.shape[:2]) != (b, n_out):
        raise ValueError(f"reorth_{side}_batched: shapes a {tuple(a.shape)}, "
                         f"vector {tuple(x.shape)}, basis {tuple(q.shape)} "
                         f"do not match")
    warps = int(expansion)
    if not 1 <= warps <= 32:
        raise ValueError(f"expansion (warps per CTA) must be in 1..32, "
                         f"got {expansion}")
    lib = _lib()
    if k > lib.dcom_reorth_max_k():
        raise ValueError(f"reorth kernel takes at most "
                         f"{lib.dcom_reorth_max_k()} basis columns, got {k}")
    smem = lib.dcom_reorth_smem_bytes(s, h, k, warps)
    if smem > SMEM_LIMIT:
        raise ValueError(f"reorth_{side}_batched: S={s}, H={h}, k={k} needs "
                         f"{smem} B of shared memory per block "
                         f"(limit {SMEM_LIMIT})")
    out = torch.empty(b, n_out, device=a.device, dtype=torch.float32)
    nrm = torch.empty(b, device=a.device, dtype=torch.float32)
    fn = lib.dcom_reorth_right_f32 if side == "right" \
        else lib.dcom_reorth_left_f32
    err = fn(a.data_ptr(), x.data_ptr(), q.data_ptr(), out.data_ptr(),
             nrm.data_ptr(), b, s, h, k, warps,
             torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"reorth_{side}_batched kernel launch failed "
                           f"(cudaError {err})")
    return out, nrm


def reorth_right_batched(a, u, v_buf, *, expansion: int = 32) -> Pair:
    """z_b = CGS2(A_bᵀu_b, V_b) for a [B,S,H], u [B,S], v_buf [B,H,k]."""
    if a.device.type == "cpu":
        return reorth_right_batched_plain(a, u, v_buf)
    out = _launch("right", a, u, v_buf, a.shape[2], expansion)
    reorth_right_batched.launches += 1
    return out


def reorth_left_batched(a, v, u_buf, *, expansion: int = 32) -> Pair:
    """w_b = CGS2(A_b v_b, U_b) for a [B,S,H], v [B,H], u_buf [B,S,k]."""
    if a.device.type == "cpu":
        return reorth_left_batched_plain(a, v, u_buf)
    out = _launch("left", a, v, u_buf, a.shape[1], expansion)
    reorth_left_batched.launches += 1
    return out


reorth_right_batched.launches = 0
reorth_left_batched.launches = 0


def reorth_right(a, u, v_buf, *, expansion: int = 32) -> Pair:
    """z = CGS2(Aᵀu, V) for a [S,H], u [S], v_buf [H,k] → (z [H], ‖z‖²):
    a B = 1 call of :func:`reorth_right_batched`."""
    z, nrm = reorth_right_batched(a[None], u[None], v_buf[None],
                                  expansion=expansion)
    return z[0], nrm[0]


def reorth_left(a, v, u_buf, *, expansion: int = 32) -> Pair:
    """w = CGS2(A v, U) for a [S,H], v [H], u_buf [S,k] → (w [S], ‖w‖²):
    a B = 1 call of :func:`reorth_left_batched`."""
    w, nrm = reorth_left_batched(a[None], v[None], u_buf[None],
                                 expansion=expansion)
    return w[0], nrm[0]


# -- tunable space (see repro_torch.tune): f is the warps per CTA here ------
from ..tune.space import (EXPANSION_GRID, TunableParam,  # noqa: E402
                          TunableSpace, register_space)

register_space(TunableSpace("lanczos_reorth", (
    TunableParam("expansion", EXPANSION_GRID, default=32),
    TunableParam("backend", ("cuda", "reference"), default="cuda"),
    TunableParam("reorth", ("cgs2",), default="cgs2"),
)))
