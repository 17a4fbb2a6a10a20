"""Fused Lanczos re-orthogonalization steps (paper §5.3), CUDA on the card.

Counterpart of ``repro.kernels.lanczos_reorth.reorth_right_batched`` /
``reorth_left_batched``:

* right: z_b = CGS2(A_bᵀ u_b, V_b) → (z [B, H], ‖z‖² [B])
* left : w_b = CGS2(A_b v_b, U_b)  → (w [B, S], ‖w‖² [B])

and the scalar ``reorth_right``/``reorth_left`` (one A [S, H]), which are
B = 1 calls of the batched kernels, not kernels of their own.

Each wrapper dispatches on the device of ``a``: a CPU tensor takes the
plain PyTorch version beside it; a CUDA tensor launches the kernel in
``csrc/lanczos_reorth.cu`` or raises — there is no fallback.
``expansion`` (f, 1..32) is the number of blocks along the output axis
N (H for right, S for left), as in the JAX kernel; one batch element is
a thread-block cluster of :func:`cluster_ctas` (f) = min(f, 16) CTAs,
each owning blocks c, c + 16, ...  ``launches`` on each wrapper counts
its kernel launches.
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


MAX_CLUSTER = 16      # CTAs of one batch element's cluster (kMaxCluster)
DEFAULT_EXPANSION = 16


def cluster_ctas(expansion: int) -> int:
    """CTAs of the cluster that holds one batch element at f blocks."""
    return min(int(expansion), MAX_CLUSTER)


def resident_clusters(side: str, s: int, h: int, k: int,
                      expansion: int) -> int:
    """Clusters of one batch element the current card holds at once
    (``cudaOccupancyMaxActiveClusters`` for the launch at this shape)."""
    n = _lib().dcom_reorth_max_clusters(0 if side == "right" else 1, s, h,
                                        k, int(expansion))
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed "
                           f"(cudaError {-n})")
    return n


def _rup(a: int, b: int) -> int:
    return -(-a // b) * b


def q_in_smem(side: str, s: int, h: int, k: int, expansion: int) -> bool:
    """Whether each CTA keeps its Q rows in shared memory, so that Q is
    read from device memory once: ``plan()`` of ``csrc/lanczos_reorth.cu``
    (its layout in floats: the input vector, the CTA's z rows, two
    [f, k] partial tables, 32 norms, the reduction scratch and p; then Q
    in rows of an odd number of 16-byte chunks beside a ring of at least
    three 32 KB stages)."""
    f = int(expansion)
    n = h if side == "right" else s
    blk, mine = -(-n // f), -(-f // cluster_ctas(f))
    if side == "right":
        w = min(_rup(blk + 3 if blk % 4 else blk, 4), 1024)
        nbox = -(-w // 256)
        boxc = _rup(-(-w // nbox), 4)
        rows = max(1, min(256, 32768 // (nbox * boxc * 4)))
        stage, vec = _rup(nbox * _rup(rows * boxc, 32), 256), s
    else:
        br = 8
        while br < 256 and br < blk:
            br <<= 1
        cols = 256 // br * 32
        stage, vec = 8192, _rup(h, cols)
    floats = _rup(vec, 4) + _rup(mine * blk, 4) + 2 * _rup(f * k, 4) + 32 \
        + max(8 * k, 1024) + _rup(k, 4)
    fixed = 1024 + 4 * floats
    qp = 4 * (-(-k // 4) | 1)         # 16-byte rows, an odd number
    return fixed + 4 * mine * blk * qp + 3 * 4 * stage <= SMEM_LIMIT - 1024


_BOUND = False


def _lib() -> ctypes.CDLL:
    global _BOUND
    lib = library("lanczos_reorth")
    if not _BOUND:
        vp, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.dcom_reorth_right_f32, lib.dcom_reorth_left_f32):
            fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, vp]
            fn.restype = i
        for fn in (lib.dcom_reorth_smem_bytes, lib.dcom_reorth_q_in_smem):
            fn.argtypes = [i, i, i, i, i]
        lib.dcom_reorth_smem_bytes.restype = ctypes.c_size_t
        lib.dcom_reorth_q_in_smem.restype = i
        lib.dcom_reorth_max_clusters.argtypes = [i, i, i, i, i]
        lib.dcom_reorth_max_clusters.restype = i
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
    f = int(expansion)
    if not 1 <= f <= 32:
        raise ValueError(f"expansion (blocks along the output axis) must be "
                         f"in 1..32, got {expansion}")
    lib = _lib()
    if k > lib.dcom_reorth_max_k():
        raise ValueError(f"reorth kernel takes at most "
                         f"{lib.dcom_reorth_max_k()} basis columns, got {k}")
    side_code = 0 if side == "right" else 1
    smem = lib.dcom_reorth_smem_bytes(side_code, s, h, k, f)
    if not 0 < smem <= SMEM_LIMIT:
        raise ValueError(f"reorth_{side}_batched: S={s}, H={h}, k={k} at "
                         f"f={f} does not fit the shared memory of one CTA "
                         f"(limit {SMEM_LIMIT} B)")
    out = torch.empty(b, n_out, device=a.device, dtype=torch.float32)
    nrm = torch.empty(b, device=a.device, dtype=torch.float32)
    fn = lib.dcom_reorth_right_f32 if side == "right" \
        else lib.dcom_reorth_left_f32
    err = fn(a.data_ptr(), x.data_ptr(), q.data_ptr(), out.data_ptr(),
             nrm.data_ptr(), b, s, h, k, f,
             torch.cuda.current_stream(a.device).cuda_stream)
    if err == -1:
        raise RuntimeError(f"reorth_{side}_batched: the card cannot place a "
                           f"cluster of {cluster_ctas(f)} CTAs with {smem} B "
                           f"of shared memory each")
    if err:
        raise RuntimeError(f"reorth_{side}_batched kernel launch failed "
                           f"(cudaError {err})")
    return out, nrm


def reorth_right_batched(a, u, v_buf, *,
                         expansion: int = DEFAULT_EXPANSION) -> Pair:
    """z_b = CGS2(A_bᵀu_b, V_b) for a [B,S,H], u [B,S], v_buf [B,H,k]."""
    if a.device.type == "cpu":
        return reorth_right_batched_plain(a, u, v_buf)
    out = _launch("right", a, u, v_buf, a.shape[2], expansion)
    reorth_right_batched.launches += 1
    return out


def reorth_left_batched(a, v, u_buf, *,
                        expansion: int = DEFAULT_EXPANSION) -> Pair:
    """w_b = CGS2(A_b v_b, U_b) for a [B,S,H], v [B,H], u_buf [B,S,k]."""
    if a.device.type == "cpu":
        return reorth_left_batched_plain(a, v, u_buf)
    out = _launch("left", a, v, u_buf, a.shape[1], expansion)
    reorth_left_batched.launches += 1
    return out


reorth_right_batched.launches = 0
reorth_left_batched.launches = 0


def reorth_right(a, u, v_buf, *, expansion: int = DEFAULT_EXPANSION) -> Pair:
    """z = CGS2(Aᵀu, V) for a [S,H], u [S], v_buf [H,k] → (z [H], ‖z‖²):
    a B = 1 call of :func:`reorth_right_batched`."""
    z, nrm = reorth_right_batched(a[None], u[None], v_buf[None],
                                  expansion=expansion)
    return z[0], nrm[0]


def reorth_left(a, v, u_buf, *, expansion: int = DEFAULT_EXPANSION) -> Pair:
    """w = CGS2(A v, U) for a [S,H], v [H], u_buf [S,k] → (w [S], ‖w‖²):
    a B = 1 call of :func:`reorth_left_batched`."""
    w, nrm = reorth_left_batched(a[None], v[None], u_buf[None],
                                 expansion=expansion)
    return w[0], nrm[0]


# -- tunable space (see repro_torch.tune): f is the blocks along the output
# axis, as in JAX; revision 1 is the cluster kernel (tuning-cache entries of
# revision 0 named f in warps per CTA and are not reused) -------------------
from ..tune.space import (EXPANSION_GRID, TunableParam,  # noqa: E402
                          TunableSpace, register_space)

register_space(TunableSpace("lanczos_reorth", (
    TunableParam("expansion", EXPANSION_GRID, default=DEFAULT_EXPANSION),
    TunableParam("backend", ("cuda", "reference"), default="cuda"),
    TunableParam("reorth", ("cgs2",), default="cgs2"),
)), revision=1)
