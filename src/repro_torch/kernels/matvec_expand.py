"""Expanded matvec pair — the primitive of paper Fig. 12, CUDA on the card.

Counterpart of ``repro.kernels.matvec_expand``:

* ``matvec(a [S,H], v [H]) → y [S]`` and ``matvec_batched(a [B,S,H],
  v [B,H]) → y [B,S]``: y = A·v, the H reduction split ``expansion`` (f)
  ways, ``row_block`` rows per CTA;
* ``rmatvec(a [S,H], u [S]) → z [H]`` and ``rmatvec_batched(a [B,S,H],
  u [B,S]) → z [B,H]``: z = Aᵀ·u, the S reduction split f ways,
  ``col_block`` columns per CTA.

A and the vector are float32 or bfloat16, read as stored; sums and the
output are float32 (``_matvec_kernel``, ``matvec_expand.py:27-37``).
Split j covers ``[j·L, j·L + L)`` of the reduced axis with
L = :func:`split_len` (n/f rounded up to 8 elements); each split's
partial is a float32 sum and the f partials are added in block order, as
the TPU kernel accumulates its f grid steps.  Ragged shapes are masked,
never padded.  The scalar functions are B = 1 calls of the batched
kernels.

Each wrapper dispatches on the device of ``a``: a CPU tensor takes the
plain PyTorch version beside it; a CUDA tensor launches the kernels in
``csrc/matvec_expand.cu`` or raises — there is no fallback.  Each call is
one launch: every CTA streams its tile through a shared-memory ring fed
by TMA copies, and when f > 1 the last CTA of each row (column) block
adds the f partials.  ``launches`` on each of the four wrappers counts its
calls that launched.
"""
from __future__ import annotations

import ctypes

import torch

from .build import library, tickets

SPLIT_ALIGN = 8          # split length granule (16 bytes of bf16)
MAX_EXPANSION = 1024
MAX_COL_BLOCK = 4096     # one round of the rmatvec CTA's column vectors
MAX_GRID_YZ = 65535      # CUDA's limit on gridDim.y and gridDim.z
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def split_len(n: int, expansion: int) -> int:
    """Elements of the reduced axis per split: ceil(n / f) rounded up to
    :data:`SPLIT_ALIGN` (the last splits may be short or empty)."""
    per = -(-max(int(n), 1) // int(expansion))
    return -(-per // SPLIT_ALIGN) * SPLIT_ALIGN


def _check_expansion(expansion) -> int:
    f = int(expansion)
    if f != expansion or not 1 <= f <= MAX_EXPANSION:
        raise ValueError(f"expansion must be an int in 1..{MAX_EXPANSION}, "
                         f"got {expansion!r}")
    return f


def matvec_batched_plain(a, v, *, expansion: int = 8,
                         row_block: int = 512) -> torch.Tensor:
    """Plain version: per split of H a float32 product, the partials
    added in block order → y [B, S] float32."""
    f = _check_expansion(expansion)
    h = a.shape[-1]
    step = split_len(h, f)
    y = torch.zeros(a.shape[:-1], dtype=torch.float32, device=a.device)
    for lo in range(0, h, step):
        y = y + torch.einsum("bsh,bh->bs", a[..., lo:lo + step].float(),
                             v[:, lo:lo + step].float())
    return y


def rmatvec_batched_plain(a, u, *, expansion: int = 8,
                          col_block: int = 512) -> torch.Tensor:
    """Plain version: per split of S a float32 product, the partials
    added in block order → z [B, H] float32."""
    f = _check_expansion(expansion)
    s = a.shape[-2]
    step = split_len(s, f)
    z = torch.zeros(a.shape[0], a.shape[-1], dtype=torch.float32,
                    device=a.device)
    for lo in range(0, s, step):
        z = z + torch.einsum("bsh,bs->bh", a[:, lo:lo + step].float(),
                             u[:, lo:lo + step].float())
    return z


def matvec_plain(a, v, *, expansion: int = 8,
                 row_block: int = 512) -> torch.Tensor:
    return matvec_batched_plain(a[None], v[None], expansion=expansion,
                                row_block=row_block)[0]


def rmatvec_plain(a, u, *, expansion: int = 8,
                  col_block: int = 512) -> torch.Tensor:
    return rmatvec_batched_plain(a[None], u[None], expansion=expansion,
                                 col_block=col_block)[0]


_BOUND = False


def _lib() -> ctypes.CDLL:
    global _BOUND
    lib = library("matvec_expand")
    if not _BOUND:
        vp, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.dcom_matvec, lib.dcom_rmatvec):
            fn.argtypes = [i, i, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, vp]
            fn.restype = i
        _BOUND = True
    return lib


def _launch(name: str, a, x, expansion: int, block: int) -> torch.Tensor:
    """One launch of the kernel for a [B,S,H] and its vector x; ``name``
    is "matvec" or "rmatvec".  When f > 1 the last CTA of each row
    (column) block adds the f partials, taking a ticket from a per-device
    counter buffer that it leaves zeroed, so launches that share it run
    one after another on one stream."""
    if a.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {a.device}")
    f = _check_expansion(expansion)
    b, s, h = a.shape
    n_red, n_out = (h, s) if name == "matvec" else (s, h)
    if tuple(x.shape) != (b, n_red):
        raise ValueError(f"{name}: shapes a {tuple(a.shape)} and vector "
                         f"{tuple(x.shape)} do not match")
    for what, t in (("a", a), ("vector", x)):
        if t.dtype not in _DTYPES or not t.is_contiguous() \
                or t.device != a.device:
            raise ValueError(f"{name}: {what} must be a contiguous float32 "
                             f"or bfloat16 tensor on {a.device}, got "
                             f"{t.dtype} contiguous={t.is_contiguous()} on "
                             f"{t.device}")
    block = int(block)
    blocks = -(-n_out // max(block, 1))
    if block < 1 or (name == "rmatvec" and block > MAX_COL_BLOCK) \
            or blocks > MAX_GRID_YZ or b > MAX_GRID_YZ:
        raise ValueError(f"{name}: block {block} must be >= 1 (rmatvec: at "
                         f"most {MAX_COL_BLOCK} columns); {blocks} blocks "
                         f"and batch {b} must each be <= {MAX_GRID_YZ}")
    out = torch.empty(b, n_out, device=a.device, dtype=torch.float32)
    if a.numel() == 0:
        return out.zero_()
    split = split_len(n_red, f)
    part = torch.empty(b, f, n_out, device=a.device, dtype=torch.float32) \
        if f > 1 else None
    width = 16 // a.element_size()       # elements per 16-byte load of A
    vec = h % width == 0 and a.data_ptr() % 16 == 0 and (
        name == "matvec" or block % width == 0)
    block = min(block, n_out)      # the same grid; a tighter ring
    stream = torch.cuda.current_stream(a.device).cuda_stream
    tk = tickets(a.device, b * blocks, "matvec") if f > 1 else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    args = (_DTYPES[a.dtype], _DTYPES[x.dtype], a.data_ptr(), x.data_ptr(),
            ptr(part), ptr(tk), out.data_ptr(), b, s, h, f, split, block)
    fn = _lib().dcom_matvec if name == "matvec" else _lib().dcom_rmatvec
    err = fn(*args, int(vec), stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed (cudaError or, "
                           f"for its tensor map, CUresult {err})")
    return out


def matvec_batched(a, v, *, expansion: int = 8,
                   row_block: int = 512) -> torch.Tensor:
    """y[B,S] = A[B,S,H] @ v[B,H] with an f-way expanded H reduction."""
    if a.device.type == "cpu":
        return matvec_batched_plain(a, v, expansion=expansion,
                                    row_block=row_block)
    y = _launch("matvec", a, v, expansion, row_block)
    matvec_batched.launches += 1
    return y


def rmatvec_batched(a, u, *, expansion: int = 8,
                    col_block: int = 512) -> torch.Tensor:
    """z[B,H] = A[B,S,H]ᵀ @ u[B,S] with an f-way expanded S reduction."""
    if a.device.type == "cpu":
        return rmatvec_batched_plain(a, u, expansion=expansion,
                                     col_block=col_block)
    z = _launch("rmatvec", a, u, expansion, col_block)
    rmatvec_batched.launches += 1
    return z


def matvec(a, v, *, expansion: int = 8, row_block: int = 512
           ) -> torch.Tensor:
    """y[S] = A[S,H] @ v[H]: a B = 1 launch of the batched kernel."""
    if a.device.type == "cpu":
        return matvec_plain(a, v, expansion=expansion, row_block=row_block)
    y = _launch("matvec", a[None], v[None], expansion, row_block)[0]
    matvec.launches += 1
    return y


def rmatvec(a, u, *, expansion: int = 8, col_block: int = 512
            ) -> torch.Tensor:
    """z[H] = A[S,H]ᵀ @ u[S]: a B = 1 launch of the batched kernel."""
    if a.device.type == "cpu":
        return rmatvec_plain(a, u, expansion=expansion, col_block=col_block)
    z = _launch("rmatvec", a[None], u[None], expansion, col_block)[0]
    rmatvec.launches += 1
    return z


matvec.launches = 0
rmatvec.launches = 0
matvec_batched.launches = 0
rmatvec_batched.launches = 0


# -- tunable spaces (see repro_torch.tune): the Fig. 12 operating point ----
from ..tune.space import (BLOCK_GRID, EXPANSION_GRID,  # noqa: E402
                          TunableParam, TunableSpace, register_space)

register_space(TunableSpace("matvec_expand", (
    TunableParam("expansion", EXPANSION_GRID + (64, 128), default=8),
    TunableParam("row_block", BLOCK_GRID, default=512),
)))
# the transposed direction (z = Aᵀu, the Lanczos right step's product);
# the JAX package registers no space for it
register_space(TunableSpace("rmatvec_expand", (
    TunableParam("expansion", EXPANSION_GRID + (64, 128), default=8),
    TunableParam("col_block", BLOCK_GRID, default=512),
)))
