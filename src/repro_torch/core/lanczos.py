"""Batched Golub–Kahan Lanczos bidiagonalization (paper Algorithm 1).

Counterpart of ``repro.core.lanczos`` (the natively batched pipeline):
fixed ``iters`` steps, full CGS2 re-orthogonalization against
zero-padded U/V buffers (projecting on a not-yet-filled column is a
no-op), early exit replaced by a guard that zeroes a direction whose
norm falls below ``EPS``, float32 inside whatever the input dtype.

The two fused inner steps (matvec → CGS2) are hooks:
``kernels.ops.make_batched_hooks`` gives the re-orth kernels (CUDA on
the card, their plain versions — built on :func:`_reorth_cgs2_batched`
— on the host).  The U/V buffers are updated IN PLACE one column
per step — the JAX version rebuilds them functionally.

The start vector ``z0`` is an explicit argument: the JAX package draws
it from ``jax.random.normal(PRNGKey(0))``, which torch cannot replay, so
parity tests pass JAX's value in.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .lowrank import LowRank

EPS = 1e-8

Step = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


class BatchedLanczosHooks(NamedTuple):
    right_step: Step   # (A[B,S,H], u[B,S], V[B,H,k]) -> z = CGS2(Aᵀu, V) [B,H]
    left_step: Step    # (A[B,S,H], v[B,H], U[B,S,k]) -> w = CGS2(A v, U) [B,S]


def _reorth_cgs2_batched(z: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Batched CGS2: z [B, N], q [B, N, k] → z − Q(Qᵀz), twice."""
    for _ in range(2):
        p = torch.einsum("bnk,bn->bk", q, z)
        z = z - torch.einsum("bnk,bk->bn", q, p)
    return z


class BidiagResult(NamedTuple):
    u: torch.Tensor       # [B, S, k]
    v: torch.Tensor       # [B, H, k]
    alpha: torch.Tensor   # [B, k]   diagonal of B
    beta: torch.Tensor    # [B, k-1] superdiagonal of B


def _safe_normalize_batched(x: torch.Tensor):
    """Row-wise safe normalize: x [B, N] → (unit rows, norms [B])."""
    n = torch.linalg.vector_norm(x, dim=-1)
    ok = n > EPS
    inv = torch.where(ok, 1.0 / torch.clamp(n, min=EPS),
                      torch.zeros_like(n))
    return x * inv[:, None], torch.where(ok, n, torch.zeros_like(n))


def lanczos_bidiag_batched(a: torch.Tensor, iters: int, z0: torch.Tensor,
                           hooks: BatchedLanczosHooks) -> BidiagResult:
    """Golub–Kahan bidiagonalization of ``a [B, S, H]`` in ``iters`` steps.
    ``z0`` is [H] (broadcast over the batch) or [B, H]."""
    b_dim, s_dim, h_dim = a.shape
    dev = a.device
    a32 = a.to(torch.float32).contiguous()
    z0 = z0.to(device=dev, dtype=torch.float32).expand(b_dim, h_dim)

    f32 = dict(device=dev, dtype=torch.float32)
    u_buf = torch.zeros(b_dim, s_dim, iters, **f32)
    v_buf = torch.zeros(b_dim, h_dim, iters, **f32)
    alpha = torch.zeros(b_dim, iters, **f32)
    beta = torch.zeros(b_dim, max(iters - 1, 1), **f32)

    v0, _ = _safe_normalize_batched(z0.contiguous())
    u, a0 = _safe_normalize_batched(hooks.left_step(a32, v0, u_buf))
    u_buf[..., 0] = u
    v_buf[..., 0] = v0
    alpha[:, 0] = a0
    for j in range(1, iters):
        z, bt = _safe_normalize_batched(hooks.right_step(a32, u, v_buf))
        v_buf[..., j] = z
        beta[:, j - 1] = bt
        u, al = _safe_normalize_batched(hooks.left_step(a32, z, u_buf))
        u_buf[..., j] = u
        alpha[:, j] = al
    return BidiagResult(u_buf, v_buf, alpha, beta)


def bidiag_to_svd_batched(res: BidiagResult, rank: int):
    """SVD of the tiny k×k bidiagonal B; rotate the Lanczos bases.
    Returns (U [B, S, rank], s [B, rank], Vt [B, rank, H])."""
    k = res.alpha.shape[-1]
    bmat = torch.diag_embed(res.alpha)
    if k > 1:
        bmat = bmat + torch.diag_embed(res.beta[..., :k - 1], offset=1)
    p, s, qt = torch.linalg.svd(bmat)
    u = torch.einsum("bsk,bkr->bsr", res.u, p[..., :, :rank])
    vt = torch.einsum("brk,bhk->brh", qt[..., :rank, :], res.v)
    return u, s[..., :rank], vt


def decompose(x: torch.Tensor, rank: int, iters: Optional[int] = None, *,
              z0: torch.Tensor, hooks: BatchedLanczosHooks) -> LowRank:
    """x [..., S, H] → LowRank; every [S, H] slice decomposes on its own
    (paper §3.1) but the whole batch runs through one batched pipeline."""
    iters = rank if iters is None else iters
    if iters < rank:
        raise ValueError(f"need at least rank={rank} Lanczos iterations, "
                         f"got {iters}")
    batch_shape = x.shape[:-2]
    flat = x.reshape((-1,) + tuple(x.shape[-2:]))
    res = lanczos_bidiag_batched(flat, iters, z0, hooks)
    u, s, vt = bidiag_to_svd_batched(res, rank)
    u = u.reshape(batch_shape + u.shape[1:])
    s = s.reshape(batch_shape + s.shape[1:])
    vt = vt.reshape(batch_shape + vt.shape[1:])
    return LowRank(u.to(x.dtype), s.to(x.dtype), vt.to(x.dtype))
