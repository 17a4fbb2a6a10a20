"""Truncated SVD by Golub–Kahan–Lanczos bidiagonalization, float32.

The algorithm the paper decomposes with (its Algorithm 1), as the port
documents it: ``iters`` steps from the unit start vector z0/‖z0‖,
full re-orthogonalization of every new direction against all earlier
ones, twice (classical Gram–Schmidt, twice), a direction whose norm is
at most 1e-8 set to zero, then the SVD of the small upper-bidiagonal
matrix and the bases rotated by its singular vectors.  z0 is the port's
documented start direction: ``numpy.random.RandomState(0)``'s first
``width`` standard normal draws.  With padding rows of zeros the factors
of the unpadded rows do not change, so prompts of different lengths
batch.
"""
from __future__ import annotations

import numpy as np
import torch

EPS = 1e-8


def start_vector(width: int, device) -> torch.Tensor:
    z = np.random.RandomState(0).standard_normal(width).astype(np.float32)
    return torch.from_numpy(z).to(device)


def _unit(x: torch.Tensor):
    n = torch.linalg.vector_norm(x, dim=-1)
    ok = n > EPS
    scale = torch.where(ok, 1.0 / n.clamp(min=EPS), torch.zeros_like(n))
    return x * scale[:, None], torch.where(ok, n, torch.zeros_like(n))


def _reorth(z: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """z [B, N] minus its projection on the columns of q [B, N, j],
    twice."""
    for _ in range(2):
        z = z - torch.einsum("bnj,bj->bn", q,
                             torch.einsum("bnj,bn->bj", q, z))
    return z


def svd(a: torch.Tensor, rank: int, iters: int):
    """a [B, S, H] float32 → (U·Σ [B, S, rank], Vᵀ [B, rank, H])."""
    a = a.float()
    b, s, h = a.shape
    z0 = start_vector(h, a.device).expand(b, h)
    us = torch.zeros(b, s, iters, device=a.device)
    vs = torch.zeros(b, h, iters, device=a.device)
    alpha = torch.zeros(b, iters, device=a.device)
    beta = torch.zeros(b, iters, device=a.device)
    v, _ = _unit(z0)
    vs[..., 0] = v
    u, alpha[:, 0] = _unit(_reorth(torch.einsum("bsh,bh->bs", a, v),
                                   us[..., :0]))
    us[..., 0] = u
    for j in range(1, iters):
        v, beta[:, j - 1] = _unit(_reorth(
            torch.einsum("bsh,bs->bh", a, u), vs[..., :j]))
        vs[..., j] = v
        u, alpha[:, j] = _unit(_reorth(
            torch.einsum("bsh,bh->bs", a, v), us[..., :j]))
        us[..., j] = u
    bid = torch.diag_embed(alpha) + torch.diag_embed(beta[:, :-1], offset=1)
    p, sig, qt = torch.linalg.svd(bid)
    u_r = torch.einsum("bsk,bkr->bsr", us, p[..., :rank]) * sig[:, None,
                                                                 :rank]
    vt_r = torch.einsum("brk,bhk->brh", qt[:, :rank], vs)
    return u_r, vt_r


def truncate(left: torch.Tensor, right_t: torch.Tensor, rank: int):
    """The best rank-``rank`` approximation of left @ right_t (left
    [S, k], right_t [k, H]) through two thin QRs and one small SVD →
    (U·Σ [S, rank], Vᵀ [rank, H])."""
    qa, ra = torch.linalg.qr(left.float())
    qb, rb = torch.linalg.qr(right_t.float().t())
    p, sig, wt = torch.linalg.svd(ra @ rb.t())
    return (qa @ p[:, :rank]) * sig[:rank], wt[:rank] @ qb.t()
