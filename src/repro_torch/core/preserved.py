"""Decomposition-preserved computation (paper §3.2).

Counterpart of ``repro.core.preserved``.  Once an activation
X ≈ U·Σ·Vᵀ exists, a linear layer Y = X·W is evaluated as Vᵀ* = Vᵀ·W
ONLY (Eq. 6), keeping the output in decomposed form (U, Σ, Vᵀ*).  For
input+weight decomposition (W ≈ U_w·Σ_w·Vᵀ_w) only the inner chain
Σ* = Σ_I · Vᵀ_I · U_W · Σ_W is evaluated (Eq. 7).

The skinny products Vᵀ @ W and Vᵀ_I @ (U_W Σ_W) are the same function and
go through the ``lowrank_matmul`` kernel (``kernels.lowrank_matmul``:
CUDA on the card, its plain version on the host or under the engine's
``"reference"`` backend — the ``matmul`` argument).  The outlier track
rides along: a dense [S, C] channel slice becomes, after a preserved
matmul by W, the factored pair (o_u = vals, o_vt = W[idx, :]).

Also here: the contraction-order planner and FLOP/ratio helpers (paper
Eq. 4/5, 8-12; pure Python) and the preserved-form attention
contractions (QKᵀ and P·V through the factors), which stay PyTorch
einsums as the JAX package leaves them to XLA.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..kernels.lowrank_matmul import lowrank_matmul as _lowrank_matmul_kernel
from .lowrank import LowRank, _ein, add_bias_rank, rank_concat

MatMul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


# ---------------------------------------------------------------------------
# FLOP accounting / contraction-order planner (paper Eq. 4, 5, 8, 9)
# ---------------------------------------------------------------------------

def matmul_flops(m: int, k: int, n: int) -> int:
    """MACs×2 for an [m,k]@[k,n] product."""
    return 2 * m * k * n


def chain_flops(dims: Sequence[int], order: Sequence[int]) -> int:
    """FLOPs of multiplying the matrix chain M0[d0,d1]·M1[d1,d2]·… in
    ``order`` (successive adjacent-pair indices into the current chain)."""
    dims = list(dims)
    total = 0
    for pos in order:
        total += matmul_flops(dims[pos], dims[pos + 1], dims[pos + 2])
        del dims[pos + 1]
    return total


def plan_chain(dims: Sequence[int]) -> Tuple[List[int], int]:
    """Optimal matrix-chain order by exhaustive DP (chains here are ≤ 6
    long).  Returns (order as successive adjacent-pair indices, FLOPs)."""
    dims = tuple(dims)
    if len(dims) - 1 == 1:
        return [], 0
    best = {}

    def solve(d: Tuple[int, ...]):
        if d in best:
            return best[d]
        if len(d) == 3:
            best[d] = ([0], matmul_flops(*d))
            return best[d]
        opt = None
        for pos in range(len(d) - 2):
            cost = matmul_flops(d[pos], d[pos + 1], d[pos + 2])
            sub_order, sub_cost = solve(d[:pos + 1] + d[pos + 2:])
            if opt is None or cost + sub_cost < opt[1]:
                opt = ([pos] + sub_order, cost + sub_cost)
        best[d] = opt
        return opt

    return solve(dims)


def compute_reduction_ratio_input_only(s: int, r2: int) -> float:
    """Paper Eq. 8: dense(S·D·W) / preserved(r2·D·W) = S / r2."""
    return s / r2


def compute_reduction_ratio_input_weight(s: int, d: int, w: int,
                                         r1: int, r2: int,
                                         p1: int, p2: int) -> float:
    """Paper Eq. 9 (denominator = preserved Eq. 7 chain cost)."""
    return s * d * w / (r2 * d * p1 + r2 * p1 * p2 + r1 * r2 * p2)


def activation_compression_ratio(s: int, d: int, r1: int, r2: int) -> float:
    """Paper Eq. 10 (with p→r): dense S·D vs factored storage."""
    return (s * d) / (s * r1 + r1 * r2 + r2 * d)


def weight_compression_ratio(d: int, w: int, p1: int, p2: int) -> float:
    """Paper Eq. 12."""
    return (d * w) / (d * p1 + p1 * p2 + p2 * w)


def weight_rank_break_even(d: int, w: int) -> float:
    """Paper Eq. 11: p below this bound ⇒ decomposed weight is smaller."""
    return (((d + w) ** 2 + 4 * d * w) ** 0.5 - (d + w)) / 2


# ---------------------------------------------------------------------------
# Preserved matmuls
# ---------------------------------------------------------------------------

def lowrank_matmul(lr: LowRank, w: torch.Tensor, *,
                   bias: Optional[torch.Tensor] = None,
                   matmul: Optional[MatMul] = None) -> LowRank:
    """Preserved-format (U·Σ·Vᵀ [+outliers]) @ W → LowRank (Eq. 6).

    Only Vᵀ* = Vᵀ @ W ([k2, N]) is computed, through ``matmul`` (default:
    the ``lowrank_matmul`` kernel wrapper).  The dense outlier track
    (o_dense [S, C] at channels o_idx) becomes the factored full-width
    pair (o_u = o_dense, o_vt = W[o_idx, :]), since
    scatter(o_dense, idx) @ W ≡ o_dense @ W[idx, :].  ``bias`` [N] is
    absorbed as one extra rank."""
    mm = matmul or _lowrank_matmul_kernel
    vt_new = mm(lr.vt.contiguous(), w)

    o_idx = o_u = o_core = o_vt = o_dense = None
    if lr.has_outliers:
        if lr.o_dense is not None and lr.o_idx is not None:
            o_u = lr.o_dense                              # [..., S, C]
            o_core = torch.ones(o_u.shape[:-2] + (o_u.shape[-1],),
                                dtype=o_u.dtype, device=o_u.device)
            o_vt = w[lr.o_idx].to(o_u.dtype)      # per prompt: [..., C, N]
        else:           # already a full-width factored track
            o_u, o_core = lr.o_u, lr.o_core
            o_vt = mm(lr.o_vt.to(w.dtype).contiguous(), w)

    y = LowRank(lr.u, lr.core, vt_new, o_idx, o_u, o_core, o_vt, o_dense)
    return y if bias is None else add_bias_rank(y, bias)


def lowrank_x_lowrank_weight(lr: LowRank, w_lr: LowRank, *,
                             matmul: Optional[MatMul] = None) -> LowRank:
    """Input+weight preserved product (paper Eq. 7).

    X @ W ≈ (U_I Σ_I Vᵀ_I)(U_W Σ_W Vᵀ_W) = U_I · [Σ_I (Vᵀ_I U_W) Σ_W] · Vᵀ_W
    with Σ* of shape [r1, p2]; Vᵀ_I · (U_W Σ_W) goes through ``matmul``."""
    mm = matmul or _lowrank_matmul_kernel
    su_w = w_lr.scaled_u() if w_lr.u.dim() == 2 else w_lr.u
    m = mm(lr.vt.contiguous(), su_w.to(lr.vt.dtype).contiguous())
    if lr.core_is_diag:
        core_new = lr.core.unsqueeze(-1) * m
    else:
        core_new = _ein("...kl,...lp->...kp", lr.core, m)

    o_idx = o_u = o_core = o_vt = o_dense = None
    if lr.has_outliers:
        if lr.o_dense is not None and lr.o_idx is not None:
            # outlier channels hit U_W rows idx: vals @ (U_W Σ_W)[idx] @ Vᵀ_W
            o_u = lr.o_dense
            o_core = w_lr.scaled_u()[lr.o_idx].to(o_u.dtype)
            o_vt = w_lr.vt.to(o_u.dtype)
            if o_core.dim() > 2:
                o_vt = o_vt.expand(o_core.shape[:-2] + w_lr.vt.shape)
        else:
            o_u, o_core = lr.o_u, lr.o_core
            inner = mm(lr.o_vt.contiguous(),
                       w_lr.scaled_u().to(lr.o_vt.dtype).contiguous())
            if lr.o_core is not None and lr.o_core.dim() == lr.o_u.dim() - 1:
                o_core = inner * lr.o_core.unsqueeze(-1)
            else:
                o_core = _ein("...kl,...lp->...kp", lr.o_core, inner)
            o_vt = w_lr.vt.to(o_u.dtype)

    vt_out = w_lr.vt
    if core_new.dim() > 2 and w_lr.vt.dim() == 2:
        vt_out = vt_out.expand(core_new.shape[:-2] + w_lr.vt.shape)
    return LowRank(lr.u, core_new, vt_out.to(lr.u.dtype),
                   o_idx, o_u, o_core, o_vt, o_dense)


def decompose_weight(w: torch.Tensor, rank: int) -> LowRank:
    """Offline weight decomposition by exact truncated SVD (offline cost
    is irrelevant; runtime decomposition is only for activations)."""
    u, s, vt = torch.linalg.svd(w.float(), full_matrices=False)
    return LowRank(u[..., :, :rank].to(w.dtype), s[..., :rank].to(w.dtype),
                   vt[..., :rank, :].to(w.dtype))


# ---------------------------------------------------------------------------
# Preserved-form attention contractions (PyTorch einsums)
# ---------------------------------------------------------------------------
# With Q = U_q Σ_q Vᵀ_q and K = U_k Σ_k Vᵀ_k, per-head scores factor
# through a tiny [kq, kk] inner matrix:
#   scores_h = U_q · (Σ_q Vᵀ_q,h · V_k,h Σ_k) · Uᵀ_k.

def preserved_qk_scores(q: LowRank, k: LowRank, num_heads: int,
                        scale: float,
                        num_kv_heads: Optional[int] = None) -> torch.Tensor:
    """Per-head attention scores from factored Q, K → [..., nh, S, T].
    GQA-aware (K may carry ``num_kv_heads`` < num_heads); outlier tracks
    are folded in exactly as extra rank."""
    kvh = num_kv_heads or num_heads
    g = num_heads // kvh
    uq, vq = _with_outlier_concat(q)     # [..., S, kq'], [..., kq', nh·dh]
    uk, vk = _with_outlier_concat(k)
    dh = vk.shape[-1] // kvh
    vq_h = vq.reshape(vq.shape[:-1] + (kvh, g, dh))
    vk_h = vk.reshape(vk.shape[:-1] + (kvh, dh))
    inner = _ein("...qkgd,...pkd->...kgqp", vq_h, vk_h)
    left = _ein("...sq,...kgqp->...kgsp", uq, inner)
    sc = _ein("...kgsp,...tp->...kgst", left, uk)
    shape = sc.shape[:-4] + (num_heads,) + sc.shape[-2:]
    return scale * sc.reshape(shape)


def preserved_pv(p: torch.Tensor, v: LowRank, num_heads: int,
                 num_kv_heads: Optional[int] = None) -> torch.Tensor:
    """probs [..., nh, S, T] × factored V → per-head out [..., S, nh·dh].
    P @ V = (P @ U_v) @ (Σ_v Vᵀ_v)_h; GQA-aware."""
    kvh = num_kv_heads or num_heads
    g = num_heads // kvh
    uv, vv = _with_outlier_concat(v)
    dh = vv.shape[-1] // kvh
    vv_h = vv.reshape(vv.shape[:-1] + (kvh, dh))
    pg = p.reshape(p.shape[:-3] + (kvh, g) + p.shape[-2:])
    pu = _ein("...kgst,...tp->...kgsp", pg, uv)
    out = _ein("...kgsp,...pkd->...skgd", pu, vv_h)
    return out.reshape(out.shape[:-3] + (num_heads * dh,))


def _with_outlier_concat(lr: LowRank) -> Tuple[torch.Tensor, torch.Tensor]:
    """(U·Σ, Vᵀ) with any outlier track folded in as extra rank columns.
    A channel-indexed dense track becomes one-hot Vᵀ rows (exact)."""
    su, vt = lr.scaled_u(), lr.vt
    if not lr.has_outliers:
        return su, vt
    if lr.o_dense is not None and lr.o_idx is not None:
        c, h = lr.o_idx.shape[-1], lr.hidden
        eye_rows = torch.zeros(lr.o_idx.shape[:-1] + (c, h), dtype=vt.dtype,
                               device=vt.device)
        eye_rows.scatter_(-1, lr.o_idx.unsqueeze(-1), 1.0)
        su = torch.cat([su, lr.o_dense.to(su.dtype)], dim=-1)
        vt = torch.cat([vt, eye_rows], dim=-2)
        return su, vt
    if lr.o_core.dim() == lr.o_u.dim() - 1:
        so = lr.o_u * lr.o_core.unsqueeze(-2)
    else:
        so = _ein("...sk,...kl->...sl", lr.o_u, lr.o_core)
    su = torch.cat([su, so.to(su.dtype)], dim=-1)
    vt = torch.cat([vt, lr.o_vt.to(vt.dtype)], dim=-2)
    return su, vt


def preserved_residual_add(lr: LowRank, residual: LowRank) -> LowRank:
    """Exact x + y for two LowRanks: rank-concat (grows rank; callers
    retruncate on a policy-chosen cadence)."""
    return rank_concat(lr, residual)
