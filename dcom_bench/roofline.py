"""The yardstick's arithmetic: the card's peaks, each kernel's operations
and bytes at a launch's shapes, and the dense model's FLOPs.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity):
989 TFLOP/s bf16, 67 TFLOP/s float32 on the CUDA cores, 3.35 TB/s HBM3.
A launch's least time is the larger of operations over the peak rate
and bytes over the bandwidth; bytes count each input read once and each
output written once.  The re-orth and ``lowrank_matmul`` counts are
those the port's kernel table was measured against (a Lanczos step's
A [B, S, H] float32 with a basis of k columns; Vᵀ [k, H] @ W [H, N] in
bf16).
"""
from __future__ import annotations

from typing import Iterable, Tuple

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12


def bound_s(bytes_: float, flops: float, dtype: str) -> float:
    """Least seconds of a launch that moves ``bytes_`` and does ``flops``."""
    return max(bytes_ / HBM_BW, flops / PEAK_FLOPS[dtype])


def reorth(side: str, b: int, s: int, h: int, k: int) -> Tuple[float, float]:
    """(bytes, flops) of one fused re-orth launch (``side`` right: z =
    CGS2(Aᵀu, V) with V [B, H, k]; left: w = CGS2(A v, U), U [B, S, k])."""
    n, m = (h, s) if side == "right" else (s, h)
    bytes_ = 4 * (b * s * h + b * m + b * n * k + b * n + b)
    flops = 2 * b * s * h + 8 * b * n * k + 2 * b * n
    return float(bytes_), float(flops)


def reorth_bound_s(side: str, b: int, s: int, h: int, k: int) -> float:
    return bound_s(*reorth(side, b, s, h, k), "float32")


def lowrank_matmul(k: int, h: int, n: int) -> Tuple[float, float]:
    """(bytes, flops) of Vᵀ [k, H] @ W [H, N] in bf16."""
    return float(2 * (k * h + h * n + k * n)), float(2 * k * h * n)


def lowrank_matmul_bound_s(k: int, h: int, n: int) -> float:
    return bound_s(*lowrank_matmul(k, h, n), "bfloat16")


def projection_widths(cfg) -> Iterable[int]:
    """The output widths N of the projections a decomposed block sends
    through ``lowrank_matmul``, in launch order: Q, K, V, up (and gate)."""
    hd = cfg.resolved_head_dim
    out = [cfg.num_heads * hd, cfg.num_kv_heads * hd,
           cfg.num_kv_heads * hd, cfg.d_ff]
    if cfg.gated_mlp:
        out.append(cfg.d_ff)
    return out


def matmul_params(cfg) -> int:
    """Parameters that multiply a token's activations: every block's
    projections and the head over the real vocabulary."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh, kvh = cfg.num_heads, cfg.num_kv_heads
    per = d * nh * hd + 2 * d * kvh * hd + nh * hd * d
    per += (3 if cfg.gated_mlp else 2) * d * cfg.d_ff
    return cfg.num_layers * per + d * cfg.vocab


def prompt_flops(cfg, n: int) -> float:
    """Model FLOPs of a causal forward over ``n`` prompt tokens: 2 per
    parameter and token, plus QKᵀ and PV over the n(n+1)/2 causal pairs
    of every head and layer."""
    hd = cfg.resolved_head_dim
    attn = cfg.num_layers * 2 * n * (n + 1) * cfg.num_heads * hd
    return 2.0 * matmul_params(cfg) * n + attn


def decode_flops(cfg, tokens: int) -> float:
    """Model FLOPs of ``tokens`` decode tokens: 2 per parameter each."""
    return 2.0 * matmul_params(cfg) * tokens


def share_pct(bound: float, took: float) -> float:
    """A share of a bound in percent."""
    return 100.0 * bound / took


def mfu_pct(flops: float, seconds: float) -> float:
    """FLOPs over seconds as a share of the bf16 peak, in percent."""
    return 100.0 * flops / (seconds * PEAK_FLOPS["bfloat16"])


def per_launch_pattern(n: int, pattern) -> float:
    """Sum of per-launch bounds of ``n`` launches that repeat ``pattern``
    (a list of per-launch bounds in launch order)."""
    reps, rest = divmod(n, len(pattern))
    return reps * sum(pattern) + sum(pattern[:rest])
