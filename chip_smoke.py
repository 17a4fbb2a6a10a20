#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py              # every phase, one card
    python3 chip_smoke.py --profile    # also profile serving and one
                                       # decomposed forward

Phases (any failure exits non-zero; nothing is caught and passed over):

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of ``src/repro_torch/kernels/csrc`` with nvcc
   (all sources compile in parallel);
3. each kernel against its plain PyTorch version on the card, at the
   shapes decomposed-KV serving of llama2-7b gives it: max abs error
   within the stated tolerance, then CUDA-event times of the kernel, the
   plain version and a one-call PyTorch yardstick, and the bound (the
   least time the card could take: bytes over 3.35 TB/s or operations
   over the peak rate of the inputs' type, whichever is larger);
4. decomposed-KV serving of llama2-7b at full width and depth (random
   bf16 weights from a seed): 4 requests of 512/384/300/128 prompt
   tokens, two admitted while others decode, slots 4, rank 64, tail 16,
   32 new tokens each, max_len 1024.  Every request must finish, tails
   must fold, and each of the path's three kernels must have launched
   during the run; one decode step's logits through the kernel route are
   held against the plain ``_lowrank_attention`` route;
5. conformance on a small input: greedy tokens of decomposed-KV serving
   at full rank (direct SVD) equal dense serving on a reduced float32
   llama2 config, through the kernels;
6. the paper's activation-decomposition forward of llama2-7b at full
   width and depth on the same weights: tokens [1, 4096] from
   ``numpy.random.RandomState(0)``, the paper's best policy (the
   10-layer set, rank 20, 3 % outlier channels), threshold 3.0,
   ``attn_mode="dense"``.  The launch counts of one forward must be
   exactly 50 lowrank_matmul / 20 outlier_stats / 400 left / 380 right
   re-orth.  Route check against the same forward through the plain
   versions (``backend="reference"``): on each decomposition's own
   input both select the same channels (20 / 20); in bf16 the logits
   agree within 2e-2 free running (on two prompts) and with the plain
   route forced onto the kernel route's channels; in float32 (float32
   weights) every decomposition selects the same channels end to end
   and the logits agree within 1e-3.  One decomposition and one
   projection at layer 10's real input are held kernel against plain in
   float32; it prints the dense and decomposed forward times (median of
   3, CUDA events), KL(dense ‖ decomposed) and peak memory.

Phase 3 also holds the activation path's kernels (Eq. 6 GEMM, outlier
statistics, the B = 1 re-orth pair) against their plain versions at the
shapes phase 6 gives them.  The line before the last is
``{"kernels": [...]}``; the last line is ``{"ok": true, "device":
{...}}``.  Without CUDA, or without the package beside this script, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
HBM_BYTES_S = 3.35e12        # H100 SXM device memory rate
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # dense, per type


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms_cold(fn, iters: int = 20) -> float:
    """Median CUDA-event time of ``fn()`` with the 50 MB L2 flushed
    before each call (a 256 MiB buffer is overwritten), as on the main
    path, where other layers' work evicts the operands between calls."""
    import torch
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def to_float32(tree):
    """A float32 copy of a (nested dict) tree of tensors."""
    if isinstance(tree, dict):
        return {k: to_float32(v) for k, v in tree.items()}
    return tree.float()


def bound(bytes_: float, flops: float, dtype: str):
    t_bytes = bytes_ / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def reorth_case(side: str, b: int, s: int, h: int, k: int, filled: int,
                expansion: int, gen, scalar: bool = False):
    """Inputs of one Lanczos step: A [B,S,H] float32, a unit input vector,
    and a basis with ``filled`` orthonormal columns of ``k`` (the rest
    zero, as mid-iteration).  ``scalar`` times the B = 1 wrappers
    ``reorth_right``/``reorth_left`` (one A [S, H]) instead."""
    import torch
    from repro_torch.kernels import lanczos_reorth as lr
    dev = "cuda"
    a = torch.randn(b, s, h, generator=gen, device=dev)
    n, m = (h, s) if side == "right" else (s, h)
    x = torch.randn(b, m, generator=gen, device=dev)
    x = x / x.norm(dim=-1, keepdim=True)
    q = torch.zeros(b, n, k, device=dev)
    q[..., :filled] = torch.linalg.qr(
        torch.randn(b, n, filled, generator=gen, device=dev))[0]
    batched = getattr(lr, f"reorth_{side}_batched")
    plain = getattr(lr, f"reorth_{side}_batched_plain")
    if scalar:
        one = getattr(lr, f"reorth_{side}")
        a, x, q = a[0], x[0], q[0]
        kern = lambda: one(a, x, q, expansion=expansion)
        ref = lambda: tuple(t[0] for t in plain(a[None], x[None], q[None]))
    else:
        kern = lambda: batched(a, x, q, expansion=expansion)
        ref = lambda: plain(a, x, q)
    z_k, n_k = kern()
    z_p, n_p = ref()
    torch.cuda.synchronize()
    err = (z_k - z_p).abs().max().item()
    tol = 1e-4 * z_p.abs().max().item()
    nerr = ((n_k - n_p).abs() / n_p.abs()).max().item()
    name = f"reorth_{side}" if scalar else f"reorth_{side}_batched"
    if not err <= tol or not nerr <= 1e-4:
        raise AssertionError(
            f"{name} B={b}: max abs err {err:.3e} > {tol:.3e}"
            f" or norm rel err {nerr:.3e} > 1e-4")
    ms = time_ms(kern)
    plain_ms = time_ms(ref)
    bytes_ = 4 * (b * s * h + b * m + b * n * k + b * n + b)
    flops = 2 * b * s * h + 8 * b * n * k + 2 * b * n
    bms, by = bound(bytes_, flops, "float32")
    line = {("right", False): 233, ("left", False): 274,
            ("right", True): 318, ("left", True): 358}[(side, scalar)]
    return dict(name=name, route="cuda",
                source="src/repro_torch/kernels/csrc/lanczos_reorth.cu",
                replaces=f"src/repro/kernels/lanczos_reorth.py:{line}",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None,
                shape=dict(B=b, S=s, H=h, k=k, filled=filled,
                           expansion=expansion),
                tolerance="max|z_kernel - z_plain| <= 1e-4 max|z_plain|, "
                          "norm rel err <= 1e-4 (float32, reduction "
                          "order differs)")


def lowrank_matmul_case(k: int, h: int, n: int, gen):
    """Eq. 6 at the activation path's shapes: Vᵀ [1, k, H] @ W [H, N] in
    bf16 (the main path), then the float32 instantiation on the same
    values."""
    import torch
    from repro_torch.kernels import lowrank_matmul as lm
    dev = "cuda"
    vt = torch.randn(1, k, h, generator=gen, device=dev).bfloat16()
    w = (torch.randn(h, n, generator=gen, device=dev) * h ** -0.5).bfloat16()
    got = lm.lowrank_matmul(vt, w)
    want = lm.lowrank_matmul_plain(vt, w)
    got32 = lm.lowrank_matmul(vt.float(), w.float())
    want32 = lm.lowrank_matmul_plain(vt.float(), w.float())
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = 2 ** -7 * want.float().abs().max().item()
    err32 = (got32 - want32).abs().max().item()
    tol32 = 1e-4 * want32.abs().max().item()
    if not (err <= tol and err32 <= tol32):
        raise AssertionError(f"lowrank_matmul N={n}: bf16 err {err:.3e} "
                             f"(tol {tol:.3e}), float32 err {err32:.3e} "
                             f"(tol {tol32:.3e})")
    del got32, want32
    vt2 = vt[0]
    # L2-cold times first (W fits in the 50 MB L2 at N = 4096), then
    # back-to-back times, as in every row
    cold_ms = time_ms_cold(lambda: lm.lowrank_matmul(vt, w))
    lib_cold_ms = time_ms_cold(lambda: torch.matmul(vt2, w))
    ms = time_ms(lambda: lm.lowrank_matmul(vt, w))
    plain_ms = time_ms(lambda: lm.lowrank_matmul_plain(vt, w))
    lib_ms = time_ms(lambda: torch.matmul(vt2, w))
    bytes_ = 2 * (k * h + h * n + k * n)
    bms, by = bound(bytes_, 2 * k * h * n, "bfloat16")
    return dict(name="lowrank_matmul", route="cuda",
                source="src/repro_torch/kernels/csrc/lowrank_matmul.cu",
                replaces="src/repro/kernels/lowrank_matmul.py:59",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms,
                shape=dict(vt=[1, k, h], w=[h, n], dtype="bfloat16"),
                ms_l2_cold=cold_ms, library_ms_l2_cold=lib_cold_ms,
                max_abs_err_float32=err32,
                tolerance="bf16: <= 2^-7 max|plain| (one bf16 ulp: both "
                          "round float32 sums once); float32: <= 1e-4 "
                          "max|plain| (sum order differs)")


def outlier_stats_case(s: int, h: int, gen, threshold: float = 3.0):
    """Outlier statistics of one prompt X [1, S, H] float32 with 8
    planted outlier channels; both reductions are exact, so the kernel
    must equal the plain version bit for bit."""
    import torch
    from repro_torch.kernels import outlier_extract as oe
    dev = "cuda"
    x = torch.randn(1, s, h, generator=gen, device=dev)
    planted = torch.randperm(h, generator=gen, device=dev)[:8]
    x[..., planted] *= 4.0
    cnt, mx = oe.outlier_stats(x, threshold)
    cp, mp = oe.outlier_stats_plain(x, threshold)
    torch.cuda.synchronize()
    err = max((cnt - cp).abs().max().item(), (mx - mp).abs().max().item())
    if err != 0.0 or not (cnt[0, planted] > 0).all():
        raise AssertionError(f"outlier_stats: max abs err {err} (must be "
                             f"0) or a planted channel counted nothing")
    cold_ms = time_ms_cold(lambda: oe.outlier_stats(x, threshold))
    ms = time_ms(lambda: oe.outlier_stats(x, threshold))
    plain_ms = time_ms(lambda: oe.outlier_stats_plain(x, threshold))
    bms, by = bound(4 * s * h + 2 * 4 * h, 3 * s * h, "float32")
    return dict(name="outlier_stats", route="cuda",
                source="src/repro_torch/kernels/csrc/outlier_extract.cu",
                replaces="src/repro/kernels/outlier_extract.py:53",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None,
                shape=dict(x=[1, s, h], threshold=threshold,
                           planted_channels=8,
                           counted_channels=int((cnt > 0).sum().item())),
                ms_l2_cold=cold_ms,
                tolerance="exact (counts and maxima do not depend on the "
                          "order of reduction)")


def dkv_case(b: int, g: int, t: int, r: int, t_valid, dtype, gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import dkv_attention as dk
    dev = "cuda"
    inner = torch.randn(b, g, r, generator=gen, device=dev) * 0.5
    k_u = torch.randn(b, t, r, generator=gen, device=dev).to(dtype)
    v_u = torch.randn(b, t, r, generator=gen, device=dev).to(dtype)
    tv = torch.tensor(t_valid, dtype=torch.int32, device=dev)
    a_k, m_k, l_k = dk.dkv_attention_stats(inner, k_u, v_u, tv)
    a_p, m_p, l_p = dk.dkv_attention_stats_plain(inner, k_u, v_u, tv)
    torch.cuda.synchronize()
    err = (a_k - a_p).abs().max().item()
    tol = 1e-4 * a_p.abs().max().item()
    merr = (m_k - m_p).abs().max().item()
    lerr = ((l_k - l_p).abs() / l_p.abs()).max().item()
    if not (err <= tol and merr <= 1e-4 * m_p.abs().max().item()
            and lerr <= 1e-4):
        raise AssertionError(f"dkv_attention_stats: a err {err:.3e} (tol "
                             f"{tol:.3e}), m err {merr:.3e}, l rel err "
                             f"{lerr:.3e}")
    ms = time_ms(lambda: dk.dkv_attention_stats(inner, k_u, v_u, tv))
    plain_ms = time_ms(lambda: dk.dkv_attention_stats_plain(inner, k_u,
                                                            v_u, tv))
    # yardstick: one SDPA call over the same prefix rows (normalized a/l)
    mask = (torch.arange(t, device=dev)[None, :] < tv[:, None])[:, None, :]
    q4, k4, v4 = inner.to(dtype)[:, None], k_u[:, None], v_u[:, None]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask[:, None], scale=1.0))
    rows = sum(min(int(x), t) for x in t_valid)
    elt = k_u.element_size()
    bytes_ = 4 * b * g * r + 2 * rows * r * elt + 4 * b \
        + 4 * (b * g * r + 2 * b * g)
    flops = 4 * g * r * rows
    bms, by = bound(bytes_, flops, str(dtype).split(".")[-1])
    return dict(name="dkv_attention_stats", route="cuda",
                source="src/repro_torch/kernels/csrc/dkv_attention.cu",
                replaces="src/repro/kernels/dkv_attention.py:115",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms,
                shape=dict(B=b, G=g, T=t, r=r, t_valid=list(t_valid),
                           dtype=str(dtype)),
                tolerance="max|a_kernel - a_plain| <= 1e-4 max|a_plain|, "
                          "m abs err <= 1e-4 max|m|, l rel err <= 1e-4")


def phase_kernels(cfg):
    import torch
    from repro_torch.engine import EngineConfig
    expansion = EngineConfig().expansion
    gen = torch.Generator(device="cuda").manual_seed(0)
    kvw, rank = cfg.kv_width, 64
    iters = rank + 8              # decompose_kv: rank + kv_iters_extra
    rows = []
    for b in (cfg.num_layers, 4 * cfg.num_layers):      # 1 and 4 prompts
        for side in ("right", "left"):
            rec = reorth_case(side, b, 512, kvw, iters, iters // 2,
                              expansion, gen)
            print(json.dumps(rec), flush=True)
            rows.append(rec)
        torch.cuda.empty_cache()
    dkv = dkv_case(4, cfg.num_heads, 512, rank, (512, 384, 304, 128),
                   torch.bfloat16, gen)
    print(json.dumps(dkv), flush=True)
    rows.append(dkv)
    # the activation path (phase 6): one 4096-token prompt, rank 20
    h, seq, r = cfg.d_model, 4096, 20
    act = [lowrank_matmul_case(r, h, cfg.num_heads * cfg.resolved_head_dim,
                               gen),
           lowrank_matmul_case(r, h, cfg.d_ff, gen),
           outlier_stats_case(seq, h, gen)]
    for side in ("right", "left"):
        act.append(reorth_case(side, 1, seq, h, r, r // 2, expansion, gen,
                               scalar=True))
        torch.cuda.empty_cache()
    for rec in act:
        print(json.dumps(rec), flush=True)
    return rows + act


# ---------------------------------------------------------------------------
# Phase 4: serving llama2-7b at full width
# ---------------------------------------------------------------------------

def print_profile(prof) -> None:
    """The device's busy share of a profiled serving run and its kernel
    and operator time table, on standard output."""
    events = [e for e in prof.events()
              if e.device_type.name == "CUDA" and e.time_range.end > 0]
    if events:
        busy = sum(e.time_range.end - e.time_range.start for e in events)
        span = max(e.time_range.end for e in events) - min(
            e.time_range.start for e in events)
        print(f"profile: {len(events)} device kernels, summed device time "
              f"{busy / 1e3:.1f} ms over a {span / 1e3:.1f} ms span "
              f"(busy share {busy / max(span, 1):.3f})", flush=True)
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=25), flush=True)


SERVE_KERNELS = ("reorth_right_batched", "reorth_left_batched",
                 "dkv_attention_stats")


def init_llama(cfg):
    """Random bf16 weights of the full model from seed 0, on the card."""
    import torch
    from repro_torch.models import transformer as T
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = T.init(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    gib = T.param_bytes(params) / 2 ** 30
    print(f"init: {cfg.name} {cfg.num_layers} layers, {gib:.2f} GiB "
          f"{cfg.dtype} weights drawn in {time.perf_counter() - t0:.1f}s",
          flush=True)
    return params


def serve_llama(cfg, params, profile: bool = False):
    import numpy as np
    import torch
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.kernels import ops
    from repro_torch.serving import Engine, Request

    ecfg = EngineConfig(kv_rank=64, kv_tail=16)

    def engine():
        return Engine(cfg, params, slots=4, max_len=1024,
                      decompose_engine=DecomposeEngine(ecfg), device="cuda")

    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, n, dtype=np.int32)
               for n in (512, 384, 300, 128)]
    # warm-up: library handles and allocator, on a throwaway engine
    warm = engine()
    warm.submit(Request(uid=-1, prompt=prompts[3][:64], max_new_tokens=20))
    warm.run()
    del warm
    torch.cuda.synchronize()

    eng = engine()
    arrivals = {0: [0, 1], 3: [2], 6: [3]}   # two arrive mid-decode
    torch.cuda.reset_peak_memory_stats()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) if profile else None
    if prof is not None:
        prof.__enter__()
    ops.reset_launch_counts()
    done = []
    for step in range(2000):
        for i in arrivals.get(step, []):
            eng.submit(Request(uid=i, prompt=prompts[i], max_new_tokens=32))
        done.extend(eng.step())
        if len(done) == 4 and not eng._occupied():
            break
    torch.cuda.synchronize()
    if prof is not None:
        prof.__exit__(None, None, None)
        print_profile(prof)
    launches = ops.launch_counts()
    st = eng.stats
    if sorted(r.uid for r in done) != [0, 1, 2, 3]:
        raise AssertionError(f"unfinished requests: "
                             f"{[r.uid for r in done]}")
    for r in done:
        if len(r.out_tokens) != 32 or not all(
                0 <= t < cfg.vocab for t in r.out_tokens):
            raise AssertionError(f"req {r.uid}: bad tokens {r.out_tokens}")
    if st.tail_folds <= 0:
        raise AssertionError("no tail fold happened")
    if st.prefill_batches < 3:
        raise AssertionError("staggered requests were not admitted apart")
    missing = [k for k in SERVE_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing} ({launches})")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"serve: tokens={st.tokens_out} decode_steps={st.decode_steps} "
          f"folds={st.tail_folds} prefill_batches={st.prefill_batches} "
          f"prefill_s={st.prefill_s:.4f} decode_s={st.decode_s:.4f} "
          f"decode_tok/s={st.decode_tok_s:.2f} "
          f"mean_ttft_ms={st.mean_ttft_s * 1e3:.2f} "
          f"mean_itl_ms={st.mean_itl_s * 1e3:.2f} peak_mem_gib={peak:.2f}",
          flush=True)
    print("serve: launches " + json.dumps(launches), flush=True)

    check_decode_routes(cfg, params, prompts, ecfg)
    return launches, st


def check_decode_routes(cfg, params, prompts, ecfg):
    """One decode step through the kernel route vs the plain oracle route
    (``_lowrank_attention``) on a full-width prefilled cache (2 prompts of
    300 tokens, 14 of them already in the dense tail)."""
    import numpy as np
    import torch
    from repro_torch.engine import DecomposeEngine
    from repro_torch.models import decomposed_kv as DK
    toks = torch.from_numpy(np.stack([prompts[0][:286],
                                      prompts[1][:286]])).long().cuda()
    _, cache = DK.prefill_dkv(params, cfg, toks, 64, tail=16,
                              engine=DecomposeEngine(ecfg))
    frozen = torch.tensor([286, 200], dtype=torch.int32, device="cuda")
    pos = torch.tensor([300, 300], dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for key in ("k", "v"):
        cache["tail"][key].normal_(generator=gen)
    # (a) every layer's attention output, main-path bf16 cache
    q = torch.randn(2, 1, cfg.num_heads, cfg.resolved_head_dim,
                    generator=gen, device="cuda").bfloat16()
    worst = 0.0
    for i in range(cfg.num_layers):
        c = {k: cache[k][i] for k in ("k_u", "k_vt", "v_u", "v_vt")}
        tail = {k: cache["tail"][k][i] for k in ("k", "v")}
        o_k = DK._factored_attention(q, c, tail, pos, frozen, cfg)
        o_p = DK._lowrank_attention(q, c, tail, pos, frozen, cfg)
        worst = max(worst, ((o_k - o_p).norm() / o_p.norm()).item())
    if not worst <= 1e-4:
        raise AssertionError(f"attention routes differ: rel err {worst:.3e}")
    # (b) logits of one decode step, float32 weights and cache (so the
    # comparison sees the routes' float32 roundoff, not bf16 rounding
    # amplified through the layers)
    p32, c32 = to_float32(params), to_float32(cache)
    cfg32 = cfg.replace(dtype="float32")
    tok = torch.tensor([7, 11], device="cuda")
    lg_k, _ = DK.decode_step_dkv(p32, cfg32, tok, c32, pos, frozen)
    lg_p, _ = DK.decode_step_dkv(p32, cfg32, tok, c32, pos, frozen,
                                 attention="plain")
    del p32, c32
    lg_k, lg_p = lg_k[:, :cfg.vocab], lg_p[:, :cfg.vocab]
    rel = ((lg_k - lg_p).norm() / lg_p.norm()).item()
    if not (torch.isfinite(lg_k).all() and rel <= 1e-3):
        raise AssertionError(f"decode logits, kernel vs plain route: "
                             f"relative L2 error {rel:.3e} > 1e-3")
    print(f"serve: kernel vs plain decode route: attention rel err "
          f"{worst:.3e} over {cfg.num_layers} bf16 layers (tol 1e-4); "
          f"float32 logits rel L2 err {rel:.3e} (tol 1e-3), argmax equal "
          f"{bool((lg_k.argmax(-1) == lg_p.argmax(-1)).all())}", flush=True)


# ---------------------------------------------------------------------------
# Phase 5: dkv == dense greedy tokens on a small input
# ---------------------------------------------------------------------------

def conformance(cfg):
    import numpy as np
    import torch
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving import Engine, Request
    small = cfg.reduced().replace(dtype="float32")
    params = T.init(small, torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, small.vocab, n, dtype=np.int32)
               for n in (12, 7, 15)]

    def serve(**kw):
        eng = Engine(small, params, slots=2, max_len=64, device="cuda", **kw)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=12))
        return {r.uid: r.out_tokens for r in eng.run()}, eng.stats

    before = ops.launch_counts()["dkv_attention_stats"]
    dense, _ = serve()
    dkv, st = serve(decompose_engine=DecomposeEngine(EngineConfig(
        kv_rank=64, kv_tail=4, kv_exact=True)))
    if st.tail_folds <= 0 or \
            ops.launch_counts()["dkv_attention_stats"] <= before:
        raise AssertionError("conformance run did not fold or launch")
    if dkv != dense:
        raise AssertionError(f"dkv tokens {dkv} != dense tokens {dense}")
    print(f"conformance: dkv (exact, full rank) == dense greedy tokens on "
          f"{small.name} float32, {len(dense)} requests, "
          f"{st.tail_folds} folds", flush=True)


# ---------------------------------------------------------------------------
# Phase 6: the activation-decomposition forward of llama2-7b
# ---------------------------------------------------------------------------

ACT_LAUNCHES = {"lowrank_matmul": 50, "outlier_stats": 20,
                "reorth_left_batched": 400, "reorth_right_batched": 380,
                "dkv_attention_stats": 0}
ACT_LOGITS_TOL = 2e-2    # relative L2, bf16 kernel route vs plain route
ACT_F32_TOL = 1e-3       # the same, float32 weights and forward
ACT_SEQ = 4096           # the paper's 4K setting: tokens [1, ACT_SEQ]


def median_ms(fn, runs: int = 3):
    """Median of ``runs`` CUDA-event times of ``fn()`` (its result is
    dropped before the next run), with every run's time."""
    import torch
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), [round(t, 2) for t in times]


def _recording(engine, log, keep_input: bool):
    """Wrap ``engine.decompose_activation`` so each call appends (its
    input or None, the selected outlier channels) to ``log``."""
    orig = engine.decompose_activation

    def rec(x, *a, **kw):
        out = orig(x, *a, **kw)
        log.append((x if keep_input else None, out.o_idx))
        return out
    engine.decompose_activation = rec


def _forced_selection(log_k, agree):
    """A stand-in for ``select_outlier_channels`` that returns, call by
    call, the channels the kernel route selected (``log_k``), and appends
    to ``agree`` whether the plain selection on this call's own input is
    the same set."""
    import torch
    from repro_torch.core import outlier as ol
    real, picks = ol.select_outlier_channels, iter(log_k)

    def select(x, threshold, num_channels, stats=None):
        idx = next(picks)[1]
        agree.append(torch.equal(real(x, threshold, num_channels, stats),
                                 idx))
        return idx
    return select


def _route_gap(logits_k, logits_r, log_k, log_r) -> dict:
    """Logits relative L2 gap and outlier-set agreement of two routes."""
    import torch
    lk, lr_ = logits_k.float(), logits_r.float()
    same = [torch.equal(a[1], b[1]) for a, b in zip(log_k, log_r)]
    return dict(finite=bool(torch.isfinite(lk).all()
                            and torch.isfinite(lr_).all()),
                rel=((lk - lr_).norm() / lr_.norm()).item(),
                argmax=(lk.argmax(-1) == lr_.argmax(-1)).float().mean().item(),
                n=len(same), same=sum(same), first_equal=same[:1] == [True])


def activation_llama(cfg, params, profile: bool = False):
    """Phase 6; returns the launch counts of one decomposed forward."""
    import numpy as np
    import torch
    from repro_torch.core import outlier as ol
    from repro_torch.core.outlier import ThresholdTable
    from repro_torch.core.policy import (PAPER_BEST_CONFIG,
                                         PAPER_LAYER_CONFIGS,
                                         DecompositionPolicy)
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels.outlier_extract import outlier_stats_plain
    from repro_torch.models import transformer as T
    from repro_torch.runtime.steps import (make_decomposed_forward_step,
                                           make_decomposed_quality_step)

    name, rank = PAPER_BEST_CONFIG
    policy = DecompositionPolicy.from_layer_list(
        cfg.num_layers, PAPER_LAYER_CONFIGS[name], rank=rank,
        outlier_frac=0.03)
    # Random-weight rmsnorm outputs are about unit scale, so the default
    # threshold of 6 would leave every count at 0; 3.0 makes the counts,
    # and not only the max |x| tiebreak, pick the channels.
    policy.thresholds = ThresholdTable(default=3.0)
    engines = {b: DecomposeEngine(EngineConfig(policy=policy,
                                               attn_mode="dense",
                                               backend=b))
               for b in ("cuda", "reference")}
    fwd = {b: make_decomposed_forward_step(cfg, e)
           for b, e in engines.items()}
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (1, ACT_SEQ))).long().cuda()
    num_c = max(1, round(0.03 * cfg.d_model))
    print(f"activation: {cfg.name} tokens [1, {ACT_SEQ}], layers "
          f"{PAPER_LAYER_CONFIGS[name]} rank {rank}, {num_c} outlier "
          f"channels, threshold 3.0, attn_mode dense", flush=True)

    # (a) one forward through the kernels: exact launch counts
    log_k, log_r = [], []
    _recording(engines["cuda"], log_k, keep_input=True)
    _recording(engines["reference"], log_r, keep_input=False)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    logits_k = fwd["cuda"](params, tokens)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    if launches != ACT_LAUNCHES:
        raise AssertionError(f"decomposed forward launches {launches} != "
                             f"{ACT_LAUNCHES}: something bypassed the "
                             f"kernels")
    print("activation: launches " + json.dumps(launches), flush=True)

    # (b) route check: the same forward through the plain versions on the
    # card.  (b1) The selection itself: on the very input each
    # kernel-route decomposition saw, the plain statistics pick the same
    # channels, in all 20.  (b2) Free running, each route selects on its
    # own inputs, which drift apart by bf16 rounding after the first
    # decomposed layer.  (b3) Index-forced: the plain route takes the
    # kernel route's selection at each decomposition, so what is left of
    # the logits gap is the kernels' rounding alone.  (b4) b2 again on a
    # second prompt (tokens from RandomState(1)).
    per_call = [torch.equal(idx, ol.select_outlier_channels(
        x.float(), 3.0, num_c, stats=outlier_stats_plain))
        for x, idx in log_k]
    logits_r = fwd["reference"](params, tokens)
    free = _route_gap(logits_k, logits_r, log_k, log_r)
    del logits_r
    log_r.clear()
    agree = []
    with mock.patch.object(ol, "select_outlier_channels",
                           _forced_selection(log_k, agree)):
        logits_f = fwd["reference"](params, tokens)
    forced = _route_gap(logits_k, logits_f, log_k, log_r)
    del logits_k, logits_f
    tokens1 = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab, (1, ACT_SEQ))).long().cuda()
    x10 = log_k[2][0].float()        # layer 10's attention input, for (c)
    log_k.clear()
    log_r.clear()
    second = _route_gap(fwd["cuda"](params, tokens1),
                        fwd["reference"](params, tokens1), log_k, log_r)
    torch.cuda.synchronize()
    if ops.launch_counts() != {k: 2 * v for k, v in ACT_LAUNCHES.items()}:
        raise AssertionError("the reference backend launched a kernel")
    for e in engines.values():
        del e.decompose_activation             # drop the recorder
    del log_k, log_r, tokens1
    for label, g in (("free running", free), ("index-forced", forced),
                     ("free running, second prompt", second)):
        print(f"activation: kernel vs reference route, {label}: logits rel "
              f"L2 {g['rel']:.3e} (tol {ACT_LOGITS_TOL}), outlier sets "
              f"equal in {g['same']}/{g['n']} decompositions, argmax "
              f"agreement {g['argmax']:.4f}", flush=True)
    print(f"activation: on the kernel route's own inputs the plain "
          f"statistics select the kernel's channels in "
          f"{sum(per_call)}/{len(per_call)} decompositions; in the "
          f"index-forced run the plain route's own choice agreed in "
          f"{sum(agree)}/{len(agree)}", flush=True)
    gaps = (free, forced, second)
    if not (len(per_call) == len(agree) == 20 and all(per_call)
            and forced["same"] == 20
            and all(g["finite"] and g["n"] == 20 and g["first_equal"]
                    and g["rel"] <= ACT_LOGITS_TOL for g in gaps)):
        raise AssertionError(f"activation routes disagree: {gaps} "
                             f"per_call={per_call}")

    # (c) layer 10's real attention input, float32, kernel vs plain
    lp = policy.layer(10)
    wq = {"w": params["layers"]["attn"]["wq"]["w"][10].float()}
    lrs = {b: engines[b].decompose_activation(x10, lp=lp, threshold=3.0)
           for b in engines}
    s_k, s_r = lrs["cuda"].core, lrs["reference"].core
    s_err = ((s_k - s_r).abs().max() / s_r.abs().max()).item()
    rec = {b: lrs[b].reconstruct() for b in lrs}
    rec_err = ((rec["cuda"] - rec["reference"]).norm()
               / rec["reference"].norm()).item()
    q = {b: engines[b].project(lrs[b], wq).reconstruct() for b in lrs}
    q_err = ((q["cuda"] - q["reference"]).norm()
             / q["reference"].norm()).item()
    idx_eq = torch.equal(lrs["cuda"].o_idx, lrs["reference"].o_idx)
    print(f"activation: layer 10 float32, kernel vs plain: singular "
          f"values max rel err {s_err:.3e}, reconstruction rel err "
          f"{rec_err:.3e}, Q projection rel err {q_err:.3e} (tol 1e-3 "
          f"each), outlier sets equal {idx_eq}", flush=True)
    if not (s_err <= 1e-3 and rec_err <= 1e-3 and q_err <= 1e-3
            and idx_eq):
        raise AssertionError("layer-10 decomposition: kernel route and "
                             "plain route disagree")
    del x10, wq, lrs, rec, q

    # (d) KL(dense ‖ decomposed), then times and peak memory
    kl = make_decomposed_quality_step(cfg, engines["cuda"])(params,
                                                           tokens).item()
    if not (np.isfinite(kl) and kl > 0):
        raise AssertionError(f"KL(dense || decomposed) = {kl}")
    T.forward(params, cfg, tokens)                 # warm the dense path
    dense_ms, dense_all = median_ms(lambda: T.forward(params, cfg, tokens))
    torch.cuda.reset_peak_memory_stats()
    dec_ms, dec_all = median_ms(lambda: fwd["cuda"](params, tokens))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ref_ms, ref_all = median_ms(lambda: fwd["reference"](params, tokens))
    print(f"activation: KL(dense || decomposed) {kl:.6f}; forward ms "
          f"(median of 3): dense {dense_ms:.2f} {dense_all}, decomposed "
          f"via kernels {dec_ms:.2f} {dec_all}, decomposed via plain "
          f"versions {ref_ms:.2f} {ref_all}; peak memory of the decomposed "
          f"forward {peak:.2f} GiB", flush=True)
    if profile:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        with prof:
            fwd["cuda"](params, tokens)
            torch.cuda.synchronize()
        print("activation: profile of one decomposed forward", flush=True)
        print_profile(prof)

    # (e) the route check in float32 at full size: float32 rounding keeps
    # the two routes' inputs together, so every decomposition must select
    # the same channels end to end and the logits agree within ACT_F32_TOL
    p32, cfg32 = to_float32(params), cfg.replace(dtype="float32")
    logs = {b: [] for b in engines}
    for b, e in engines.items():
        _recording(e, logs[b], keep_input=False)
    out = {b: make_decomposed_forward_step(cfg32, e)(p32, tokens)
           for b, e in engines.items()}
    for e in engines.values():
        del e.decompose_activation
    g = _route_gap(out["cuda"], out["reference"], logs["cuda"],
                   logs["reference"])
    del p32, out
    print(f"activation: kernel vs reference route, float32: logits rel L2 "
          f"{g['rel']:.3e} (tol {ACT_F32_TOL}), outlier sets equal in "
          f"{g['same']}/{g['n']} decompositions, argmax agreement "
          f"{g['argmax']:.4f}", flush=True)
    if not (g["finite"] and g["n"] == g["same"] == 20
            and g["rel"] <= ACT_F32_TOL):
        raise AssertionError(f"float32 activation routes disagree: {g}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="profile the serving run and one decomposed "
                         "forward and print each one's device busy share "
                         "and kernel time table")
    args = ap.parse_args()

    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail("src/repro_torch is not beside this script")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device (torch.cuda.is_available() is False)")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    print(smi[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all(verbose=True)
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f}s",
          flush=True)

    cfg = get_arch("llama2-7b")
    rows = phase_kernels(cfg)
    params = init_llama(cfg)
    serve_launches, _ = serve_llama(cfg, params, args.profile)
    torch.cuda.empty_cache()
    conformance(cfg)
    act = activation_llama(cfg, params, args.profile)
    # each kernel's launches from the run of the path that uses it: the
    # serving run for the batched re-orth pair and dkv, the activation
    # forward for the rest (its re-orth launches are all at B = 1)
    launches = dict(serve_launches, lowrank_matmul=act["lowrank_matmul"],
                    outlier_stats=act["outlier_stats"],
                    reorth_right=act["reorth_right_batched"],
                    reorth_left=act["reorth_left_batched"])
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    seen, kernels = set(), []
    for rec in rows:                     # main-path shapes: first of a name
        if rec["name"] in seen:
            continue
        seen.add(rec["name"])
        rec["launches"] = launches[rec["name"]]
        kernels.append({k: rec[k] for k in keys})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
