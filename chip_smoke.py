#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py              # every phase, one card
    python3 chip_smoke.py --profile    # also profile the serving run

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
   must fold, and every kernel must have launched during the run; one
   decode step's logits through the kernel route are held against the
   plain ``_lowrank_attention`` route;
5. conformance on a small input: greedy tokens of decomposed-KV serving
   at full rank (direct SVD) equal dense serving on a reduced float32
   llama2 config, through the kernels.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the
package beside this script, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

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


def bound(bytes_: float, flops: float, dtype: str):
    t_bytes = bytes_ / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def reorth_case(side: str, b: int, s: int, h: int, k: int, filled: int,
                expansion: int, gen):
    """Inputs of one Lanczos step at serving shapes: A [B,S,H] float32, a
    unit input vector, and a basis with ``filled`` orthonormal columns of
    ``k`` (the rest zero, as mid-iteration)."""
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
    kern = lr.reorth_right_batched if side == "right" \
        else lr.reorth_left_batched
    plain = lr.reorth_right_batched_plain if side == "right" \
        else lr.reorth_left_batched_plain
    z_k, n_k = kern(a, x, q, expansion=expansion)
    z_p, n_p = plain(a, x, q)
    torch.cuda.synchronize()
    err = (z_k - z_p).abs().max().item()
    tol = 1e-4 * z_p.abs().max().item()
    nerr = ((n_k - n_p).abs() / n_p.abs()).max().item()
    if not err <= tol or not nerr <= 1e-4:
        raise AssertionError(
            f"reorth_{side}_batched B={b}: max abs err {err:.3e} > {tol:.3e}"
            f" or norm rel err {nerr:.3e} > 1e-4")
    ms = time_ms(lambda: kern(a, x, q, expansion=expansion))
    plain_ms = time_ms(lambda: plain(a, x, q))
    bytes_ = 4 * (b * s * h + b * m + b * n * k + b * n + b)
    flops = 2 * b * s * h + 8 * b * n * k + 2 * b * n
    bms, by = bound(bytes_, flops, "float32")
    return dict(name=f"reorth_{side}_batched", route="cuda",
                source="src/repro_torch/kernels/csrc/lanczos_reorth.cu",
                replaces=("src/repro/kernels/lanczos_reorth.py:233"
                          if side == "right" else
                          "src/repro/kernels/lanczos_reorth.py:274"),
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None,
                shape=dict(B=b, S=s, H=h, k=k, filled=filled,
                           expansion=expansion),
                tolerance="max|z_kernel - z_plain| <= 1e-4 max|z_plain|, "
                          "norm rel err <= 1e-4 (float32, reduction "
                          "order differs)")


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
    return rows


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


def serve_llama(cfg, profile: bool = False):
    import numpy as np
    import torch
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.kernels import ops
    from repro_torch.models import decomposed_kv as DK, transformer as T
    from repro_torch.serving import Engine, Request

    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = T.init(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gib = T.param_bytes(params) / 2 ** 30
    print(f"serve: {cfg.name} {cfg.num_layers} layers, {gib:.2f} GiB "
          f"{cfg.dtype} weights drawn in {init_s:.1f}s", flush=True)
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
    missing = [k for k, v in launches.items() if v <= 0]
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
    f32 = lambda t: {k: f32(v) for k, v in t.items()} \
        if isinstance(t, dict) else t.float()
    p32, c32 = f32(params), f32(cache)
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="profile the serving run and print its device "
                         "busy share and kernel time table")
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
    launches, _ = serve_llama(cfg, args.profile)
    conformance(cfg)
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
