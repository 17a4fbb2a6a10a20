#!/usr/bin/env python3
"""Where the time of one intra-chunk SSD launch goes, forward and
backward, on one GPU.

    python3 ssd_timeline.py

Compiles ``src/repro_torch/kernels/csrc/ssd_chunk.cu`` once more with
``-DDCOM_SSD_TIMELINE`` and ``ssd_chunk_bwd.cu`` with
``-DDCOM_SSD_BWD_TIMELINE`` (into the git-ignored build directory), so
that lane 0 of consumer warp 0 and of the producer warp of every CTA log
tagged ``%globaltimer`` stamps.  The forward runs at phase 8's four
prefill shapes (mamba2-780m: nh 48, hd 64; G 8, 6, 2 at Q 64 and G 1 at
Q 304) with the heads per item the wrapper picks; per shape it prints the
launch's span (first CTA start to last CTA end), the CTAs' items and
stages, and the median and maximum over CTAs, in microseconds, of the
wait for the first stage, of consumer warp 0's summed time waiting for
later stages, building its M rows, in its FMAs and storing y, and of the
time from its last store to the CTA's end.  The backward runs at phase
17's training shape (G 32 × Q 64) and the same four, with the wrapper's
plan; per shape (lines ``"kernel": "ssd_chunk_intra_bwd"``) the span,
the items and stages a CTA took, and the median and maximum over CTAs of
the wait for the first stage, the summed waits for later stages, the two
tensor-core products (the sums across warps and the ddt and dl stores
included), the masked terms (dl's row sums within a warp), the stage's
barrier, the dx stores, the dcb partials with their tickets, the dcb
combines, the dl combine and the tail.  The card's name
and power limit come first.  Without CUDA it exits non-zero.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPES = ((8, 64), (6, 64), (2, 64), (1, 304))   # (G, Q), nh 48, hd 64
EVENTS = 128           # per CTA and warp, as in the sources
BWD_EVENTS = 160


def build(lib_dir: Path) -> ctypes.CDLL:
    from repro_torch.kernels import build as kb
    lib_dir.mkdir(parents=True, exist_ok=True)
    out = lib_dir / "ssd_chunk_timeline.so"
    cmd = [kb.nvcc_path(), *kb.FLAGS, "-DDCOM_SSD_TIMELINE", "-o", str(out),
           str(kb.CSRC / "ssd_chunk.cu")]
    subprocess.run(cmd, check=True)
    lib = ctypes.CDLL(str(out))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dcom_ssd_chunk_intra_f32.argtypes = [vp, vp, vp, vp, vp, i, i, i, i,
                                             i, i, vp, i, vp]
    lib.dcom_ssd_chunk_intra_f32.restype = i
    lib.dcom_ssd_read_events.argtypes = [vp, vp, i]
    lib.dcom_ssd_read_events.restype = i
    return lib


def phases(ev, prod) -> dict:
    """Consumer warp 0's log of one CTA (and its producer's) -> phase sums
    (ns).  Consumer tags: 0 start, 1 item, 7 x and l/dt ready, 2 cb ready,
    3 M built, 4 FMAs done, 5 tile stored, 6 end; producer: 12 a stage's
    x requested.  "first" runs from the start to the first stage ready,
    of which "first_tma" to the producer's first x request and "first_x"
    to the first x landing."""
    out = dict(first=0, first_tma=0, first_x=0, wait=0, build=0, gemm=0,
               store=0, tail=0)
    start, seen2, prev = ev[0][1], False, None
    sent = [t for tag, t in prod if tag == 12]
    if sent:
        out["first_tma"] = sent[0] - start
    for tag, t in ev:
        if tag == 7 and not seen2 and out["first_x"] == 0:
            out["first_x"] = t - start
        if tag == 2 and not seen2:
            out["first"], seen2, prev = t - start, True, t
            continue
        if prev is None or tag in (1, 7):
            continue
        out[{2: "wait", 3: "build", 4: "gemm", 5: "store",
             6: "tail"}[tag]] += t - prev
        prev = t
    return out


def timeline(lib, g: int, q: int, nh: int = 48, hd: int = 64):
    import numpy as np
    import torch
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.kernels.build import tickets
    gen = torch.Generator(device="cuda").manual_seed(0)
    cb = torch.randn(g, q, q, generator=gen, device="cuda") * 0.3
    l = torch.cumsum(-torch.randn(g, q, nh, generator=gen,
                                  device="cuda").abs() * 0.05, dim=1)
    dt = torch.randn(g, q, nh, generator=gen, device="cuda").abs()
    x = torch.randn(g, q, nh, hd, generator=gen, device="cuda")
    y = torch.empty_like(x)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    hb = sc.heads_for(g, q, nh, hd, x.device)
    tk = tickets(x.device, 2, "ssd_timeline")
    stream = torch.cuda.current_stream().cuda_stream
    n = min(2 * sms, 1024)               # CTAs logged (two an SM at most)
    ev = np.zeros((n, 2, EVENTS), dtype=np.uint64)
    tags = np.zeros((n, 2, EVENTS), dtype=np.uint8)
    for _ in range(5):                   # warm; the log of the last launch
        lib.dcom_ssd_read_events(ev.ctypes.data, tags.ctypes.data, n)
        err = lib.dcom_ssd_chunk_intra_f32(
            cb.data_ptr(), l.data_ptr(), dt.data_ptr(), x.data_ptr(),
            y.data_ptr(), g, q, nh, hd, q, hb, tk.data_ptr(), sms, stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")
        torch.cuda.synchronize()
    if lib.dcom_ssd_read_events(ev.ctypes.data, tags.ctypes.data, n):
        raise RuntimeError("reading the stamps failed")
    logs = [[[(int(tg) - 1, int(t)) for tg, t in zip(tags[c, who],
                                                      ev[c, who]) if tg]
             for who in (0, 1)] for c in range(n)]
    per = [phases(*lg) for lg in logs if lg[0]]
    logs = [lg[0] for lg in logs if lg[0]]
    t0 = min(lg[0][1] for lg in logs)
    stat = lambda k: (float(np.median([p[k] for p in per]) / 1e3),  # noqa
                      float(max(p[k] for p in per) / 1e3))
    return dict(
        shape=dict(G=g, Q=q, nh=nh, hd=hd), heads_per_item=hb,
        ctas=len(logs),
        span_us=float((max(lg[-1][1] for lg in logs) - t0) / 1e3),
        start_spread_us=float((max(lg[0][1] for lg in logs) - t0) / 1e3),
        items_per_cta=sorted({sum(1 for tg, _ in lg if tg == 1)
                              for lg in logs}),
        stages_per_cta=sorted({sum(1 for tg, _ in lg if tg == 2)
                               for lg in logs}),
        **{f"{k}_us_median_max": stat(k)
           for k in ("first", "first_tma", "first_x", "wait", "build",
                     "gemm", "store", "tail")})


BWD_SHAPES = ((32, 64),) + SHAPES   # phase 17's training shape first


def build_bwd(lib_dir: Path) -> ctypes.CDLL:
    from repro_torch.kernels import build as kb
    lib_dir.mkdir(parents=True, exist_ok=True)
    out = lib_dir / "ssd_chunk_bwd_timeline.so"
    cmd = [kb.nvcc_path(), *kb.FLAGS, "-DDCOM_SSD_BWD_TIMELINE", "-o",
           str(out), str(kb.CSRC / "ssd_chunk_bwd.cu")]
    subprocess.run(cmd, check=True)
    lib = ctypes.CDLL(str(out))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dcom_ssd_chunk_intra_bwd_f32.argtypes = [vp] * 11 + [i] * 7 + [
        vp, i, vp]
    lib.dcom_ssd_chunk_intra_bwd_f32.restype = i
    lib.dcom_ssd_bwd_read_events.argtypes = [vp, vp, i]
    lib.dcom_ssd_bwd_read_events.restype = i
    return lib


#: consumer warp 0's tags in the backward -> the phase the time up to the
#: stamp belongs to (1 item read, 2 stage ready, 3 product 1, 4 masked
#: terms and dl's row sums in the warp, 11 the stage's barrier, 5 the sums
#: across warps with the ddt and dl stores and product 2, 6 the dx
#: stores, 7 dcb partial and tile ticket, 8 tile combine, 9 the chunk's
#: dl combine, 10 end)
BWD_PHASE = {1: "wait", 2: "wait", 3: "products", 4: "masked", 5: "products",
             11: "barrier", 6: "stores", 7: "dcb_ticket", 8: "dcb_combine",
             9: "dl_combine", 10: "tail"}


def bwd_phases(ev) -> dict:
    """Consumer warp 0's log of one CTA of the backward -> phase sums (ns);
    "first" runs from the start to the first stage ready."""
    out = dict.fromkeys(("first",) + tuple(dict.fromkeys(BWD_PHASE.values())),
                        0)
    start, prev = ev[0][1], None
    for tag, t in ev[1:]:
        if prev is None:
            if tag == 2:
                out["first"], prev = t - start, t
            continue
        out[BWD_PHASE[tag]] += t - prev
        prev = t
    return out


def bwd_timeline(lib, g: int, q: int, nh: int = 48, hd: int = 64):
    import numpy as np
    import torch
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.kernels.build import tickets
    gen = torch.Generator(device="cuda").manual_seed(0)
    cb = torch.randn(g, q, q, generator=gen, device="cuda") * 0.3
    l = torch.cumsum(-torch.randn(g, q, nh, generator=gen,
                                  device="cuda").abs() * 0.05, dim=1)
    dt = torch.randn(g, q, nh, generator=gen, device="cuda").abs()
    x = torch.randn(g, q, nh, hd, generator=gen, device="cuda")
    dy = torch.randn(g, q, nh, hd, generator=gen, device="cuda")
    dcb = torch.empty(g, q, q, device="cuda")
    dl, ddt, dx = torch.empty_like(l), torch.empty_like(dt), \
        torch.empty_like(x)
    ctas = sc.bwd_ctas(0, hd)
    plan = sc.bwd_plan(g, q, nh, ctas)
    dcbw = torch.empty(plan.dcb_work, device="cuda")
    dlw = torch.empty(max(plan.dl_work, 1), device="cuda")
    tk = tickets(x.device, plan.tickets, "ssd_bwd_timeline")
    stream = torch.cuda.current_stream().cuda_stream
    n = min(ctas, 1024)
    ev = np.zeros((n, 2, BWD_EVENTS), dtype=np.uint64)
    tags = np.zeros((n, 2, BWD_EVENTS), dtype=np.uint8)
    for _ in range(5):                   # warm; the log of the last launch
        lib.dcom_ssd_bwd_read_events(ev.ctypes.data, tags.ctypes.data, n)
        err = lib.dcom_ssd_chunk_intra_bwd_f32(
            cb.data_ptr(), l.data_ptr(), dt.data_ptr(), x.data_ptr(),
            dy.data_ptr(), dcb.data_ptr(), dl.data_ptr(), ddt.data_ptr(),
            dx.data_ptr(), dcbw.data_ptr(), dlw.data_ptr(), g, q, nh, hd, hd,
            q, plan.hb, tk.data_ptr(), ctas, stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")
        torch.cuda.synchronize()
    if lib.dcom_ssd_bwd_read_events(ev.ctypes.data, tags.ctypes.data, n):
        raise RuntimeError("reading the stamps failed")
    logs = [[(int(tg) - 1, int(t)) for tg, t in zip(tags[c, 0], ev[c, 0])
             if tg] for c in range(n)]
    logs = [lg for lg in logs if lg]
    per = [bwd_phases(lg) for lg in logs]
    t0 = min(lg[0][1] for lg in logs)
    stat = lambda k: (float(np.median([p[k] for p in per]) / 1e3),  # noqa
                      float(max(p[k] for p in per) / 1e3))
    return dict(
        kernel="ssd_chunk_intra_bwd", shape=dict(G=g, Q=q, nh=nh, hd=hd),
        heads_per_item=plan.hb, items=plan.items, ctas=len(logs),
        span_us=float((max(lg[-1][1] for lg in logs) - t0) / 1e3),
        start_spread_us=float((max(lg[0][1] for lg in logs) - t0) / 1e3),
        items_per_cta=sorted({sum(1 for tg, _ in lg if tg == 1)
                              for lg in logs}),
        stages_per_cta=sorted({sum(1 for tg, _ in lg if tg == 2)
                               for lg in logs}),
        **{f"{k}_us_median_max": stat(k)
           for k in per[0]})


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("ssd_timeline: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.build import BUILD
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    lib = build(BUILD / "timeline")
    for g, q in SHAPES:
        print(json.dumps(timeline(lib, g, q)), flush=True)
    lib = build_bwd(BUILD / "timeline")
    for g, q in BWD_SHAPES:
        print(json.dumps(bwd_timeline(lib, g, q)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
