#!/usr/bin/env python3
"""Where the time of one intra-chunk SSD launch goes, on one GPU.

    python3 ssd_timeline.py

Compiles ``src/repro_torch/kernels/csrc/ssd_chunk.cu`` once more with
``-DDCOM_SSD_TIMELINE`` (into the git-ignored build directory), so that
lane 0 of consumer warp 0 and of the producer warp of every CTA log
tagged ``%globaltimer`` stamps, and launches the kernel at phase 8's four
prefill shapes (mamba2-780m: nh 48, hd 64; G 8, 6, 2 at Q 64 and G 1 at
Q 304) with the heads per item the wrapper picks.  Per shape it prints
the launch's span (first CTA start to last CTA end), the CTAs' items
and stages, and the median and maximum over CTAs, in microseconds, of
the wait for the first stage, of consumer warp 0's summed time waiting
for later stages, building its M rows, in its FMAs and storing y,
and of the time from its last store to the CTA's end, with the card's name and power limit.  Without CUDA it exits
non-zero.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPES = ((8, 64), (6, 64), (2, 64), (1, 304))   # (G, Q), nh 48, hd 64
EVENTS = 128           # per CTA and warp, as in the source


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
    return 0


if __name__ == "__main__":
    sys.exit(main())
