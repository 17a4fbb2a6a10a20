#!/usr/bin/env python3
"""Where the time of one fused re-orth launch goes, on one GPU.

    python3 reorth_timeline.py            # the default f of the checkout
    python3 reorth_timeline.py --f 8

Compiles ``src/repro_torch/kernels/csrc/lanczos_reorth.cu`` once more with
``-DDCOM_REORTH_TIMELINE`` (into the git-ignored build directory), so
that thread 0 of every CTA stamps ``%globaltimer`` at the phase
boundaries of the launch, and runs the re-orth steps of phase 6 (B = 1,
A [4096, 4096], k = 20) and phase 4 (A [32, 512, 4096], k = 72), right
and left.  Per shape it prints the launch's span (first CTA start to last
CTA end), the median over CTAs of each phase in microseconds (pass 0,
the wait for the Q rows, sweeps A/B/C, the two cluster combines, the
computation of p1/p2 and the final barrier), the SMs' stream rate in
pass 0 and when each cluster started, and the card's name and power
limit.  Without CUDA it exits non-zero.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("pass0", "q_wait", "sweep_a", "combine_1", "p1", "sweep_b",
          "combine_2", "p2", "sweep_c", "final")
SHAPES = (("right", 1, 4096, 4096, 20), ("left", 1, 4096, 4096, 20),
          ("right", 32, 512, 4096, 72), ("left", 32, 512, 4096, 72))


def build(lib_dir: Path) -> ctypes.CDLL:
    from repro_torch.kernels import build as kb
    lib_dir.mkdir(parents=True, exist_ok=True)
    out = lib_dir / "lanczos_reorth_timeline.so"
    cmd = [kb.nvcc_path(), *kb.FLAGS, "-DDCOM_REORTH_TIMELINE", "-o",
           str(out), str(kb.CSRC / "lanczos_reorth.cu")]
    subprocess.run(cmd, check=True)
    lib = ctypes.CDLL(str(out))
    vp, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.dcom_reorth_right_f32, lib.dcom_reorth_left_f32):
        fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, vp]
        fn.restype = i
    lib.dcom_reorth_read_stamps.argtypes = [vp, i]
    lib.dcom_reorth_read_stamps.restype = i
    return lib


def timeline(lib, side: str, b: int, s: int, h: int, k: int, f: int):
    import numpy as np
    import torch
    from repro_torch.kernels.lanczos_reorth import cluster_ctas
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(b, s, h, generator=gen, device="cuda")
    n, m = (h, s) if side == "right" else (s, h)
    x = torch.randn(b, m, generator=gen, device="cuda")
    q = torch.zeros(b, n, k, device="cuda")
    q[..., : k // 2] = torch.linalg.qr(
        torch.randn(b, n, k // 2, generator=gen, device="cuda"))[0]
    out = torch.empty(b, n, device="cuda")
    nrm = torch.empty(b, device="cuda")
    fn = getattr(lib, f"dcom_reorth_{side}_f32")
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(5):                   # the last launch's stamps stay
        err = fn(a.data_ptr(), x.data_ptr(), q.data_ptr(), out.data_ptr(),
                 nrm.data_ptr(), b, s, h, k, f, stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")
    torch.cuda.synchronize()
    c = cluster_ctas(f)
    t = np.zeros((b * c, 11), dtype=np.uint64)
    if lib.dcom_reorth_read_stamps(t.ctypes.data, b * c):
        raise RuntimeError("reading the stamps failed")
    t = t.astype(np.int64)
    t0 = t[:, 0].min()
    dur = np.diff(t, axis=1) / 1e3
    span = (t[:, 10].max() - t0) / 1e3
    a_bytes = 4 * s * h / c              # of one CTA's pass 0
    return dict(
        side=side, shape=[b, s, h], k=k, f=f, cluster=c, span_us=span,
        phases_us={p: float(np.median(dur[:, i]))
                   for i, p in enumerate(PHASES)},
        pass0_gb_s_per_sm=a_bytes / float(np.median(dur[:, 0])) / 1e3,
        cluster_starts_us=[float(v) for v in
                           np.sort((t[::c, 0] - t0) / 1e3)])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--f", type=int, default=None,
                    help="blocks along the output axis (default: "
                         "EngineConfig().expansion)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("reorth_timeline: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.engine import EngineConfig
    from repro_torch.kernels.build import BUILD
    f = args.f or EngineConfig().expansion
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    lib = build(BUILD / "timeline")
    for shape in SHAPES:
        print(json.dumps(timeline(lib, *shape, f)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
