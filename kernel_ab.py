#!/usr/bin/env python3
"""A/B of kernel rows between two checkouts of the port, on one GPU.

    git archive <commit> | tar -x -C .ab/base      # a directory .gitignore lists
    python3 kernel_ab.py .ab/base .                # base, new, new, base
    python3 kernel_ab.py .ab/base . --out ab.json
    python3 kernel_ab.py .ab/base . --only ssd_chunk_intra,outlier_stats \
        --repeat 3                                 # base, new, new, base x3
    python3 kernel_ab.py .ab/base . --only ssd_chunk_intra_bwd --repeat 3

Each checkout is measured in its own process, in turns (base, new, new,
base), so both run on the same card within one run.  A process puts
that checkout's ``src`` first on the path, builds its kernels and runs
the phase-3 cases of the NEW checkout's ``chip_smoke.py`` on the same
seeded inputs (the wrappers' interface is shared), timed by its
``time_ms`` and ``time_ms_cold``, so the two runs differ only in the
kernels under test: ``reorth_case`` for the fused re-orth pair at phase
6's B = 1 shape (A [4096, 4096], k = 20, 10 columns filled) and phase
4's [32, 512, 4096] (k = 72, 36 filled), each checkout at its own
``EngineConfig().expansion`` (f counted warps per CTA before the
cluster kernel, blocks along the output axis since), warm and L2-cold
with the plain version beside; ``lowrank_matmul_case`` at Vᵀ [1, 20, 4096] @ W
[4096, 4096] and [4096, 11008] bf16, ``dkv_case`` and ``dkv_paged_case``
at phase 4's decode shape (inner [4, 32, 64], U [4, 512, 64] bf16,
t_valid 512/384/304/128; 16-row pages), and ``matvec_case`` for
``matvec`` and ``rmatvec`` at A [4096, 4096] float32 (L2 flushed per
call) and ``matvec_batched`` and ``rmatvec_batched`` at [64, 4096,
4096] bf16, all at f = 8, ``ssd_case`` at phase 8's four prefill shapes
(G 8, 6, 2 at Q 64 and G 1 at Q 304; nh 48, hd 64), ``ssd_bwd_case``
for its backward at phase 17's training shape (G 32 × Q 64) and the
same four, and
``outlier_stats_case`` at phase 6's X [1, 4096, 4096] in bf16 and float32
(a checkout whose kernel refuses bf16 reports the refusal instead; its
path fed the kernel the float32 copy).  Each case holds the kernel
against its plain version, as in ``chip_smoke.py``.  Each run also times an empty kernel
(``launch_floor_ms``).  The times of the rows (``ms``, ``library_ms`` and
whatever else the case reports) are printed per run, one JSON line
each, and written to ``--out`` if given.
Without CUDA it exits non-zero.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

DKV = dict(b=4, g=32, r=64, t_valid=(512, 384, 304, 128))   # phase 4
REORTH = dict(scalar=(4096, 4096, 20, 10),          # phase 6: S, H, k, filled
              batched=(32, 512, 4096, 72, 36))    # phase 4: B, S, H, k, filled
CASES = (("reorth_right", REORTH["scalar"]),
         ("reorth_left", REORTH["scalar"]),
         ("reorth_right_batched", REORTH["batched"]),
         ("reorth_left_batched", REORTH["batched"]),
         ("lowrank_matmul", (20, 4096, 4096)),
         ("lowrank_matmul", (20, 4096, 11008)),
         ("dkv_attention_stats", (4, 32, 512, 64)),
         ("dkv_attention_stats_paged", (4, 32, 512, 64)),
         ("matvec", (4096, 4096)),
         ("rmatvec", (4096, 4096)),
         ("matvec_batched", (64, 4096, 4096)),
         ("rmatvec_batched", (64, 4096, 4096)),
         ("ssd_chunk_intra", (8, 64, 48, 64)),
         ("ssd_chunk_intra", (6, 64, 48, 64)),
         ("ssd_chunk_intra", (2, 64, 48, 64)),
         ("ssd_chunk_intra", (1, 304, 48, 64)),
         ("ssd_chunk_intra_bwd", (32, 64, 48, 64)),
         ("ssd_chunk_intra_bwd", (8, 64, 48, 64)),
         ("ssd_chunk_intra_bwd", (6, 64, 48, 64)),
         ("ssd_chunk_intra_bwd", (2, 64, 48, 64)),
         ("ssd_chunk_intra_bwd", (1, 304, 48, 64)),
         ("outlier_stats", (4096, 4096, "bfloat16")),
         ("outlier_stats", (4096, 4096, "float32")))


def load_smoke(root: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(root: Path, cases: Path, only=None) -> dict:
    """The rows of :data:`CASES` (those named in ``only``, if given):
    ``root``'s kernels measured by the cases and timers of ``cases``'
    ``chip_smoke.py``."""
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    smoke = load_smoke(cases, "ab_smoke")
    from repro_torch.kernels import build
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    # f at this checkout's own default: its meaning differs between the
    # kernels of two checkouts (warps per CTA before the cluster kernel,
    # blocks along the output axis since)
    from repro_torch.engine import EngineConfig
    expansion = EngineConfig().expansion
    for name, shape in CASES:
        if only and name not in only:
            continue
        if name.startswith("reorth"):
            side = name.split("_")[1]
            if name.endswith("batched"):
                b, s, h, k, filled = shape
                rec = smoke.reorth_case(side, b, s, h, k, filled, expansion,
                                        gen)
            else:
                s, h, k, filled = shape
                rec = smoke.reorth_case(side, 1, s, h, k, filled, expansion,
                                        gen, scalar=True)
        elif name == "lowrank_matmul":
            rec = smoke.lowrank_matmul_case(*shape, gen)
        elif name == "dkv_attention_stats":
            rec = smoke.dkv_case(DKV["b"], DKV["g"], shape[2], DKV["r"],
                                 DKV["t_valid"], torch.bfloat16, gen)
        elif name == "dkv_attention_stats_paged":
            rec = smoke.dkv_paged_case(DKV["b"], DKV["g"], DKV["r"],
                                       DKV["t_valid"], 16, torch.bfloat16,
                                       gen)
        elif name == "ssd_chunk_intra":
            rec = smoke.ssd_case(*shape, gen)
        elif name == "ssd_chunk_intra_bwd":
            rec = smoke.ssd_bwd_case(*shape, gen)
        elif name == "outlier_stats":
            s, h, dt = shape
            try:
                rec = smoke.outlier_stats_case(s, h, gen, dtype=dt)
            except ValueError as e:              # a kernel that refuses dt
                rec = dict(name=name, refused=str(e))
        else:
            dt = torch.float32 if len(shape) == 2 else torch.bfloat16
            rec = smoke.matvec_case(name, shape, dt, gen)
        rows.append({k: v for k, v in rec.items()
                     if k in ("name", "max_abs_err", "bound_ms", "expansion",
                              "cluster", "resident_clusters", "refused",
                              "heads_per_item", "max_abs_err_by_output")
                     or k.endswith("ms") or "ms_" in k})
        rows[-1]["shape"] = list(shape)
        torch.cuda.empty_cache()
    floor = smoke.launch_floor_ms() if (
        root / "src/repro_torch/kernels/csrc/launch_floor.cu").exists() \
        else None                         # a checkout without the kernel
    return {"root": str(root), "rows": rows, "launch_floor_ms": floor}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("base", type=Path, help="checkout measured first/last")
    ap.add_argument("new", type=Path, help="checkout measured in between")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--repeat", type=int, default=1,
                    help="rounds of base, new, new, base")
    ap.add_argument("--only", default="",
                    help="comma-separated case names (default: all)")
    ap.add_argument("--child", type=Path, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        only = set(filter(None, args.only.split(",")))
        print(json.dumps(child(args.child.resolve(), args.new.resolve(),
                               only)),
              flush=True)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    runs = []
    for label, root in (("base", args.base), ("new", args.new),
                        ("new", args.new), ("base", args.base)) * args.repeat:
        proc = subprocess.run(
            [sys.executable, __file__, str(args.base), str(args.new),
             "--child", str(root), "--only", args.only],
            capture_output=True, text=True,
            timeout=900)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr, flush=True)
            return proc.returncode
        run = dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                   label=label)
        runs.append(run)
        for row in run["rows"]:
            print(json.dumps(dict(row, label=label)), flush=True)
        print(json.dumps({"launch_floor_ms": run["launch_floor_ms"],
                          "label": label}), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, "runs": runs},
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
