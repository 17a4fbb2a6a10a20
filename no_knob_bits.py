#!/usr/bin/env python3
"""Hold the knob-free launches of the Eq. 6 GEMM and the dkv statistics
of two checkouts bit for bit, on one GPU.

    python3 no_knob_bits.py save CHECKOUT OUT.pt   # one checkout's outputs
    python3 no_knob_bits.py compare A.pt B.pt      # exit 1 if any differs

``save`` imports ``repro_torch`` from ``CHECKOUT/src`` (each checkout in
a process of its own, as the two share module names), builds its
kernels at first use, and runs ``lowrank_matmul(vt, w)`` and
``dkv_attention_stats(inner, k_u, v_u, t_valid)`` with no operating
point on fixed seeded inputs in bf16 and float32: phase 6's GEMM shapes
and ragged ones, phase 4's dkv shape, batch 1 over 8,192 rows and
ragged ones.  ``compare`` prints how many of the outputs differ.
"""
import sys

import torch

LRMM_SHAPES = ((1, 20, 4096, 4096), (1, 20, 4096, 11008), (2, 13, 777, 301),
               (1, 64, 512, 384), (3, 21, 100, 100), (1, 20, 2048, 136))
DKV_SHAPES = ((4, 32, 512, 64, (512, 384, 304, 128)),
              (1, 32, 8192, 64, (8192,)), (3, 6, 77, 10, (77, 31, 0)),
              (2, 8, 1000, 16, (1000, 33)))


def save(checkout: str, path: str) -> None:
    sys.path.insert(0, checkout + "/src")
    from repro_torch.kernels import dkv_attention as dk
    from repro_torch.kernels import lowrank_matmul as lm
    out = {}
    g = torch.Generator(device="cuda").manual_seed(0)
    for dt in (torch.bfloat16, torch.float32):
        for b, k, h, n in LRMM_SHAPES:
            vt = torch.randn(b, k, h, generator=g, device="cuda").to(dt)
            w = (torch.randn(h, n, generator=g, device="cuda")
                 * h ** -0.5).to(dt)
            out[f"lrmm {dt} {b},{k},{h},{n}"] = lm.lowrank_matmul(vt, w).cpu()
        for b, nh, t, r, tv in DKV_SHAPES:
            inner = torch.randn(b, nh, r, generator=g, device="cuda")
            ku = torch.randn(b, t, r, generator=g, device="cuda").to(dt)
            vu = torch.randn(b, t, r, generator=g, device="cuda").to(dt)
            tvv = torch.tensor(tv, dtype=torch.int32, device="cuda")
            for i, x in enumerate(dk.dkv_attention_stats(inner, ku, vu, tvv)):
                out[f"dkv {dt} {b},{nh},{t},{r} {i}"] = x.cpu()
    torch.save(out, path)
    print(f"saved {len(out)} outputs of {checkout}", flush=True)


def compare(a_path: str, b_path: str) -> int:
    a, b = torch.load(a_path), torch.load(b_path)
    bad = [k for k in a if k not in b or not torch.equal(a[k], b[k])]
    print(f"no-knob outputs: {len(a)}, {len(bad)} differ {bad[:10]}",
          flush=True)
    return 1 if bad or set(a) != set(b) else 0


def main() -> int:
    if len(sys.argv) != 4 or sys.argv[1] not in ("save", "compare"):
        print(__doc__, file=sys.stderr)
        return 2
    if sys.argv[1] == "compare":
        return compare(sys.argv[2], sys.argv[3])
    if not torch.cuda.is_available():
        print("no_knob_bits: needs a CUDA device", file=sys.stderr)
        return 1
    save(sys.argv[2], sys.argv[3])
    return 0


if __name__ == "__main__":
    sys.exit(main())
