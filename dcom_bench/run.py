#!/usr/bin/env python3
"""Measure one cell of ``BENCHMARK.json`` on this machine's card.

    python3 dcom_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  Exits non-zero, printing no result,
where there is no CUDA card (or fewer than the cell asks for), where
the port cannot be imported, or where the process has loaded ``jax``,
``jaxlib``, ``flax`` or ``repro`` by the end.  Every cache the run
writes lies at a fixed path inside the checkout (``.bench_cache/``) or
under the port's own kernel build directory.  The last lines of
standard error give each compared number beside its limit; the last
line of standard output is the result as one JSON object.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"


def _prepare() -> None:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _prepare()
    import torch
    from dcom_bench import bench, harness
    manifest = bench.load_manifest(ROOT)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count()}: nothing measured",
              file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    out, checks, numbers = harness.measure(
        args.workload, args.seed, args.seconds, bool(args.trace),
        manifest=manifest, t_start=T_START)
    bad = harness.loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for n, v in sorted(numbers.items()):
        if n not in out["checks"]:
            print(f"reading {n}: {v!r} (no limit)", file=sys.stderr)
    for n, v, lim in checks:
        print(f"check {n}: {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
