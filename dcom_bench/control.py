#!/usr/bin/env python3
"""Readings that set a cell's limits, on the card, in one process.

    python3 dcom_bench/control.py --workload <cell> --seeds 1,2,3 \
        --control 3 --seconds 5 \
        [--faults '[null, {"policy": {"rank": 19}}]'] [--out readings.jsonl]

For each seed: the cell's set-up and a short window at its own load,
then the check's numbers of the program against the plain reference;
for the first ``--control`` seeds also the control's (the reference in
float8 in the program's place).  ``--faults`` lists what runs in the
program's place, each in turn: null, the program as the cell states
it; an object, a fault planted in the program alone (each object in it
updates the mix's object of that name for the program's set-up and
window, while the check's reference keeps the cell's mix, so the
reading is of a program that departs from the cell).  One JSON line per
reading, with ``harness.judge``'s verdict against the cell's limits.  The benchmark's own runs never run
this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def faulty(cell, fault):
    """A copy of ``cell`` whose mix has each object of ``fault`` updated
    (the cell itself when ``fault`` is None)."""
    if not fault:
        return cell
    import dataclasses
    tr = dict(cell.traffic)
    for k, v in fault.items():
        tr[k] = dict(tr.get(k, {}), **v) if isinstance(v, dict) else v
    return dataclasses.replace(cell, traffic=tr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--faults", default="[null]")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from dcom_bench import bench, harness
    from dcom_bench.trace import TraceWindow
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    out = open(args.out, "a") if args.out else None
    faults = json.loads(args.faults)
    for j, seed in enumerate(int(s) for s in args.seeds.split(",")):
        for k, fault in enumerate(faults):
            cell = bench.load_cell(args.workload, seed, "cuda")
            drv = bench.driver(cell.kind)
            t = time.perf_counter()
            st = drv.setup(faulty(cell, fault))
            win = drv.window(st, args.seconds, TraceWindow(False))
            drv.release(st)
            st.cell = cell
            rows = [("fault" if fault else "program", drv.check(st, win))]
            if j < args.control and k == 0:
                rows.append(("control", drv.check(st, win, fp8=True)))
            for who, nums in rows:
                ok, _ = harness.judge(nums, cell.limits.get("numbers", {}))
                line = {"workload": args.workload, "seed": seed,
                        "who": who, "fault": fault, "numbers": nums,
                        "correct": ok, "e2e": win["e2e"],
                        "facts": win.get("facts"),
                        "attempted": win["attempted"],
                        "seconds": time.perf_counter() - t}
                print(json.dumps(line), flush=True)
                if out:
                    out.write(json.dumps(line) + "\n")
                    out.flush()
            del st, win
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
