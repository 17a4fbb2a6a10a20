"""The dry-run and roofline tables from ``results/dryrun_torch/*.json``.

Counterpart of ``repro.launch.report``, on ``launch.dryrun``'s records.
The columns are the reference's; where the reference's names an XLA
quantity the port's counterpart stands in: "run s" is the seconds the
shape-only step took on the host (the reference's "compile s"), "args
GB" the parameters, optimizer state and batch or cache a device holds
(XLA's argument size), "temp GB" the step's peak above them
(``MemTracker``; XLA's temp size), "bytes/device" their sum.  Every
time is analytic: the step's counted FLOPs, bytes and collective bytes
over the H100 SXM datasheet rates (``launch.roofline``), not a
measurement.  Cells the port refused are listed with its reason.

  PYTHONPATH=src python -m repro_torch.launch.report [--tag ""]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
from typing import Dict, List

from .dryrun import RESULTS_DIR

FIX_NOTES = {
    ("train", "collective_s"): ("shrink DP-gradient / FSDP all-gathers: "
                                "grad compression, 2D-sharding rebalance, or "
                                "larger per-step compute (microbatching)"),
    ("train", "memory_s"): ("cut activation traffic: larger fused attention "
                            "blocks, bf16 score path, selective remat"),
    ("train", "compute_s"): ("already compute-bound — good; tune the "
                             "Tensor Core (wgmma) tiling"),
    ("prefill", "collective_s"): ("all-gather of TP activations dominates: "
                                  "sequence-shard attention (ring) or "
                                  "reduce-scatter the FFN outputs; keep the "
                                  "model axis inside one NVLink node"),
    ("prefill", "memory_s"): "KV write + score traffic: fuse QK/PV chunks",
    ("prefill", "compute_s"): "compute-bound — good",
    ("decode", "memory_s"): ("decode is KV-bandwidth-bound by nature: "
                             "decomposed/quantized KV track shrinks bytes"),
    ("decode", "collective_s"): ("TP all-reduce per token: wider DP, fuse, "
                                 "or a model axis inside one NVLink node"),
    ("decode", "compute_s"): "unusual for decode — check batching",
}

_BASE_RE = re.compile(r"^(.+)_(train_4k|prefill_32k|decode_32k|long_500k)"
                      r"_(single|multi)$")

DRYRUN_COLUMNS = ("arch", "shape", "mesh", "chips", "run s", "FLOPs/dev",
                  "HBM bytes/dev", "coll bytes/dev", "args GB", "temp GB")
ROOFLINE_COLUMNS = ("arch", "shape", "compute s", "memory s",
                    "collective s", "dominant", "roofline frac",
                    "useful FLOP ratio", "bytes/device", "fix")


def load(tag: str = "", results_dir: str = RESULTS_DIR) -> List[Dict]:
    """tag="" loads only the untagged cells; tag="_x" that variant."""
    recs = []
    for f in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        base = os.path.basename(f)[:-5]
        if tag:
            if not base.endswith(tag):
                continue
        elif not _BASE_RE.match(base):
            continue
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def _head(cols) -> List[str]:
    return ["| " + " | ".join(cols) + " |",
            "|" + "---|" * len(cols)]


def roofline_table(recs: List[Dict], mesh: str = "single") -> str:
    out = _head(ROOFLINE_COLUMNS)
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        if r["mesh"] != mesh or "refused" in r:
            continue
        t = r["roofline"]
        fix = FIX_NOTES.get((r["kind"], r["dominant_term"]), "")
        ufr = r.get("useful_flops_ratio")
        out.append(
            f"| {r['arch']} | {r['shape']} | {t['compute_s']:.2e} | "
            f"{t['memory_s']:.2e} | {t['collective_s']:.2e} | "
            f"{r['dominant_term'].replace('_s', '')} | "
            f"{r['roofline_fraction']:.3f} | "
            f"{'' if ufr is None else f'{ufr:.2f}'} | "
            f"{r['memory']['peak_bytes'] / 1e9:.1f} GB | {fix} |")
    return "\n".join(out)


def dryrun_table(recs: List[Dict]) -> str:
    out = _head(DRYRUN_COLUMNS)
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if "refused" in r:
            continue
        m = r["memory"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['chips']} | "
            f"{r['run_s']} | {r['flops_per_device']:.2e} | "
            f"{r['hbm_bytes_per_device']:.2e} | "
            f"{r['roofline']['collective_bytes']:.2e} | "
            f"{m['argument_bytes'] / 1e9:.2f} | "
            f"{m['temp_bytes'] / 1e9:.2f} |")
    return "\n".join(out)


def refused_table(recs: List[Dict]) -> str:
    out = _head(("arch", "shape", "mesh", "reason"))
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if "refused" in r:
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"{r['refused']} |")
    return "\n".join(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="")
    ap.add_argument("--results-dir", default=RESULTS_DIR)
    args = ap.parse_args()
    recs = load(args.tag, args.results_dir)
    n_ref = sum("refused" in r for r in recs)
    print(f"{len(recs)} cells: {len(recs) - n_ref} ran, {n_ref} refused\n")
    print("## Dry-run (both meshes; per device, shape-only on the host)\n")
    print(dryrun_table(recs))
    print("\n## Roofline (single mesh, per-device terms; analytic: H100 SXM "
          "datasheet rates, not measured)\n")
    print(roofline_table(recs, "single"))
    if n_ref:
        print("\n## Cells the port refuses\n")
        print(refused_table(recs))


if __name__ == "__main__":
    main()
