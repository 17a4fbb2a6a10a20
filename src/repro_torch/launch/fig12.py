"""Paper Fig. 12 on the port: latency against the expansion factor f.

  PYTHONPATH=src python -m repro_torch.launch.fig12                # card
  PYTHONPATH=src python -m repro_torch.launch.fig12 --shape 64,4096,4096 \\
      --dtype bfloat16 --op matvec --out /tmp/fig12.json
  PYTHONPATH=src python -m repro_torch.launch.fig12 --device cpu --quick

Two sections (counterpart of ``benchmarks/fig12_expansion.py``):

1. **The paper's accelerator model** (:func:`model_rows`): the D-com
   hardware model, pure arithmetic, reproducing the paper's f* = 8 and
   its ~6.2× speedup over f = 1 (asserted).  Its rows are the paper's
   model of its own accelerator, not a measurement of anything here.
2. **The tuned-vs-default-vs-optimum A/B** (:func:`run_ab`) on the CUDA
   kernel of the expanded matvec: ONE measured sweep of the whole
   expansion grid (``prune=None``, at ``row_block``/``col_block`` 512),
   then the tuner's production pruning (``DEFAULT_PRUNE``) replayed on
   that same table: "tuned" is the measured winner among the model's
   survivors, exactly what ``tune(..., prune=DEFAULT_PRUNE)`` returns
   given these times.  The gate is real: if the model prunes the true
   optimum away, tuned lands on a worse survivor, a 3×-reps head-to-head
   re-measure separates a pruning miss from noise, and
   ``tuned_vs_opt <= 1.05`` is asserted.

``--device cpu --quick`` runs the A/B on the kernels' plain versions at
a small shape (the CPU tests); its times are host times.  Without a GPU
and without ``--device cpu`` it raises.  The JSON goes only to an
``--out`` path that is given.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Sequence

from ..ioutil import atomic_write_json
from ..platform import device_name, resolve_device

# --- D-com hardware model (paper §5; benchmarks/fig12_expansion.py) -------
S, H, K, BATCH = 4096, 4096, 10, 64
CLUSTERS = 256                      # 16 × 16
MACS_PER_CLUSTER = 64               # 8 × 8 FP16
CLOCK = 1.0e9
PEAK_MAC = CLUSTERS * MACS_PER_CLUSTER * CLOCK          # 16.4 TMAC/s
BANK_BW_TOTAL = 2.0e12              # aggregate distributed-SRAM bandwidth
F_SAT = 8                           # banks engaged per vector chunk at sat.
COMBINE_LAT = 2e-6                  # global broadcast/aggregate per step
MODEL_FS = (1, 2, 4, 8, 16, 32, 64, 128)

#: the A/B's gate: tuned within 5 % of the swept optimum
GATE = 1.05


def reorth_latency(f: int) -> float:
    """One fused re-orthogonalization step of a [S, H] fp16 tile at
    expansion factor f (per prompt), on the paper's accelerator."""
    a_bytes = S * H * 2
    bw = BANK_BW_TOTAL * min(f, F_SAT) / F_SAT
    t_mem = a_bytes / bw
    base_macs = 2 * S * H + 4 * (S + H) * K
    dup_macs = (f - 1) * (S + H) * K * 4
    t_comp = (base_macs + dup_macs) / PEAK_MAC
    t_comb = COMBINE_LAT * (1 + (f.bit_length() - 1))
    return max(t_mem, t_comp) + t_comb


def batch_decomposition_latency(f: int) -> float:
    """Full batch: 2 re-orth steps × K iterations × BATCH prompts."""
    return reorth_latency(f) * 2 * K * BATCH


def model_rows() -> Dict[str, object]:
    """The paper's accelerator model over f: {f: seconds}, f* and the
    speedup of f* over f = 1; asserts the paper's f* = 8."""
    lat = {f: batch_decomposition_latency(f) for f in MODEL_FS}
    best = min(lat, key=lat.get)
    assert best == 8, "the accelerator model must reproduce the paper's f*"
    return {"latency_s": lat, "f_star": best,
            "speedup_vs_f1": lat[1] / lat[best]}


def _block_key(kernel: str) -> str:
    return "row_block" if kernel == "matvec_expand" else "col_block"


def run_ab(op: str = "matvec", shape: Sequence[int] = (1024, 2048),
           dtype: str = "float32", *, reps: int = 5,
           device="cuda") -> Dict[str, object]:
    """Tuned-vs-default-vs-swept-optimum A/B of the expanded ``op``
    ("matvec": y = A·v, the ``matvec_expand`` space; "rmatvec": z = Aᵀ·u,
    ``rmatvec_expand``) at ``shape`` ([S, H] or [B, S, H]) on ``device``.

    The L2 is flushed before each timed call of a 2-D (one-matrix)
    shape.  ``calls`` counts the wrapper calls the A/B made: candidates ×
    (warmup + reps), plus the re-measure's."""
    from .. import tune

    kernel = f"{op}_expand"
    dev = resolve_device(device)
    flush = len(shape) == 2
    block = _block_key(kernel)
    res = tune.tune(kernel, shape, dtype, fix={block: 512},
                    measure_candidates=True, prune=None, reps=reps,
                    device=dev, force=True, persist=False, flush_l2=flush)
    warmup = 2                          # measure_candidate's default
    calls = len(res.table) * (warmup + reps)

    by_model = sorted(res.table, key=lambda row: row[1])
    survivors = by_model[:tune.DEFAULT_PRUNE]
    tuned_cand, _, tuned_s = min(survivors, key=lambda row: row[2])
    swept = {int(c["expansion"]): m for c, _, m in res.table}
    opt_cand, opt_s = res.swept_optimum()
    remeasured = tuned_s > GATE * opt_s and tuned_cand != opt_cand
    if remeasured:
        # finalists head to head at 3× reps: one sweep sample per f is
        # noise-prone; this separates a pruning miss from a hiccup
        tuned_s, opt_s = (tune.measure_candidate(
            kernel, res.shape, res.dtype, c, reps=3 * reps, device=dev,
            flush_l2=flush) for c in (tuned_cand, opt_cand))
        calls += 2 * (warmup + 3 * reps)
    default_f = tune.get_space(kernel).param("expansion").default
    return {
        "op": op, "kernel": kernel, "shape": list(res.shape),
        "dtype": res.dtype, "device": str(dev),
        "device_kind": tune.device_kind(dev),
        "device_name": device_name(dev), "flush_l2": flush,
        "swept_s": swept, "prune": tune.DEFAULT_PRUNE,
        "pruned_fs": [int(c["expansion"]) for c, _, _ in survivors],
        "model_pick_f": int(by_model[0][0]["expansion"]),
        "model_s": {int(c["expansion"]): p for c, p, _ in res.table},
        "tuned_f": int(tuned_cand["expansion"]), "tuned_s": tuned_s,
        "default_f": default_f, "default_s": swept[default_f],
        "opt_f": int(opt_cand["expansion"]), "opt_s": opt_s,
        "tuned_vs_opt": tuned_s / opt_s,
        "default_vs_opt": swept[default_f] / opt_s,
        "f1_vs_opt": swept[1] / opt_s,
        "remeasured": remeasured, "calls": calls,
    }


def check_gate(data: Dict[str, object]) -> None:
    assert data["tuned_vs_opt"] <= GATE, (
        f"tuned f={data['tuned_f']} is {data['tuned_vs_opt']:.3f}x the "
        f"swept optimum f={data['opt_f']} (gate {GATE})")


def ab_lines(data: Dict[str, object]) -> List[str]:
    """Human-readable lines of one A/B (times in ms)."""
    ms = lambda s: f"{s * 1e3:.4f}"  # noqa: E731
    shape = "x".join(str(d) for d in data["shape"])
    head = f"fig12: {data['op']} {shape} {data['dtype']} on " \
        f"{data['device_name']}"
    return [
        f"{head}: swept ms " + " ".join(
            f"f{f}={ms(s)}" for f, s in sorted(data["swept_s"].items())),
        f"{head}: model pick f={data['model_pick_f']}, survivors "
        f"{data['pruned_fs']} (prune {data['prune']}), tuned f="
        f"{data['tuned_f']} {ms(data['tuned_s'])} ms; default f="
        f"{data['default_f']} {ms(data['default_s'])} ms; optimum f="
        f"{data['opt_f']} {ms(data['opt_s'])} ms; tuned/opt "
        f"{data['tuned_vs_opt']:.4f} (gate {GATE}), default/opt "
        f"{data['default_vs_opt']:.4f}, f1/opt {data['f1_vs_opt']:.4f}, "
        f"re-measured {data['remeasured']}, calls {data['calls']}",
    ]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--op", choices=("matvec", "rmatvec"), default="matvec")
    ap.add_argument("--shape", default=None,
                    help="S,H or B,S,H (default 1024,2048; --quick "
                         "128,256)")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--quick", action="store_true",
                    help="small shape, 3 reps")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--out", default=None, help="write the JSON here")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    shape = tuple(int(d) for d in args.shape.split(",")) if args.shape \
        else ((128, 256) if args.quick else (1024, 2048))
    reps = 3 if args.quick else 5
    model = model_rows()
    for f, t in model["latency_s"].items():
        print(f"fig12 model (the paper's accelerator, not a measurement): "
              f"f={f} batch decomposition {t * 1e3:.3f} ms")
    print(f"fig12 model: f*={model['f_star']} (paper: 8), speedup over "
          f"f=1 {model['speedup_vs_f1']:.2f}x (paper: 6.2x)")
    data = run_ab(args.op, shape, args.dtype, reps=reps, device=dev)
    for line in ab_lines(data):
        print(line)
    if args.out:                       # atomic: never a torn file
        atomic_write_json(args.out, {"model": model, "ab": data}, indent=1,
                          sort_keys=True)
    check_gate(data)


if __name__ == "__main__":
    main()
