"""Training CLI of the port: the fault-tolerant loop (checkpoint/restart,
replay from the restored step) on the synthetic stream.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --steps 5 --seq-len 512 --batch 4 --ckpt-every 1000

trains the config at full width on the CUDA device (random weights drawn
on the card from ``--seed``; nothing is downloaded), through the port's
kernels (``--backend reference``: their plain versions under autograd).
A checkpoint of the whole state is written every ``--ckpt-every`` steps
and once at the end (granite-3-2b's bf16 weights and float32 AdamW
moments: ~28 GiB), and a run resumes from the latest one under
``--ckpt-dir``.  ``--smoke`` trains the reduced same-family config and
``--device cpu`` runs on the host:

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama2-7b \\
      --smoke --device cpu --steps 3

Without ``--device cpu`` it raises when there is no GPU.

``--mesh DxM`` (the port's extension of the reference's CLI, as the
serve CLI's ``--mesh``) trains SPMD on a (data, model) mesh, one process
per card under torchrun: the batch over "data", every family
tensor-parallel over "model" when M > 1, and with ``--zero1``
AdamW's moments sharded over the DP axis; a config with experts splits
its batch too, its MoE blocks in the reference's global form (capacity
from the whole batch), or with ``--moe-shard-map`` in its per-shard
form.  The saved state is whole, so a run restarts on any other mesh:

  torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch granite-3-2b --mesh 2x2 --zero1 --steps 5 --seq-len 512 \\
      --batch 4 --ckpt-dir /tmp/ck

and on the host through a gloo world (``--smoke --device cpu``).  Only
rank 0 prints.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from ..configs import ShapeSpec, get_arch
from ..kernels.ops import BACKENDS
from ..runtime.driver import train_loop
from .mesh import parse_mesh, shutdown_distributed


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (host-sized)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--backend", default="cuda", choices=BACKENDS,
                    help="the kernel set: the CUDA kernels (their plain "
                         "versions on the host), or 'reference' (plain "
                         "versions everywhere)")
    ap.add_argument("--mesh", default="none",
                    help="none (default), host (every rank on 'data') or "
                         "DxM (data x model); one process per card under "
                         "torchrun")
    ap.add_argument("--zero1", action="store_true",
                    help="shard AdamW's moments over the DP axis (ZeRO-1)")
    ap.add_argument("--moe-shard-map", action="store_true",
                    help="a config with experts routes each DP rank's "
                         "tokens alone (the reference's moe_ffn_shard_map: "
                         "per-shard capacity and aux loss), not with the "
                         "whole batch's capacity")
    args = ap.parse_args(argv)
    mesh = parse_mesh(args.mesh, args.device)
    lead = True
    if mesh is not None:
        import torch.distributed as dist
        lead = dist.get_rank() == 0

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if args.moe_shard_map:
        cfg = cfg.replace(moe_shard_map=True)
    shape = ShapeSpec("cli", args.seq_len, args.batch, "train")
    os.makedirs(args.ckpt_dir, exist_ok=True)
    res = train_loop(cfg, shape, total_steps=args.steps,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     seed=args.seed, device=args.device,
                     backend=args.backend, mesh=mesh, zero1=args.zero1,
                     print_fn=print if lead else (lambda *a: None))
    final = f"{res.losses[-1]:.4f}" if res.losses else "none"
    if lead:
        print(f"done: step={res.step} final_loss={final} "
              f"restarts={res.restarts} stragglers={res.straggler_flags} "
              f"ckpt_bytes={res.ckpt_bytes}")
    if mesh is not None:
        shutdown_distributed()


if __name__ == "__main__":
    main()
