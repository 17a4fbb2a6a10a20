"""Serving CLI of the port: continuous batching on random weights.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \\
      --requests 4 --slots 4 --prompt-len 256 --max-new 32 --max-len 1024 \\
      --decompose-kv-rank 64 --dkv-tail 16

runs at the config's full width on the CUDA device (random weights drawn
on the card from seed 0; nothing is downloaded).  ``--reduced`` serves the
tiny same-family config, and ``--device cpu`` runs on the host (plain
PyTorch versions of the kernels), e.g. for a smoke run without a GPU:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \\
      --reduced --device cpu --decompose-kv-rank 8 --dkv-tail 4
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_arch
from ..engine import DecomposeEngine, EngineConfig
from ..kernels import ops
from ..models import transformer as T
from ..platform import device_name, resolve_device
from ..serving import Engine, Request


def main(argv=None) -> None:
    dflt = EngineConfig()
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the tiny same-family config")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--decompose-kv-rank", type=int, default=dflt.kv_rank,
                    help="serve the low-rank KV cache at this rank (0=off)")
    ap.add_argument("--dkv-tail", type=int, default=dflt.kv_tail,
                    help="dense recent-token tail length")
    ap.add_argument("--dkv-exact", action="store_true",
                    help="direct-SVD KV factorization (near-full rank)")
    ap.add_argument("--expansion", type=int, default=dflt.expansion,
                    help="compute-expansion factor f = warps per CTA of "
                         "the re-orth kernels (1..32)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=device).manual_seed(0)
    params = T.init(cfg, gen, device=device)
    dengine = DecomposeEngine(EngineConfig(
        expansion=args.expansion, kv_rank=args.decompose_kv_rank,
        kv_tail=args.dkv_tail, kv_exact=args.dkv_exact))
    eng = Engine(cfg, params, slots=args.slots, max_len=args.max_len,
                 decompose_engine=dengine, device=device)
    rng = np.random.RandomState(0)
    for i in range(args.requests):
        eng.submit(Request(uid=i, prompt=rng.randint(
            0, cfg.vocab, args.prompt_len, dtype=np.int32),
            max_new_tokens=args.max_new))
    ops.reset_launch_counts()
    done = eng.run()
    for r in sorted(done, key=lambda r: r.uid):
        print(f"req {r.uid}: {r.out_tokens}")
    s = eng.stats
    print(f"engine: {dengine} family={type(eng.family).__name__} "
          f"arch={cfg.name} layers={cfg.num_layers} "
          f"device={device_name(device)}")
    print(f"stats: prefills={s.prefills} batches={s.prefill_batches} "
          f"decode_steps={s.decode_steps} folds={s.tail_folds} "
          f"tokens={s.tokens_out} prefill_s={s.prefill_s:.3f} "
          f"decode_s={s.decode_s:.3f} decode_tok/s={s.decode_tok_s:.1f} "
          f"ttft={s.mean_ttft_s * 1e3:.1f}ms itl={s.mean_itl_s * 1e3:.1f}ms")
    print("kernel launches: " + " ".join(
        f"{k}={v}" for k, v in ops.launch_counts().items()))


if __name__ == "__main__":
    main()
