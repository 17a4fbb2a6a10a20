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

``--paged`` serves the decomposed cache from page pools (``--page-size``
rows per page, ``--pages`` pages, 0 = sized from the slots),
``--prefix-cache N`` keeps up to N decomposed prompts for prefix reuse
(``--kv-page`` and ``--kv-prefix-cache`` are the same flags under
their older names), and ``--shared-prefix L`` gives every request the
same first L prompt tokens, so later requests admit as prefix hits:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \\
      --requests 8 --prompt-len 512 --shared-prefix 496 --max-new 32 \\
      --max-len 1024 --decompose-kv-rank 64 --dkv-tail 16 --paged \\
      --prefix-cache 8

The command lines of the reference's serve CLI parse to the reference's
engine settings: ``--family dense|ssm|moe|hybrid`` serves that family's
default arch (``--arch`` overrides it, and must be of that family), and
the flag defaults are the reference's (``--dkv-tail 16``; the backend
and ``--expansion`` keep the port's defaults, ``cuda`` and 16, by
design).  The reference always serves a reduced config; here
``--reduced`` asks for it.

``--mesh`` serves on a ``DeviceMesh`` (``serving.Engine``): ``none``
(default), ``host`` (every rank on "data": slots data-parallel) or
``DxM`` (data x model): a "model" axis M > 1 runs every family
tensor-parallel (each rank its weight blocks and kv heads; Mamba2, the
ssm family and the hybrid's backbone: its block of SSD heads).  One
process per card, launched by torchrun; only rank 0 prints:

  torchrun --nproc-per-node 4 -m repro_torch.launch.serve --mesh 1x4 \\
      --arch llama2-7b --decompose-kv-rank 64 --dkv-tail 16 --slots 8

``--mesh 1x1`` runs a one-rank mesh on one card (a real NCCL group).  On
the host a gloo world of 4 serves the same way with ``--device cpu``
(``torchrun --nproc-per-node 4 ... --mesh 2x2 --reduced --device
cpu``).

``--arch mamba2-780m`` serves the Mamba2 (ssm) family: O(1) state slots,
prefill through the chunked SSD scan whose intra-chunk term is the CUDA
kernel ``ssd_chunk_intra`` (the decomposed-KV flags do not apply):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
      --requests 4 --prompt-len 512 --max-new 32 --max-len 1024
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
      --reduced --device cpu

``--decode-block N`` fuses up to N decode steps into one launch (a
replayed CUDA graph on the card; ``auto`` tunes N), ``--eos-id`` stops a
request on that token, ``--admission gang`` keeps the legacy
whole-batch admission, ``--sched-bucket``/``--admit-every``/
``--max-admit`` set the scheduler, and ``--backend reference`` runs the
plain versions of every kernel (the route check):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \\
      --reduced --device cpu --decompose-kv-rank 8 --dkv-tail 4 \\
      --decode-block 4 --eos-id 7 --max-admit 2

``--arch olmoe-1b-7b`` serves the mixture-of-experts family and
``--arch zamba2-1.2b`` the hybrid (Mamba2 plus a shared attention
block); ``kimi-k2-1t-a32b`` (MoE with a leading dense layer and a shared
expert) runs only with ``--reduced``.  ``--prefill-async`` dispatches
each admission's prefill as a ticket (on a side stream of the card) and
``--ready-order`` picks when tickets complete: ``ready`` (as their
prefills finish, decode going on meanwhile) or ``deterministic`` (at
their dispatch round: the sync engine's tokens):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
      --reduced --device cpu --prefill-async --ready-order deterministic

``--arch`` also takes the dense variants ``starcoder2-7b`` (layernorm,
biased linears, an ungated GELU MLP), ``gemma-2b`` (GeGLU, MQA with
head_dim 256, tied embeddings) and ``granite-3-2b`` (tied embeddings),
served dense or decomposed-KV, and the ``vlm`` family's
``llama-3.2-vision-11b`` and the ``audio`` family's
``seamless-m4t-medium``, whose image embeddings and encoder frames are
zero placeholders (the frontends are stubs, as in the reference; these
two serve with dense KV only).  ``--sampler categorical`` draws from
softmax(logits / ``--temperature``) with keys from ``--sample-seed``;
single-step and fused engines draw the same tokens:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      --reduced --device cpu --decompose-kv-rank 8 --dkv-tail 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
      --reduced --device cpu --sampler categorical --temperature 0.8 \
      --sample-seed 1 --decode-block 4

``--expansion auto`` resolves the re-orth kernels' f per shape bucket
through ``repro_torch.tune`` and, during warmup, pre-tunes the shapes
admission will launch (``--no-pretune`` skips that); point
``REPRO_TUNE_CACHE`` at a temporary file to keep a run hermetic:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \\
      --reduced --device cpu --decompose-kv-rank 8 --dkv-tail 4 \\
      --expansion auto

``--backend auto`` picks the kernel route through
``repro_torch.tune.resolve_backend`` (the winner ``tune_backend`` stored
for this card, else ``cuda`` on a card and ``reference`` on the host).
``--metrics-out PATH`` writes every metric at exit (the engine's
registry and the process-wide ``obs.GLOBAL``: decomposition, tuner and
compile-watch counters) as Prometheus text, or as the JSON snapshot
when PATH ends in ``.json``; ``--trace-out PATH`` records
request-lifecycle spans as Chrome trace-event JSON (Perfetto-loadable);
``--stats-every N`` prints a p50/p95/p99 TTFT and ITL line every N
steps:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \\
      --reduced --device cpu --decompose-kv-rank 8 --dkv-tail 4 \\
      --backend auto --metrics-out m.prom --trace-out t.json \\
      --stats-every 2
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_arch
from ..engine import DecomposeEngine, EngineConfig
from ..engine.backends import available_backends
from ..kernels import ops
from ..models.api import model_fns
from ..obs import (GLOBAL, Observability, compile_stats, write_json_snapshot,
                   write_prometheus)
from ..platform import device_name, resolve_device
from ..serving import (ADMISSIONS, READY_ORDERS, Engine, Request,
                       categorical_sampler, greedy_sampler)
from .mesh import parse_mesh, shutdown_distributed

#: configs too large for one card: served only ``--reduced``
REDUCED_ONLY = ("kimi-k2-1t-a32b",)

#: ``--family NAME`` without ``--arch`` serves this arch (the reference's)
_FAMILY_DEFAULT_ARCH = {
    "dense": "llama2-7b",
    "ssm": "mamba2-780m",
    "moe": "olmoe-1b-7b",
    "hybrid": "zamba2-1.2b",
}


def _expansion(text: str):
    """``--expansion``/``--decode-block``: "auto" or an int
    (EngineConfig validates it)."""
    return text if text == "auto" else int(text)


def pretune_admission(cfg, dengine, slots: int, prompt_len: int,
                      device, say=print) -> None:
    """Serving warmup for ``expansion="auto"``: resolve the re-orth f of
    every shape admission will launch — the prefill decomposition
    ``decompose_kv`` runs on [num_layers · n, plen_bucket, kvw] for each
    power-of-two admission batch n <= slots (and slots itself) — with the
    engine's backend pinned, and print one line per entry."""
    from .. import tune
    bucket = max(1, dengine.config.sched_bucket)
    plen = -(-prompt_len // bucket) * bucket
    slots = max(1, slots)
    nbs, n = {slots}, 1
    while n < slots:
        nbs.add(n)
        n *= 2
    pre = tune.pretune(
        {"lanczos_reorth": [(cfg.num_layers * n, plen, cfg.kv_width)
                            for n in sorted(nbs)]},
        fix={"backend": dengine.resolved_backend}, device=device)
    for key, res in pre.items():
        say(f"pretune[{res.kernel}]: f={res.best['expansion']} "
            f"({res.source}, {key})")


def main(argv=None) -> None:
    dflt = EngineConfig()
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="architecture name (default: the --family's "
                         "default arch, else llama2-7b)")
    ap.add_argument("--family", default=None,
                    choices=sorted(_FAMILY_DEFAULT_ARCH),
                    help="serve this family's default arch (ssm = "
                         "mamba2-780m, moe = olmoe-1b-7b, hybrid = "
                         "zamba2-1.2b, dense = llama2-7b); --arch "
                         "overrides it and must be of that family")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the tiny same-family config")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--decompose-kv-rank", type=int, default=dflt.kv_rank,
                    help="serve the low-rank KV cache at this rank (0=off)")
    ap.add_argument("--dkv-tail", type=int, default=16,
                    help="dense recent-token tail length")
    ap.add_argument("--dkv-exact", action="store_true",
                    help="direct-SVD KV factorization (near-full rank)")
    ap.add_argument("--paged", action="store_true",
                    help="page-pool decomposed KV cache (needs "
                         "--decompose-kv-rank > 0)")
    ap.add_argument("--pages", type=int, default=dflt.kv_pool_pages,
                    help="page-pool size in pages (0 = sized from slots x "
                         "max-len with fold headroom)")
    ap.add_argument("--page-size", "--kv-page", dest="page_size", type=int,
                    default=dflt.kv_page,
                    help="rows per page of the paged cache")
    ap.add_argument("--prefix-cache", "--kv-prefix-cache",
                    dest="prefix_cache", type=int,
                    default=dflt.kv_prefix_cache,
                    help="prefix-cache entries of the paged cache (0=off)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="the first N prompt tokens are the same in "
                         "every request (a common system prompt)")
    ap.add_argument("--expansion", type=_expansion, default=dflt.expansion,
                    help="compute-expansion factor f = blocks along the "
                         "output axis of the re-orth kernels (1..32), or "
                         "auto (tuned per shape bucket)")
    ap.add_argument("--backend", default=dflt.backend,
                    choices=available_backends() + ["auto"],
                    help="cuda: the CUDA kernels on the card (plain "
                         "versions on the host); reference: the plain "
                         "versions everywhere (the route check); auto: "
                         "the tuned winner of this machine")
    ap.add_argument("--decode-block", type=_expansion,
                    default=dflt.decode_block,
                    help="fused decode steps per launch (1 = one per "
                         "token; N > 1 replays a captured CUDA graph on "
                         "the card, token-exact), or auto (tuned)")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="stop token: a request finishes (and frees its "
                         "slot) the moment it emits it")
    ap.add_argument("--admission", default="per_slot", choices=ADMISSIONS,
                    help="admission policy (gang = legacy whole-batch "
                         "prefill, for A/B runs)")
    ap.add_argument("--sched-bucket", type=int, default=dflt.sched_bucket,
                    help="prefill length bucket")
    ap.add_argument("--admit-every", type=int,
                    default=dflt.sched_admit_every,
                    help="decode rounds between admission checks")
    ap.add_argument("--max-admit", type=int, default=dflt.sched_max_admit,
                    help="requests per admission batch (0 = free slots)")
    ap.add_argument("--no-pretune", action="store_true",
                    help="with --expansion auto, skip the warmup "
                         "pre-tune of the admission shapes")
    ap.add_argument("--prefill-async", action="store_true",
                    help="dispatch each admission's prefill as a ticket "
                         "(on a side stream of the card)")
    ap.add_argument("--ready-order", default="ready", choices=READY_ORDERS,
                    help="with --prefill-async: complete tickets as they "
                         "finish (ready) or at their dispatch round "
                         "(deterministic: the sync engine's tokens)")
    ap.add_argument("--sampler", default="greedy",
                    choices=("greedy", "categorical"),
                    help="greedy (argmax) or categorical (keyed draws "
                         "from softmax(logits / temperature))")
    ap.add_argument("--temperature", type=float, default=1.0,
                    help="with --sampler categorical")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="seed of the keyed draws")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--mesh", default="none",
                    help="serving mesh: none (default), host (every rank "
                         "on the data axis) or DxM (data x model); launch "
                         "one process per card with torchrun")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write every metric (engine stats + decomposition"
                         "/tuner/compile telemetry) here at exit: "
                         "Prometheus text, or the JSON snapshot when PATH "
                         "ends in .json")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record request-lifecycle spans and write Chrome "
                         "trace-event JSON (Perfetto-loadable) here at exit")
    ap.add_argument("--stats-every", type=int, default=0, metavar="N",
                    help="print a p50/p95/p99 stats line every N engine "
                         "steps (0 = only the final summary)")
    args = ap.parse_args(argv)
    if args.arch is None:
        args.arch = _FAMILY_DEFAULT_ARCH.get(args.family, "llama2-7b")
    if args.arch in REDUCED_ONLY and not args.reduced:
        ap.error(f"{args.arch} does not fit one card: add --reduced")

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.family is not None and cfg.family != args.family:
        ap.error(f"--arch {args.arch} is family {cfg.family!r}, "
                 f"not {args.family!r}")
    if args.reduced:
        cfg = cfg.reduced()
    mesh = parse_mesh(args.mesh, device)
    if mesh is not None:
        import torch.distributed as dist
        lead = dist.get_rank() == 0
    else:
        lead = True

    def say(*a, **kw):                   # only rank 0 prints
        if lead:
            print(*a, **kw)

    gen = torch.Generator(device=device).manual_seed(0)
    params = model_fns(cfg).init(cfg, gen, device=device)
    dengine = DecomposeEngine(EngineConfig(
        backend=args.backend, expansion=args.expansion,
        kv_rank=args.decompose_kv_rank, kv_tail=args.dkv_tail,
        kv_exact=args.dkv_exact, kv_page=args.page_size,
        kv_pool_pages=args.pages, kv_prefix_cache=args.prefix_cache,
        sched_bucket=args.sched_bucket,
        sched_admit_every=args.admit_every,
        sched_max_admit=args.max_admit, decode_block=args.decode_block,
        mesh=mesh))
    sampler = categorical_sampler(args.temperature) \
        if args.sampler == "categorical" else greedy_sampler
    if args.expansion == "auto" and not args.no_pretune \
            and args.decompose_kv_rank > 0:
        pretune_admission(cfg, dengine, args.slots, args.prompt_len, device,
                          say)
    obs = Observability(trace=args.trace_out is not None)
    eng = Engine(cfg, params, slots=args.slots, max_len=args.max_len,
                 decompose_engine=dengine, device=device, paged=args.paged,
                 eos_id=args.eos_id, admission=args.admission,
                 prefill_async=args.prefill_async,
                 ready_order=args.ready_order, sampler=sampler,
                 sample_seed=args.sample_seed, obs=obs)
    rng = np.random.RandomState(0)
    shared = rng.randint(0, cfg.vocab, args.shared_prefix, dtype=np.int32)
    for i in range(args.requests):
        own = rng.randint(0, cfg.vocab, args.prompt_len - len(shared),
                          dtype=np.int32)
        eng.submit(Request(uid=i, prompt=np.concatenate([shared, own]),
                           max_new_tokens=args.max_new))
    ops.reset_launch_counts()
    if args.stats_every > 0:
        # drive step() directly so the periodic lines land on step edges
        done, steps = [], 0
        while steps < 10_000:
            done.extend(eng.step())
            steps += 1
            if steps % args.stats_every == 0:
                say(pctl_line(eng.stats, prefix=f"step {steps}: "))
            if not eng._occupied() and not len(eng.sched):
                break
    else:
        done = eng.run()
    for r in sorted(done, key=lambda r: r.uid):
        say(f"req {r.uid}: {r.out_tokens}")
    s = eng.stats
    g = eng.graphs
    mesh_desc = "none" if mesh is None else "x".join(
        str(n) for n in mesh.mesh.shape)
    say(f"engine: {dengine} family={type(eng.family).__name__} "
        f"arch={cfg.name} layers={cfg.num_layers} mesh={mesh_desc} "
        f"device={device_name(device)} admission={eng.admission} "
        f"decode_block={eng.decode_block} "
        f"prefill_async={eng.prefill_async} "
        f"ready_order={eng.ready_order} sampler={args.sampler}"
        + (f"(T={args.temperature}, seed={args.sample_seed})"
           if args.sampler == "categorical" else ""))
    say(f"stats: prefills={s.prefills} batches={s.prefill_batches} "
        f"decode_steps={s.decode_steps} blocks={s.blocks} "
        f"folds={s.tail_folds} tokens={s.tokens_out} "
        f"stopped_eos={s.stopped_eos} stopped_budget={s.stopped_budget} "
        f"prefill_s={s.prefill_s:.3f} decode_s={s.decode_s:.3f} "
        f"decode_tok/s={s.decode_tok_s:.1f} "
        f"ttft={s.mean_ttft_s * 1e3:.1f}ms "
        f"(queue {s.mean_ttft_queue_s * 1e3:.1f}ms + prefill "
        f"{s.mean_ttft_compute_s * 1e3:.1f}ms) "
        f"itl={s.mean_itl_s * 1e3:.1f}ms "
        f"inflight_peak={s.prefill_inflight_peak}")
    say(pctl_line(s))
    say(f"graphs: captures={g.captures} replays={g.replays} "
        f"eager={g.eager} capture_s={g.capture_s:.3f}")
    if eng.pager is not None:
        say(f"paged: page={eng.pager.page} pool_pages="
            f"{eng.pager.num_pages} prefix_hits={s.prefix_hits} "
            f"prefix_misses={s.prefix_misses} stalls={s.stalls}")
    say("kernel launches: " + " ".join(
        f"{k}={v}" for k, v in ops.launch_counts().items()))
    cw = compile_stats()
    if cw:
        say("compiles: " + " ".join(
            f"{ph}={d['compiles']}({d['seconds']:.2f}s)"
            for ph, d in sorted(cw.items())))
    if args.metrics_out and lead:
        # the engine's registry (serving_*) and the process-wide one
        # (decomposition, tuner and compile telemetry) in one file
        if args.metrics_out.endswith(".json"):
            write_json_snapshot(args.metrics_out, obs.registry, GLOBAL)
        else:
            write_prometheus(args.metrics_out, obs.registry, GLOBAL)
        say(f"metrics: wrote {args.metrics_out}")
    if args.trace_out and lead:
        obs.tracer.export(args.trace_out)
        say(f"trace: wrote {args.trace_out} "
            f"({len(obs.tracer.events)} events, "
            f"{obs.tracer.dropped} dropped)")
    if mesh is not None:
        # the group's threads must not outlive the interpreter (gloo
        # aborts the process at exit otherwise)
        del eng
        shutdown_distributed()


def pctl_line(s, prefix: str = "") -> str:
    """p50/p95/p99 TTFT and ITL (ms) from the streaming histograms."""
    def pct(series):
        return "/".join(f"{series.quantile(q) * 1e3:.1f}"
                        for q in (0.5, 0.95, 0.99))
    return (f"{prefix}pctl: ttft_ms p50/p95/p99={pct(s.ttft_s)} "
            f"itl_ms p50/p95/p99={pct(s.itl_s)} tokens={s.tokens_out}")


if __name__ == "__main__":
    main()
