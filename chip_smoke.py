#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py              # every phase, one card
    python3 chip_smoke.py --profile    # also profile serving (single-
                                       # step and fused), one decomposed
                                       # forward, the shared-prefix run,
                                       # Mamba2, hybrid and MoE serving
                                       # and one mamba2-780m train step

Phases (any failure exits non-zero; nothing is caught and passed over):

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of ``src/repro_torch/kernels/csrc`` with nvcc
   (all sources compile in parallel);
3. each kernel against its plain PyTorch version on the card, at the
   shapes decomposed-KV serving of llama2-7b gives it: max abs error
   within the stated tolerance, then CUDA-event times of the kernel, the
   plain version and a one-call PyTorch yardstick, and the bound (the
   least time the card could take: bytes over 3.35 TB/s or operations
   over the peak rate of the inputs' type, whichever is larger).  An
   empty kernel is timed first (``launch floor:``); the re-orth, dkv
   and matvec rows carry it as ``launch_floor_ms`` (the re-orth rows
   also their time with the L2 flushed before each call, ``ms_l2_cold``,
   beside the plain version's, their f and their cluster's CTAs), and
   the dkv rows also their
   reruns held bit-identical and their and SDPA's times with the L2
   flushed before each call.  The operating-point knobs: the GEMM row at
   N 4096 also holds the bf16 kernel at expansion 1, 8, 16, 32 x n_block
   128, 512, and phase 4's dkv row the kernel at expansion 1, 8, 32, each
   against its plain version at the same point, reruns bit-identical
   (their ``knobs`` fields: error and warm ms);
4. decomposed-KV serving of llama2-7b at full width and depth (random
   bf16 weights from a seed): 4 requests of 512/384/300/128 prompt
   tokens, two admitted while others decode, slots 4, rank 64, tail 16,
   32 new tokens each, max_len 1024.  Every request must finish, tails
   must fold, and each of the path's three kernels must have launched
   during the run; one decode step's logits through the kernel route are
   held against the plain ``_lowrank_attention`` route.  Then the same
   traffic fused (``decode_block=8``, each block the replay of a
   captured CUDA graph; blocks cut at the arrival rounds): tokens equal
   to the single-step run's, no block decoded eagerly, and the replays'
   kernel launches (the warm-up's apart) equal the single-step run's;
   the same pair at 128 new tokens (more replays than captures); an eos
   run (``eos_id`` = request 0's 16th token) fused and single-step with
   equal tokens and ``stopped_eos``; and ``dispatch:``, one eager decode
   step against one replay of its graph (the cost model's host
   constant).  Each fused line prints decode tok/s (with and without
   the host time of warm-up and capture) against single-step, blocks,
   captures, replays and peak memory;
5. conformance on a small input: greedy tokens of decomposed-KV serving
   at full rank (direct SVD) equal dense serving on a reduced float32
   llama2 config, through the kernels;
6. the paper's activation-decomposition forward of llama2-7b at full
   width and depth on the same weights: tokens [1, 4096] from
   ``numpy.random.RandomState(0)``, the paper's best policy (the
   10-layer set, rank 20, 3 % outlier channels), threshold 3.0,
   ``attn_mode="dense"``.  The launch counts of one forward must be
   exactly 50 lowrank_matmul / 20 outlier_stats / 400 left / 380 right
   re-orth.  Route check against the same forward through the plain
   versions (``backend="reference"``): on each decomposition's own
   input both select the same channels (20 / 20); in bf16 the logits
   agree within 2e-2 free running (on two prompts) and with the plain
   route forced onto the kernel route's channels; in float32 (float32
   weights) every decomposition selects the same channels end to end
   and the logits agree within 1e-3.  One decomposition and one
   projection at layer 10's real input are held kernel against plain in
   float32; it prints the dense and decomposed forward times (median of
   3, CUDA events), KL(dense ‖ decomposed) and peak memory.

7. paged serving of llama2-7b on the same weights (page 16, rank 64,
   tail 16): (a) phase 4's traffic through ``Engine(paged=True)`` gives
   phase 4's tokens, and every page comes back (slot and paged engines
   run in turns, slot, paged, paged, slot, to compare their speeds), and
   fused at 32 and 128 new tokens, as in phase 4; (b) shared-prefix
   serving: 8 requests of a common 496-token system prompt
   (``RandomState(2)``) plus 16 distinct tokens, request 0 at step 0 and
   1-7 at step 2, 32 new tokens each, prefix cache 8: 1 miss and 7 hits,
   no re-orth launch in any hit admission, folds, the paged kernel (and
   not the slab one) launched, every page back after ``drop_all``; miss
   and hit TTFT, decode tok/s and peak memory are printed; one paged
   decode step through the kernel is held against the plain route
   (attention 1e-4 in bf16, float32 logits 1e-3).
8. Mamba2 serving of ``mamba2-780m`` at full width and depth (random bf16
   weights from seed 0; the llama2-7b weights are dropped first, and the
   device must then hold under 0.5 GiB: every earlier engine is freed
   without a garbage-collection pass, as again after Mamba2): phase
   4's traffic (prompts of 512/384/300/128 tokens on its arrival
   schedule, 32 new tokens, 4 slots, max_len 1024, greedy), so prefill
   runs both chunk regimes (Q = 64 with the inter-chunk scan, one chunk
   of Q = 304).  Every request must finish, ``ssd_chunk_intra`` must
   launch exactly 48 times per prefill launch and no other kernel at
   all (and fused at 32 and 128 new tokens, as in phase 4); a route
   check against ``backend="reference"`` on the card
   prefills the 512- and 300-token prompts through both routes: logits
   relative L2 within 2e-2 in bf16 and 1e-3 with float32 weights, final
   SSM and conv state within the same relative L2 in bf16 and allclose
   (rtol 1e-3, atol 1e-3 of the largest entry) in float32.

9. the autotuner and the paper's Fig. 12 expansion sweep: the A/B of
   ``repro_torch.launch.fig12.run_ab`` at four operating points (matvec
   and rmatvec at A [4096, 4096] float32, L2 flushed per call, and at the
   paper's batch 64, S = H = 4096 in bf16): the whole grid f = 1..128
   measured through the CUDA kernel, the tuner's pruning replayed on that
   table, tuned / default (f = 8) / optimum printed with f = 1 over the
   optimum, tuned within 1.05x of the optimum asserted, and the launch
   counters raised by exactly the calls of each A/B; the H100 cost
   model's constants fitted to the matvec sweeps; a measured tune of the
   re-orth kernel's blocks per element f (a cluster of min(f, 16) CTAs)
   at phase 4's [32, 512, 4096] and phase 6's [1, 4096, 4096] (printed
   with the model's curve, not gated; a second tune hits the cache) and
   the left step's curve at both; measured tunes of the ``lowrank_matmul``
   (expansion x n_block) and ``dkv_attention`` (expansion) spaces in bf16
   at (k, H, N) (20, 4096, 4096) and (20, 4096, 11008) and (B, G, T, r)
   (4, 32, 512, 64) and (1, 32, 8192, 64) (7 launches a candidate and no
   other kernel's, a second tune from the cache, asserted; the measured
   and model curves beside the card's own plan and torch.matmul / SDPA at
   the measured shape, not gated); and an
   ``EngineConfig(expansion="auto")`` decomposition of one such batch,
   bit-identical to the engine pinned at the resolved f.  The tuning
   cache is a temporary file of the run.

10. async admission on llama2-7b (after phase 7, the same weights):
   phase 4's traffic through ``prefill_async=True`` engines, whose
   prefills run on the prefill stream: sync and ``"ready"`` slab runs
   in turns (sync, ready, ready, sync), and a ready paged run: every
   request finished, a ticket in flight at least once, every slot and
   page back; in ``ready_order="deterministic"``, slab and paged at
   ``decode_block`` 1 and 8, tokens equal to the sync run's in the same
   call (and phase 4's).  Each run prints decode tok/s, the TTFT split
   (queue wait + prefill) and the mean and largest ITL of the streams
   already live in the steps that dispatched or spliced a prefill,
   against the other steps' mean.
11. hybrid serving of ``zamba2-1.2b`` at full width and depth (38
   layers, d_model 2048, 32 heads, d_ff 8192, state 64, a shared
   attention block every 6 layers; random bf16 weights from seed 0,
   after Mamba2's are freed) on phase 4's traffic: exactly 32
   ``ssd_chunk_intra`` launches per prefill launch and no other kernel;
   fused (``decode_block=8``) tokens equal to single-step's with every
   block a replay; sync and ready runs in turns, as in phase 10 (ready
   tokens equal to sync's: rows never interact); async deterministic
   tokens, single-step and fused, equal to sync's; the replayed decode
   step against its bound; phase
   8's prefill route check (512- and 300-token prompts, bf16 and
   float32: logits, Mamba2 states, the shared block's K).
12. MoE serving of ``olmoe-1b-7b`` at full width and depth (16 layers,
   d_model 2048, 64 experts top 8, expert d_ff 1024; random bf16
   weights) at its own capacity factor 1.25 on phase 4's traffic: no
   port kernel launched; fused tokens equal to single-step's, every
   block a replay; sync and ready runs in turns (ready tokens may
   differ: an admission a step later changes the batches that share
   expert capacity); async deterministic equal to sync; the replayed
   decode step against its bound (every weight and the KV cache read
   once, all 64 experts' weights among them).

13. keyed sampling on llama2-7b (after phase 10, the same weights):
   ``categorical_sampler(1.0)`` with seed 0 on phase 4's traffic
   (decomposed KV, rank 64, tail 16): tokens at ``decode_block`` 1, 3
   and 8 equal, every fused block a replay whose launches (the warm-up's
   apart) are the single-step run's; seed 0 again gives the same tokens,
   seed 1 other tokens; async deterministic at blocks 1 and 8 gives the
   sync tokens.
14. the dense family's other variants at full width and depth, one at a
   time, each freed before the next (``freed:``): ``starcoder2-7b``
   (layernorm, biased linears, ungated GELU MLP, 36 query heads over 4
   KV heads), ``gemma-2b`` (GeGLU, MQA with head_dim 256, tied
   embeddings) and ``granite-3-2b`` (tied embeddings); random bf16
   weights from seed 0 with every bias and norm bias redrawn N(0,
   0.02²).  Phase 4's traffic decomposed-KV (rank 64, tail 16),
   single-step and fused: every request finished, tails folded, the
   re-orth pair and the dkv kernel launched, fused tokens equal to
   single-step's; phase 4's decode route check; the replayed decode
   step against its bound (weights, a tied head whole, and the cache
   read once).  ``starcoder2-7b`` also runs phase 6's activation
   forward at tokens [1, 2048] (10 layers, rank 20; biases as one extra
   rank, so the Eq. 6 GEMM meets N 4608 / 512 / 18432 and the outlier
   statistics H 4608): exact launch counts, kernel vs
   ``backend="reference"`` logits within phase 6's bf16 bar.
15. the VLM (``llama-3.2-vision-11b``: 8 × (4 self + 1 tanh-gated cross
   block), 1601 image tokens) and audio (``seamless-m4t-medium``: 12 +
   12 layers, 4096 encoder frames) families at full width and depth,
   biases, norm biases and the VLM's gates redrawn N(0, 0.02²), image
   embeddings and frames the reference's zero placeholders: phase 4's
   traffic, the admission cost counting the image tokens or frames, no
   port kernel launched, fused tokens equal to single-step's, each
   request's staggered tokens equal to its solo run's, the replayed
   step against its bound, peak memory and ``freed:``.

16. observability and ``backend="auto"`` on llama2-7b (after phase 13,
   the same weights; ``--only obs``): phase 4's traffic fused
   (``decode_block=8``, rank 64, tail 16) through (a) a slab sync engine
   and (b) a paged async ``"ready"`` engine, each four times in turns,
   observability off, on (``Observability(trace=True)``), on, off, each
   engine dropped before the next: tokens equal ((a)'s also to
   phase 4's; (b)'s against (a)'s are printed: a ready ticket splices a
   round later than sync admits), every snapshot counter and every launch
   count equal, every block a replay, a valid Chrome trace with the four
   lifecycle spans of each request ((b) also ticket, splice and
   drain-pool spans); p50/p95/p99 TTFT (queue and prefill split) and ITL
   and each run's host wall printed (the overhead is reported, not
   gated); (c) the Prometheus text, the registry's JSON snapshot and the
   ``repro.obs/v1`` snapshot written through ``ioutil`` and read back
   (strict parser, schema key); (d) the exported graph counters equal
   ``BlockGraphs``', and the compile watch holds this phase's captures
   under ``decode`` and the run's nvcc builds under ``build``; (e)
   ``tune_backend`` at [32, 512, 4096] float32 (each backend's time and
   the winner printed), ``resolve_backend()`` gives the winner, and an
   ``EngineConfig(backend="auto")`` engine serves the tokens of the
   engine pinned to it.
17. training (``--only train``; random weights from seed 0,
   ``SyntheticLM(seed=0)`` at batch 4 × 512, ``make_optimizer(cfg,
   warmup=1)``): (a) ``granite-3-2b`` at full width and depth (2.53 B
   parameters), 5 AdamW steps of ``make_train_step`` with remat "full":
   each step's loss and gradient norm, the median step of steps 2-5
   beside its bound (8·N·T / 989 TFLOP/s + 22 B·N / 3.35 TB/s), peak
   memory gated under 70 GiB, then one PowerSGD (rank 4) round trip of
   the last gradient, its ratio equal to ``compression_ratio``; (b)
   ``mamba2-780m`` at full width and depth through the CUDA kernels and
   through ``backend="reference"`` from the same weights, step by step
   in turns: losses within 1e-3 relative at every step, the step-0
   gradient norm within 1e-3, the SSD forward and backward kernels'
   launches printed (the backward's gated non-zero); (c) the driver
   (``train_loop``) on ``mamba2-780m`` at depth 2: 6 steps, a checkpoint
   every 2, a failure at step 3, the losses after the restart equal to
   an uninterrupted run's within 1e-6 relative (bit equality printed),
   the bytes written printed, in a temporary directory.  The card then
   holds < 0.5 GiB.  With ``--profile``, (b) then runs one more
   kernel-route step under the profiler (``profile:`` lines: busy share,
   the port's kernels, the top device kernels).
18. the "data" axis of distribution (``--only mesh``), at world 1 on a
   real one-rank NCCL group (``launch.mesh.make_host_mesh(1, 1)``): (a)
   after phase 16, on the llama2-7b weights already loaded, phase 4's
   traffic (32 new tokens) through ``EngineConfig(mesh=...)`` beside the
   same engine without a mesh, in turns (no mesh, mesh, mesh, no mesh
   for single-step; no mesh, mesh for the fused block of 8 and for
   paged serving): the mesh run's tokens equal the no-mesh run's, its
   launch counts (re-orth pair and dkv) equal, every page back, the
   per-step token all-gather counted, decode tok/s of both printed; (b)
   ``decompose_kv`` at [32, 512, 4096] float32 (rank 64) on the mesh
   bit-equal to the no-mesh call, both timed; (c) after phase 17,
   ``mamba2-780m`` at depth 2 and full width: 3 data-parallel train
   steps (``make_train_step(mesh=)``) with PowerSGD (rank 4) through its
   NCCL all-reduces against the same 3 steps without a mesh (PowerSGD
   on in both): losses within 1e-6 relative (bit equality printed),
   the SSD forward and backward launches equal and non-zero;
   then the mesh run's state saved and ``restore_for_mesh``'d, every
   leaf equal.  The process group is destroyed at its end.
19. the "model" axis of distribution (``--only model``), at (1, 1) on a
   one-rank NCCL group.  The model code has one body for one device and
   for tensor parallelism (``distributed.tp``'s helpers are the identity
   on a "model" axis of 1), so this phase runs that body on a mesh: (a)
   after phase 18 (a, b), on the loaded llama2-7b weights, phase 4's
   traffic through the dkv engine with and without the mesh, in turns:
   tokens and the re-orth and dkv launch counts equal, no model-axis
   collective issued, decode tok/s of both, the run's collectives and
   one decode step's printed; (b) after phase 18 (c), ``granite-3-2b``
   at full width (depth cut to 4) for 3 AdamW steps with ZeRO-1 on the
   mesh against the same steps without a mesh: losses bit-equal;
   (c) the mesh run's state after step 1 saved whole
   (``driver.save_for_mesh``), ``restore_for_mesh``'d and fed to the
   step as DTensors (no ``unshard``), 2 more steps: the uninterrupted
   losses within 1e-6 relative; (d) the ssm, hybrid, vlm and audio
   families (``mamba2-780m`` depth 4, ``zamba2-1.2b`` depth 6: one group
   and its shared attention block, ``llama-3.2-vision-11b`` depth 5: one
   self group and a cross block, ``seamless-m4t-medium`` 2 + 2 layers;
   full width, bf16 weights from seed 0), phase 4's traffic at 16 new
   tokens with and without the mesh: tokens and SSD launches equal, no
   model-axis collective; (e) (b) and (c) on ``mamba2-780m`` (depth 4),
   whose steps run both SSD kernels: losses and launches equal, the
   resumed losses too.  The process group is destroyed at the end.  One
   card cannot show M > 1 (NCCL takes a card a rank): that is
   ``tests/test_torch_cuda.py -k nccl`` on four.
20. the rest of the "model" axis (``--only seq``), at world 1 on
   one-rank NCCL groups: (a) zamba2-1.2b's long_500k decode (a seeded
   batch-1 cache of 524,288 bf16 rows) with and without a (1, 1) mesh,
   whose decode merges the ranks' flash statistics; (b′) llama2-7b's
   decomposed-KV prefill of one 32,768-token prompt sequence-sharded
   (the time blocks moved to layer blocks by an all-to-all, each layer's
   whole K and V through the batched re-orth kernels): factors bit-equal
   and re-orth launches equal to no mesh's, 8 decode steps from each
   cache, the prefill's and decomposition's ms and peak, then the
   re-orth pair timed at one of four ranks' shape [8, 32768, 4096];
   (b) llama2-7b decomposed-KV decode at B = 1 over a frozen prefix of
   32,768 rows;
   (c) mamba2-780m (depth 4) batch-1 prefill and AdamW steps sharded
   along the sequence; (d) granite-3-2b (depth 4, float32) Adafactor
   ZeRO-1 with Megatron-SP on one-rank groups, (e) its resume; (f)
   zamba2-1.2b's float32 batch-1 prefill of 16,384 tokens with its peak
   memory; (g) the vlm and audio families (depth cut) at batch 1
   sequence-sharded: prefill, 4 decode steps, one AdamW step; (h)
   Megatron-SP in zamba2-1.2b's shared block and olmoe-1b-7b's dense
   block (one given to it), and with batch-1 sequence sharding in
   granite-3-2b: losses equal to no SP's, the SP collectives counted —
   each against the same work without a mesh.
21. the tools (``--only tools``): (a) Fig. 2's contenders on the card
   at [4096, 468] and [4096, 4096] float32 (the Fig. 2 benchmark's
   spectrum exp(-0.07 i) around orthonormal factors drawn from numpy's
   ``RandomState(0)``), ranks 1, 10, 20, 50: the scalar ``lanczos_svd``
   (iters min(r + 6, H)) through the B = 1 re-orth kernels and through
   ``backend="reference"``, ``qr_iteration_svd`` (8 iterations) and
   ``randomized_svd``, each one's reconstruction error beside the
   oracle's (full SVD) and its median of 5 CUDA-event times; the kernel
   route's singular values within 1e-4 of the reference route's; the
   fewest iterations (from r + 6, step 2, at most r + 20) at which the
   kernel route's error is within 2 % of the oracle's, and its time;
   the re-orth launches exactly k left and k - 1 right a run of k
   iterations; (b) ``launch.dryrun``'s shape-only record of phase 17
   (a)'s configuration on a (1, 1) mesh against phase 17 (a)'s run:
   parameter and AdamW state bytes within 1 % of ``memory_allocated``,
   the predicted peak beside the measured one (the gap printed, not
   gated), and a ``roofline:`` line (compute_s, memory_s, the measured
   step, model FLOPs over step time x 989 TFLOP/s).
22. MoE over the DP axis (``--only moe_dp``), at world 1 on one-rank
   NCCL groups: ``olmoe-1b-7b`` at full width, (a) its depth cut to 8
   (AdamW's float32 moments of all 16 layers do not fit beside the
   weights and gradients), two AdamW steps of 4 × 512 tokens with the
   batch split over a (1, 1) mesh's DP group in the reference's global
   form and in its per-shard form (``cfg.moe_shard_map``) against the
   same steps without a mesh: losses bit-equal, the MoE statistics'
   collectives issued, no port kernel launched, each step's peak GiB
   beside no mesh's; (b) at full depth, phase 4's traffic (32 new
   tokens) slot-sharded on the mesh in both forms, single-step and in
   fused blocks of 8: tokens equal to no mesh's.  The process group is
   destroyed at the end.

Each phase prints its seconds (``phase <name>: ... s``);
``--only a,b`` runs some phases for development and prints no result.
Phase 3 also holds the activation path's kernels (Eq. 6 GEMM, outlier
statistics in bf16, as phase 6 feeds them, and in float32, the B = 1
re-orth pair) against their plain versions at the shapes phase 6 gives
them (the Eq. 6 GEMM's reruns bit-identical, its times warm and L2-cold
beside ``torch.matmul``'s; the outlier rows warm, L2-cold and with an
L2 flushed by reading, ``ms_l2_cold_clean``), the paged
dkv kernel bit for bit against the slab kernel at phase 4's shapes, the
intra-chunk SSD kernel at phase 8's four prefill shapes and at phase
11's two (nh 64: G 8 × Q 64 and G 1 × Q 304; reruns bit-identical; warm
and L2-cold, beside the empty launch and the shape's launches per run),
phase 14's shapes (the re-orth pair at gemma-2b's [18, 512, 256] and
starcoder2-7b's [32, 512, 512], the dkv kernel at starcoder2-7b's G 36
over 1024 rows), and the four expanded matvec wrappers at
phase 9's shapes (f = 8, 512 rows or columns per CTA; reruns must be
bit-identical; times L2-flushed and warm beside the library call's),
and the SSD term's backward kernel (``ssd_chunk_intra_bwd``) against its
plain version at phase 17's training shape (G 32 × Q 64) and at phase
8's four (each of dcb, dl, ddt, dx within 1e-4 of its largest entry;
reruns bit-identical; warm and L2-cold; the heads a work item takes),
and both SSD kernels at one rank's heads on a "model" axis of 4 (nh 12
of mamba2-780m's 48, nh 16 of zamba2-1.2b's 64; G 32 × Q 64 and
G 1 × Q 304; ``model_axis`` 4 in the row).  Phase 5 also serves reduced
float32 ``mamba2-780m`` through the SSD kernel: staggered tokens equal each
request's solo tokens and the ``backend="reference"`` route's tokens.
The line before the last is
``{"kernels": [...]}``; the last line is ``{"ok": true, "device":
{...}}``.  Without CUDA, or without the package beside this script, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent


def rates():
    """``repro_torch.launch.roofline``, the one home of the H100 SXM's
    data-sheet rates (``HBM_BW``, ``PEAK_FLOPS`` by dtype); src/ is on
    the path by the time a phase runs."""
    from repro_torch.launch import roofline
    return roofline


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean CUDA-event time of ``iters`` back-to-back calls (operands
    warm in L2).  The device first spins for twice as long as the host
    takes to enqueue the calls, so the events time the device's work,
    not the host's launch overhead."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9 * min(1.0, 2 * host_s * iters + 1e-4)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms_cold(fn, iters: int = 20, clean: bool = False) -> float:
    """Median CUDA-event time of ``fn()`` with the 50 MB L2 flushed
    before each call (a 256 MiB buffer is overwritten), as on the main
    path, where other layers' work evicts the operands between calls.
    The overwrite leaves the L2 full of dirty lines, which ``fn`` must
    write back as it reads; ``clean`` flushes by reading the buffer
    instead, so only ``fn``'s own traffic is timed."""
    import torch
    flush = torch.zeros(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    fn()
    times = []
    for _ in range(iters):
        if clean:
            flush.sum()
        else:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def launch_floor_ms() -> float:
    """:func:`time_ms` of an empty one-warp kernel: the least a launch of
    any kernel takes under the same timer."""
    import ctypes
    import torch
    from repro_torch.kernels.build import library
    fn = library("launch_floor").dcom_empty_launch
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        if fn(1, stream):
            raise RuntimeError("empty kernel launch failed")
    return time_ms(run)


def to_float32(tree):
    """A float32 copy of a (nested dict) tree of tensors."""
    if isinstance(tree, dict):
        return {k: to_float32(v) for k, v in tree.items()}
    return tree.float()


def bound(bytes_: float, flops: float, dtype: str):
    t_bytes = bytes_ / rates().HBM_BW * 1e3
    t_ops = flops / rates().PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def reorth_case(side: str, b: int, s: int, h: int, k: int, filled: int,
                expansion: int, gen, scalar: bool = False):
    """Inputs of one Lanczos step: A [B,S,H] float32, a unit input vector,
    and a basis with ``filled`` orthonormal columns of ``k`` (the rest
    zero, as mid-iteration).  ``scalar`` times the B = 1 wrappers
    ``reorth_right``/``reorth_left`` (one A [S, H]) instead."""
    import torch
    from repro_torch.kernels import lanczos_reorth as lr
    dev = "cuda"
    a = torch.randn(b, s, h, generator=gen, device=dev)
    n, m = (h, s) if side == "right" else (s, h)
    x = torch.randn(b, m, generator=gen, device=dev)
    x = x / x.norm(dim=-1, keepdim=True)
    q = torch.zeros(b, n, k, device=dev)
    q[..., :filled] = torch.linalg.qr(
        torch.randn(b, n, filled, generator=gen, device=dev))[0]
    # CTAs per batch element and clusters resident at once (a checkout from
    # before the cluster kernel, as kernel_ab.py's base may be, runs one
    # CTA per element)
    cluster = getattr(lr, "cluster_ctas", lambda f: 1)
    resident = getattr(lr, "resident_clusters", lambda *a: None)
    batched = getattr(lr, f"reorth_{side}_batched")
    plain = getattr(lr, f"reorth_{side}_batched_plain")
    if scalar:
        one = getattr(lr, f"reorth_{side}")
        a, x, q = a[0], x[0], q[0]
        kern = lambda: one(a, x, q, expansion=expansion)
        ref = lambda: tuple(t[0] for t in plain(a[None], x[None], q[None]))
    else:
        kern = lambda: batched(a, x, q, expansion=expansion)
        ref = lambda: plain(a, x, q)
    z_k, n_k = kern()
    z_p, n_p = ref()
    torch.cuda.synchronize()
    err = (z_k - z_p).abs().max().item()
    tol = 1e-4 * z_p.abs().max().item()
    nerr = ((n_k - n_p).abs() / n_p.abs()).max().item()
    name = f"reorth_{side}" if scalar else f"reorth_{side}_batched"
    if not err <= tol or not nerr <= 1e-4:
        raise AssertionError(
            f"{name} B={b}: max abs err {err:.3e} > {tol:.3e}"
            f" or norm rel err {nerr:.3e} > 1e-4")
    ms, ms_cold = time_ms(kern), time_ms_cold(kern)
    plain_ms, plain_cold = time_ms(ref), time_ms_cold(ref)
    bytes_ = 4 * (b * s * h + b * m + b * n * k + b * n + b)
    flops = 2 * b * s * h + 8 * b * n * k + 2 * b * n
    bms, by = bound(bytes_, flops, "float32")
    line = {("right", False): 233, ("left", False): 274,
            ("right", True): 318, ("left", True): 358}[(side, scalar)]
    return dict(name=name, route="cuda",
                source="src/repro_torch/kernels/csrc/lanczos_reorth.cu",
                replaces=f"src/repro/kernels/lanczos_reorth.py:{line}",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None, ms_l2_cold=ms_cold,
                plain_ms_l2_cold=plain_cold, expansion=expansion,
                cluster=cluster(expansion),
                resident_clusters=resident(side, s, h, k, expansion),
                shape=dict(B=b, S=s, H=h, k=k, filled=filled,
                           expansion=expansion),
                tolerance="max|z_kernel - z_plain| <= 1e-4 max|z_plain|, "
                          "norm rel err <= 1e-4 (float32, reduction "
                          "order differs)")


LRMM_KNOBS = tuple((f, nb) for f in (1, 8, 16, 32) for nb in (128, 512))


def lowrank_matmul_knobs(vt, w) -> dict:
    """The bf16 GEMM at each (expansion, n_block) of :data:`LRMM_KNOBS`
    against its plain version at the same point (one bf16 ulp of the
    largest output), reruns bit-identical; {"f<f>/nb<nb>": [max abs err,
    warm ms]}."""
    import torch
    from repro_torch.kernels import lowrank_matmul as lm
    out = {}
    for f, nb in LRMM_KNOBS:
        run = lambda: lm.lowrank_matmul(vt, w, expansion=f,  # noqa: E731
                                        n_block=nb)
        got, again = run(), run()
        want = lm.lowrank_matmul_plain(vt, w, expansion=f, n_block=nb)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = 2 ** -7 * want.float().abs().max().item()
        if not (err <= tol and torch.equal(got, again)):
            raise AssertionError(f"lowrank_matmul f={f} n_block={nb}: err "
                                 f"{err:.3e} (tol {tol:.3e}) or reruns "
                                 f"differ")
        out[f"f{f}/nb{nb}"] = [err, time_ms(run)]
    return out


def lowrank_matmul_case(k: int, h: int, n: int, gen, knobs: bool = False):
    """Eq. 6 at the activation path's shapes: Vᵀ [1, k, H] @ W [H, N] in
    bf16 (the main path), then the float32 instantiation on the same
    values; ``knobs`` also holds the bf16 kernel at each operating point
    of :data:`LRMM_KNOBS` (``knobs`` field: error and warm ms)."""
    import torch
    from repro_torch.kernels import lowrank_matmul as lm
    dev = "cuda"
    vt = torch.randn(1, k, h, generator=gen, device=dev).bfloat16()
    w = (torch.randn(h, n, generator=gen, device=dev) * h ** -0.5).bfloat16()
    got = lm.lowrank_matmul(vt, w)
    want = lm.lowrank_matmul_plain(vt, w)
    again = lm.lowrank_matmul(vt, w)
    vt32, w32 = vt.float(), w.float()
    got32 = lm.lowrank_matmul(vt32, w32)
    want32 = lm.lowrank_matmul_plain(vt32, w32)
    again32 = lm.lowrank_matmul(vt32, w32)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = 2 ** -7 * want.float().abs().max().item()
    err32 = (got32 - want32).abs().max().item()
    tol32 = 1e-4 * want32.abs().max().item()
    if not (err <= tol and err32 <= tol32 and torch.equal(got, again)
            and torch.equal(got32, again32)):
        raise AssertionError(f"lowrank_matmul N={n}: bf16 err {err:.3e} "
                             f"(tol {tol:.3e}), float32 err {err32:.3e} "
                             f"(tol {tol32:.3e}), or reruns differ")
    del got32, want32, again32, vt32, w32
    vt2 = vt[0]
    # L2-cold times first (W fits in the 50 MB L2 at N = 4096), then
    # back-to-back times, as in every row
    cold_ms = time_ms_cold(lambda: lm.lowrank_matmul(vt, w))
    lib_cold_ms = time_ms_cold(lambda: torch.matmul(vt2, w))
    ms = time_ms(lambda: lm.lowrank_matmul(vt, w))
    plain_ms = time_ms(lambda: lm.lowrank_matmul_plain(vt, w))
    lib_ms = time_ms(lambda: torch.matmul(vt2, w))
    bytes_ = 2 * (k * h + h * n + k * n)
    bms, by = bound(bytes_, 2 * k * h * n, "bfloat16")
    extra = dict(knobs=lowrank_matmul_knobs(vt, w)) if knobs else {}
    return dict(name="lowrank_matmul", route="cuda",
                source="src/repro_torch/kernels/csrc/lowrank_matmul.cu",
                replaces="src/repro/kernels/lowrank_matmul.py:59",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms,
                shape=dict(vt=[1, k, h], w=[h, n], dtype="bfloat16"),
                ms_l2_cold=cold_ms, library_ms_l2_cold=lib_cold_ms,
                max_abs_err_float32=err32, **extra,
                tolerance="bf16: <= 2^-7 max|plain| (one bf16 ulp: both "
                          "round float32 sums once); float32: <= 1e-4 "
                          "max|plain| (sum order differs); reruns "
                          "bit-identical")


def outlier_stats_case(s: int, h: int, gen, threshold: float = 3.0,
                       dtype: str = "bfloat16"):
    """Outlier statistics of one prompt X [1, S, H] in ``dtype`` (phase 6
    hands the kernel the bf16 activation) with 8 planted outlier channels;
    both reductions are exact, so the kernel must equal the plain version
    bit for bit.  Times warm and with the L2 flushed before each call."""
    import torch
    from repro_torch.kernels import outlier_extract as oe
    dev = "cuda"
    x = torch.randn(1, s, h, generator=gen, device=dev)
    planted = torch.randperm(h, generator=gen, device=dev)[:8]
    x[..., planted] *= 4.0
    x = x.to(getattr(torch, dtype))
    cnt, mx = oe.outlier_stats(x, threshold)
    cp, mp = oe.outlier_stats_plain(x, threshold)
    torch.cuda.synchronize()
    err = max((cnt - cp).abs().max().item(), (mx - mp).abs().max().item())
    if err != 0.0 or not (cnt[0, planted] > 0).all():
        raise AssertionError(f"outlier_stats {dtype}: max abs err {err} "
                             f"(must be 0) or a planted channel counted "
                             f"nothing")
    cold_ms = time_ms_cold(lambda: oe.outlier_stats(x, threshold))
    clean_ms = time_ms_cold(lambda: oe.outlier_stats(x, threshold),
                            clean=True)
    ms = time_ms(lambda: oe.outlier_stats(x, threshold))
    plain_ms = time_ms(lambda: oe.outlier_stats_plain(x, threshold))
    bms, by = bound(x.element_size() * s * h + 2 * 4 * h, 3 * s * h,
                    "float32")
    return dict(name="outlier_stats", route="cuda",
                source="src/repro_torch/kernels/csrc/outlier_extract.cu",
                replaces="src/repro/kernels/outlier_extract.py:53",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None,
                shape=dict(x=[1, s, h], dtype=dtype, threshold=threshold,
                           planted_channels=8,
                           counted_channels=int((cnt > 0).sum().item())),
                ms_l2_cold=cold_ms, ms_l2_cold_clean=clean_ms,
                tolerance="exact (counts and maxima do not depend on the "
                          "order of reduction)")


def kernel_and_library_ms(kern, lib) -> dict:
    """The kernel's and the library call's times, warm (``ms``,
    ``library_ms``) and with the L2 flushed before each call."""
    return dict(ms=time_ms(kern), library_ms=time_ms(lib),
                ms_l2_cold=time_ms_cold(kern),
                library_ms_l2_cold=time_ms_cold(lib))


DKV_KNOBS = (1, 8, 32)


def dkv_case(b: int, g: int, t: int, r: int, t_valid, dtype, gen,
             knobs=()):
    """The slab dkv kernel against its plain version (reruns
    bit-identical), then at each expansion of ``knobs`` against the plain
    version at the same f (``knobs`` field: a error and warm ms)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import dkv_attention as dk
    dev = "cuda"
    inner = torch.randn(b, g, r, generator=gen, device=dev) * 0.5
    k_u = torch.randn(b, t, r, generator=gen, device=dev).to(dtype)
    v_u = torch.randn(b, t, r, generator=gen, device=dev).to(dtype)
    tv = torch.tensor(t_valid, dtype=torch.int32, device=dev)
    kern = lambda: dk.dkv_attention_stats(inner, k_u, v_u, tv)  # noqa: E731
    got = kern()
    again = kern()
    def check(got, again, f=None):
        a_k, m_k, l_k = got
        a_p, m_p, l_p = dk.dkv_attention_stats_plain(inner, k_u, v_u, tv,
                                                     expansion=f)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"dkv_attention_stats f={f}: reruns "
                                 f"differ")
        err = (a_k - a_p).abs().max().item()
        tol = 1e-4 * a_p.abs().max().item()
        merr = (m_k - m_p).abs().max().item()
        lerr = ((l_k - l_p).abs() / l_p.abs()).max().item()
        if not (err <= tol and merr <= 1e-4 * m_p.abs().max().item()
                and lerr <= 1e-4):
            raise AssertionError(f"dkv_attention_stats f={f}: a err "
                                 f"{err:.3e} (tol {tol:.3e}), m err "
                                 f"{merr:.3e}, l rel err {lerr:.3e}")
        return err

    err = check(got, again)
    knob_rows = {}
    for f in knobs:
        run = lambda: dk.dkv_attention_stats(  # noqa: E731
            inner, k_u, v_u, tv, expansion=f)
        knob_rows[f"f{f}"] = [check(run(), run(), f), time_ms(run)]
    extra = dict(knobs=knob_rows) if knobs else {}
    plain_ms = time_ms(lambda: dk.dkv_attention_stats_plain(inner, k_u,
                                                            v_u, tv))
    # yardstick: one SDPA call over the same prefix rows (normalized a/l)
    mask = (torch.arange(t, device=dev)[None, :] < tv[:, None])[:, None, :]
    q4, k4, v4 = inner.to(dtype)[:, None], k_u[:, None], v_u[:, None]
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, k4, v4, attn_mask=mask[:, None], scale=1.0)
    rows = sum(min(int(x), t) for x in t_valid)
    elt = k_u.element_size()
    bytes_ = 4 * b * g * r + 2 * rows * r * elt + 4 * b \
        + 4 * (b * g * r + 2 * b * g)
    flops = 4 * g * r * rows
    bms, by = bound(bytes_, flops, str(dtype).split(".")[-1])
    return dict(name="dkv_attention_stats", route="cuda",
                source="src/repro_torch/kernels/csrc/dkv_attention.cu",
                replaces="src/repro/kernels/dkv_attention.py:115",
                max_abs_err=err, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, **kernel_and_library_ms(kern, lib), **extra,
                shape=dict(B=b, G=g, T=t, r=r, t_valid=list(t_valid),
                           dtype=str(dtype)),
                tolerance="max|a_kernel - a_plain| <= 1e-4 max|a_plain|, "
                          "m abs err <= 1e-4 max|m|, l rel err <= 1e-4; "
                          "reruns bit-identical")


def dkv_paged_case(b: int, g: int, r: int, t_valid, page: int, dtype,
                   gen):
    """The paged dkv kernel at phase 4's shapes: one layer's pools, a
    shuffled block table of pages_for(t_valid) pages per slot (sink
    padding), checked BITWISE against the slab kernel on the gathered
    rows, then against the plain version; the slab kernel is timed at the
    same rows beside it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import dkv_attention as dk
    dev = "cuda"
    n = -(-max(t_valid) // page)
    npages = [-(-t // page) for t in t_valid]
    P = sum(npages) + 1
    k_pool = torch.randn(P, page, r, generator=gen, device=dev).to(dtype)
    v_pool = torch.randn(P, page, r, generator=gen, device=dev).to(dtype)
    k_pool[0] = 0
    v_pool[0] = 0
    ids = (torch.randperm(P - 1, generator=gen, device=dev) + 1).tolist()
    bt = torch.zeros(b, n, dtype=torch.int32)
    for i, k in enumerate(npages):
        bt[i, :k] = torch.tensor(ids[:k])
        ids = ids[k:]
    bt = bt.to(dev)
    inner = torch.randn(b, g, r, generator=gen, device=dev) * 0.5
    tv = torch.tensor(t_valid, dtype=torch.int32, device=dev)
    kern = lambda: dk.dkv_attention_stats_paged(inner, k_pool, v_pool, bt,
                                                tv, r)
    got = kern()
    again = kern()
    ku = dk.gather_rows(k_pool, bt, r).contiguous()
    vu = dk.gather_rows(v_pool, bt, r).contiguous()
    slab = dk.dkv_attention_stats(inner, ku, vu, tv)
    plain = dk.dkv_attention_stats_paged_plain(inner, k_pool, v_pool, bt,
                                               tv, r)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, slab)):
        raise AssertionError("dkv_attention_stats_paged is not bit-equal "
                             "to the slab kernel on the gathered rows")
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError("dkv_attention_stats_paged: reruns differ")
    (a_k, m_k, l_k), (a_p, m_p, l_p) = got, plain
    err = (a_k - a_p).abs().max().item()
    merr = (m_k - m_p).abs().max().item()
    lerr = ((l_k - l_p).abs() / l_p.abs()).max().item()
    if not (err <= 1e-4 * a_p.abs().max().item()
            and merr <= 1e-4 * m_p.abs().max().item() and lerr <= 1e-4):
        raise AssertionError(f"dkv_attention_stats_paged: a err {err:.3e},"
                             f" m err {merr:.3e}, l rel err {lerr:.3e}")
    slab_ms = time_ms(lambda: dk.dkv_attention_stats(inner, ku, vu, tv))
    plain_ms = time_ms(lambda: dk.dkv_attention_stats_paged_plain(
        inner, k_pool, v_pool, bt, tv, r))
    mask = (torch.arange(n * page, device=dev)[None, :]
            < tv[:, None])[:, None, None, :]
    q4, k4, v4 = inner.to(dtype)[:, None], ku[:, None], vu[:, None]
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, k4, v4, attn_mask=mask, scale=1.0)
    rows = sum(t_valid)
    elt = k_pool.element_size()
    bytes_ = 4 * b * g * r + 2 * rows * r * elt + 4 * b + 4 * b * n \
        + 4 * (b * g * r + 2 * b * g)
    bms, by = bound(bytes_, 4 * g * r * rows, str(dtype).split(".")[-1])
    return dict(name="dkv_attention_stats_paged", route="cuda",
                source="src/repro_torch/kernels/csrc/dkv_attention.cu",
                replaces="src/repro/kernels/dkv_attention.py:229",
                max_abs_err=err, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, **kernel_and_library_ms(kern, lib),
                slab_kernel_ms=slab_ms,
                shape=dict(B=b, G=g, r=r, page=page, table=[b, n],
                           t_valid=list(t_valid), dtype=str(dtype)),
                tolerance="bit-equal to dkv_attention_stats on the "
                          "gathered rows; vs plain as dkv_attention_stats; "
                          "reruns bit-identical")


def ssd_case(g: int, q: int, nh: int, hd: int, gen, per_run=None):
    """The intra-chunk SSD term at one of phase 8's prefill shapes: cb
    [G, Q, Q], a decreasing log-decay l, dt > 0 and x, all float32; reruns
    must be bit-identical.  Times warm and with the L2 flushed before each
    call (another layer's work runs between two calls on the main path).
    ``per_run``: the shape's launches in one run of phase 8."""
    import torch
    from repro_torch.kernels import ssd_chunk as sc
    dev = "cuda"
    cb = torch.randn(g, q, q, generator=gen, device=dev) * 0.3
    l = torch.cumsum(-torch.randn(g, q, nh, generator=gen,
                                  device=dev).abs() * 0.05, dim=1)
    dt = torch.randn(g, q, nh, generator=gen, device=dev).abs()
    x = torch.randn(g, q, nh, hd, generator=gen, device=dev)
    kern = lambda: sc.ssd_chunk_intra(cb, l, dt, x)  # noqa: E731
    got = kern()
    again = kern()
    want = sc.ssd_chunk_intra_plain(cb, l, dt, x)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = 1e-4 * want.abs().max().item()
    if not (torch.isfinite(got).all() and err <= tol
            and torch.equal(got, again)):
        raise AssertionError(f"ssd_chunk_intra G={g} Q={q}: max abs err "
                             f"{err:.3e} > {tol:.3e} or reruns differ")
    ms, ms_cold = time_ms(kern), time_ms_cold(kern)
    plain_ms = time_ms(lambda: sc.ssd_chunk_intra_plain(cb, l, dt, x))
    # each input read once, y written once; 2·hd FMA operations plus the
    # masked decay (subtract, exp, two products) per (q, s <= q, head)
    bytes_ = 4 * (g * q * q + 2 * g * q * nh + 2 * g * q * nh * hd)
    flops = nh * g * q * (q + 1) // 2 * (2 * hd + 4)
    bms, by = bound(bytes_, flops, "float32")
    plan = getattr(sc, "heads_for", None)   # absent in older checkouts
    return dict(name="ssd_chunk_intra", route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_chunk.cu",
                replaces="src/repro/kernels/ssd_chunk.py:70",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None, ms_l2_cold=ms_cold,
                shape=dict(G=g, Q=q, nh=nh, hd=hd),
                heads_per_item=plan(g, q, nh, hd, x.device) if plan else None,
                launches_per_run=per_run,
                tolerance="max|y_kernel - y_plain| <= 1e-4 max|y_plain| "
                          "(float32, sums in another order; "
                          "tests/test_kernels.py uses 1e-4); reruns "
                          "bit-identical")


def bwd_heads(sc, g: int, q: int, nh: int, hd: int) -> int:
    """Heads one work item of the backward kernel takes at this shape
    (a checkout before the plan: its heads per CTA)."""
    import torch
    if hasattr(sc, "bwd_plan"):
        return sc.bwd_plan(g, q, nh, sc.bwd_ctas(0, hd)).hb
    return sc.heads_per_cta(g, nh, torch.cuda.get_device_properties(0)
                            .multi_processor_count)


def ssd_bwd_case(g: int, q: int, nh: int, hd: int, gen, per_step=None):
    """The backward kernel of the intra-chunk SSD term against its plain
    version (``ssd_chunk_intra_bwd_plain``) at one shape: the forward's
    inputs as :func:`ssd_case` draws them and dy N(0, 1), float32; each
    of dcb, dl, ddt, dx within 1e-4 of its largest plain entry, reruns
    bit-identical.  Times warm and L2-cold.  ``per_step``: the shape's
    launches in one train step of phase 17's mamba2 leg."""
    import torch
    from repro_torch.kernels import ssd_chunk as sc
    dev = "cuda"
    cb = torch.randn(g, q, q, generator=gen, device=dev) * 0.3
    l = torch.cumsum(-torch.randn(g, q, nh, generator=gen,
                                  device=dev).abs() * 0.05, dim=1)
    dt = torch.randn(g, q, nh, generator=gen, device=dev).abs()
    x = torch.randn(g, q, nh, hd, generator=gen, device=dev)
    dy = torch.randn(g, q, nh, hd, generator=gen, device=dev)
    kern = lambda: sc.ssd_chunk_intra_bwd(cb, l, dt, x, dy)  # noqa: E731
    got, again = kern(), kern()
    want = sc.ssd_chunk_intra_bwd_plain(cb, l, dt, x, dy)
    torch.cuda.synchronize()
    errs = {}
    for name, a, b, c in zip(("dcb", "dl", "ddt", "dx"), got, want, again):
        err = (a - b).abs().max().item()
        tol = 1e-4 * b.abs().max().item()
        if not (torch.isfinite(a).all() and err <= tol and torch.equal(a, c)):
            raise AssertionError(f"ssd_chunk_intra_bwd G={g} Q={q} {name}: "
                                 f"max abs err {err:.3e} > {tol:.3e} or "
                                 f"reruns differ")
        errs[name] = err
    ms, ms_cold = time_ms(kern), time_ms_cold(kern)
    plain_ms = time_ms(lambda: sc.ssd_chunk_intra_bwd_plain(cb, l, dt, x,
                                                            dy))
    # inputs cb, l, dt, x, dy read once; dcb, dl, ddt, dx written once;
    # per (q, s <= q, head): the G dot and the dx update (2·hd FMA
    # operations each) and ~12 for the masked terms
    bytes_ = 4 * (2 * g * q * q + 4 * g * q * nh + 3 * g * q * nh * hd)
    flops = nh * g * q * (q + 1) // 2 * (4 * hd + 12)
    bms, by = bound(bytes_, flops, "float32")
    return dict(name="ssd_chunk_intra_bwd", route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu",
                replaces="src/repro/kernels/ssd_chunk.py:70",
                max_abs_err=max(errs.values()), max_abs_err_by_output=errs,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=None, ms_l2_cold=ms_cold,
                shape=dict(G=g, Q=q, nh=nh, hd=hd),
                heads_per_item=bwd_heads(sc, g, q, nh, hd),
                launches_per_step=per_step,
                tolerance="max|grad_kernel - grad_plain| <= 1e-4 "
                          "max|grad_plain| for each of dcb, dl, ddt, dx "
                          "(float32 sums in another order); reruns "
                          "bit-identical")


SSD_SHAPES = ((8, 64), (6, 64), (2, 64), (1, 304))   # phase 8's (G, Q)
SSD_TRAIN_SHAPE = (32, 64)         # phase 17: batch 4 x 512 tokens
HYBRID_SSD_SHAPES = ((8, 64), (1, 304))              # phase 11's, nh 64
# one rank's heads on a "model" axis of 4 (tensor parallelism): the
# training shape and the 300-token prompt's chunk, forward and backward
TP_RANKS = 4
TP_SSD_SHAPES = ((32, 64), (1, 304))

MATVEC_LINES = {"matvec": 65, "rmatvec": 174, "matvec_batched": 122,
                "rmatvec_batched": 148}   # src/repro/kernels/matvec_expand.py


def matvec_case(name: str, shape, dtype, gen):
    """One of the four expanded matvec wrappers at the default f = 8 and
    512 rows (columns) per CTA against its plain version: A ``shape`` in
    ``dtype``, the vector in ``dtype``; reruns must be bit-identical.  A
    2-D (scalar) shape is timed with the L2 flushed before each call; the
    yardstick is one PyTorch call (``torch.mv`` / ``torch.bmm``)."""
    import torch
    from repro_torch.kernels import matvec_expand as mv
    dev = "cuda"
    a = torch.randn(*shape, generator=gen, device=dev).to(dtype)
    n_vec = shape[-1] if name.startswith("matvec") else shape[-2]
    x = torch.randn(*shape[:-2], n_vec, generator=gen, device=dev).to(dtype)
    key = "row_block" if name.startswith("matvec") else "col_block"
    kw = {"expansion": 8, key: 512}
    kern = lambda: getattr(mv, name)(a, x, **kw)  # noqa: E731
    plain = lambda: getattr(mv, f"{name}_plain")(a, x, **kw)  # noqa: E731
    lib = {"matvec": lambda: torch.mv(a, x),
           "rmatvec": lambda: torch.mv(a.T, x),
           "matvec_batched": lambda: torch.bmm(a, x[..., None]),
           "rmatvec_batched": lambda: torch.bmm(x[:, None], a)}[name]
    got, want = kern(), plain()
    again = kern()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = 1e-4 * want.abs().max().item()
    if not (torch.isfinite(got).all() and err <= tol
            and torch.equal(got, again)):
        raise AssertionError(f"{name} {list(shape)} {dtype}: max abs err "
                             f"{err:.3e} > {tol:.3e} or reruns differ")
    # the scalar shape as a Lanczos step finds it (L2 flushed), the
    # batched one back to back (2 GiB of A passes the 50 MB L2 anyway);
    # each also at the other setting, kernel and library call
    timer, other = (time_ms_cold, time_ms) if len(shape) == 2 \
        else (time_ms, time_ms_cold)
    ms, plain_ms, lib_ms = timer(kern), timer(plain), timer(lib)
    ms_o, lib_ms_o = other(kern), other(lib)
    extra = dict(ms_warm=ms_o, library_ms_warm=lib_ms_o) \
        if len(shape) == 2 else dict(ms_l2_cold=ms_o,
                                     library_ms_l2_cold=lib_ms_o)
    bytes_ = a.numel() * a.element_size() + x.numel() * x.element_size() \
        + got.numel() * 4
    bms, by = bound(bytes_, 2 * a.numel(), str(dtype).split(".")[-1])
    return dict(name=name, route="cuda",
                source="src/repro_torch/kernels/csrc/matvec_expand.cu",
                replaces=f"src/repro/kernels/matvec_expand.py:"
                         f"{MATVEC_LINES[name]}",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms,
                shape=dict(a=list(shape), dtype=str(dtype), **kw,
                           l2_flushed=len(shape) == 2), **extra,
                tolerance="max|y_kernel - y_plain| <= 1e-4 max|y_plain| "
                          "(float32 sums in another order); reruns "
                          "bit-identical")


def phase_kernels(cfg):
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.engine import EngineConfig
    expansion = EngineConfig().expansion
    gen = torch.Generator(device="cuda").manual_seed(0)
    kvw, rank = cfg.kv_width, 64
    iters = rank + 8              # decompose_kv: rank + kv_iters_extra
    floor = launch_floor_ms()     # beside the rows whose bound is below it
    print(f"launch floor: an empty kernel takes {floor:.5f} ms under the "
          f"warm timer", flush=True)
    rows = []
    for b in (cfg.num_layers, 4 * cfg.num_layers):      # 1 and 4 prompts
        for side in ("right", "left"):
            rec = dict(reorth_case(side, b, 512, kvw, iters, iters // 2,
                                   expansion, gen), launch_floor_ms=floor)
            print(json.dumps(rec), flush=True)
            rows.append(rec)
        torch.cuda.empty_cache()
    dkv = dkv_case(4, cfg.num_heads, 512, rank, (512, 384, 304, 128),
                   torch.bfloat16, gen, knobs=DKV_KNOBS)
    dkv["launch_floor_ms"] = floor
    print(json.dumps(dkv), flush=True)
    rows.append(dkv)
    paged = dkv_paged_case(4, cfg.num_heads, rank, (512, 384, 304, 128),
                           16, torch.bfloat16, gen)
    paged["launch_floor_ms"] = floor
    print(json.dumps(paged), flush=True)
    rows.append(paged)
    # the activation path (phase 6): one 4096-token prompt, rank 20
    h, seq, r = cfg.d_model, 4096, 20
    act = [lowrank_matmul_case(r, h, cfg.num_heads * cfg.resolved_head_dim,
                               gen, knobs=True),
           lowrank_matmul_case(r, h, cfg.d_ff, gen),
           outlier_stats_case(seq, h, gen, dtype="bfloat16"),
           outlier_stats_case(seq, h, gen, dtype="float32")]
    for side in ("right", "left"):
        act.append(dict(reorth_case(side, 1, seq, h, r, r // 2, expansion,
                                    gen, scalar=True), launch_floor_ms=floor))
        torch.cuda.empty_cache()
    for rec in act:
        print(json.dumps(rec), flush=True)
    # Mamba2 prefill (phase 8): the 512-, 384- and 128-token prompts in 8,
    # 6 and 2 chunks of 64, and the 300-token prompt bucketed to one chunk
    # of 304; each shape launches once per layer of a run
    m2 = get_arch(MAMBA_ARCH)
    ssd_rows = [dict(ssd_case(g, q, m2.ssm_heads, m2.ssm_head_dim, gen,
                              per_run=m2.num_layers), launch_floor_ms=floor)
                for g, q in SSD_SHAPES]
    # zamba2's prefill (phase 11): nh 64, d_state 64; the 512-token
    # prompt in 8 chunks of 64 and the 300-token one as one chunk of 304,
    # each launched once per Mamba2 block of a prefill
    zb = get_arch(HYBRID_ARCH)
    n_mamba = zb.num_layers - zb.num_layers // zb.attn_period
    ssd_rows += [dict(ssd_case(g, q, zb.ssm_heads, zb.ssm_head_dim, gen,
                               per_run=n_mamba), launch_floor_ms=floor,
                      arch=HYBRID_ARCH)
                 for g, q in HYBRID_SSD_SHAPES]
    # its backward (phase 17's mamba2 leg: 4 prompts of 512 tokens, G 32
    # chunks of Q 64, once per layer of a train step; the training shape
    # first, as the kernels line takes a name's first row), then at phase
    # 8's prefill shapes
    ssd_rows += [dict(ssd_bwd_case(g, q, m2.ssm_heads, m2.ssm_head_dim, gen,
                                   per_step=m2.num_layers if (g, q) ==
                                   SSD_TRAIN_SHAPE else None),
                      launch_floor_ms=floor)
                 for g, q in (SSD_TRAIN_SHAPE,) + SSD_SHAPES]
    # one rank's block of heads at M = 4 (mamba2-780m: 12 of 48;
    # zamba2-1.2b: 16 of 64), which phase 19 and the four-card test run
    for arch, c in ((MAMBA_ARCH, m2), (HYBRID_ARCH, zb)):
        nh = c.ssm_heads // TP_RANKS
        for case in (ssd_case, ssd_bwd_case):
            ssd_rows += [dict(case(g, q, nh, c.ssm_head_dim, gen),
                              launch_floor_ms=floor, arch=arch,
                              model_axis=TP_RANKS)
                         for g, q in TP_SSD_SHAPES]
    for rec in ssd_rows:
        print(json.dumps(rec), flush=True)
    # the expanded matvec pair (phase 9's Fig. 12 operating points): A
    # [4096, 4096] float32 and the paper's batch 64, S = H = 4096 in bf16
    mv_rows = []
    for shape, dt in ((FIG12_SCALAR, torch.float32),
                      (FIG12_BATCHED, torch.bfloat16)):
        for op in ("matvec", "rmatvec"):
            name = op if len(shape) == 2 else f"{op}_batched"
            mv_rows.append(dict(matvec_case(name, shape, dt, gen),
                                launch_floor_ms=floor))
            print(json.dumps(mv_rows[-1]), flush=True)
        torch.cuda.empty_cache()
    # the dense variants' decomposed-KV shapes (phase 14): one 512-token
    # prompt's K or V of gemma-2b (kv_width 256) and starcoder2-7b (512)
    # through the re-orth pair, and starcoder2-7b's 36 query heads (four
    # groups of 8 and one of 4) over 1024 rows through the dkv kernel
    var_rows = []
    for arch in ("gemma-2b", "starcoder2-7b"):
        vc = get_arch(arch)
        for side in ("right", "left"):
            var_rows.append(dict(reorth_case(side, vc.num_layers, 512,
                                             vc.kv_width, iters, iters // 2,
                                             expansion, gen),
                                 launch_floor_ms=floor, arch=arch))
        torch.cuda.empty_cache()
    sc = get_arch("starcoder2-7b")
    var_rows.append(dict(dkv_case(4, sc.num_heads, 1024, rank,
                                  (1024, 700, 513, 128), torch.bfloat16,
                                  gen), launch_floor_ms=floor,
                         arch="starcoder2-7b"))
    for rec in var_rows:
        print(json.dumps(rec), flush=True)
    return rows + act + ssd_rows + mv_rows + var_rows


# ---------------------------------------------------------------------------
# Phase 4: serving llama2-7b at full width
# ---------------------------------------------------------------------------

#: the device functions of src/repro_torch/kernels/csrc/*.cu, and the
#: second backward kernel of checkouts before the SSD backward's redesign
#: (a profile of such a checkout counts it)
PORT_KERNELS = ("reorth_right_kernel", "reorth_left_kernel",
                "dkv_stats_kernel", "lrmm_kernel", "outlier_stats_kernel",
                "ssd_chunk_intra_kernel", "ssd_chunk_intra_bwd_kernel",
                "ssd_dcb_reduce_kernel", "matvec_kernel", "rmatvec_kernel")


def print_profile(prof) -> None:
    """The device's busy share of a profiled serving run and its kernel
    and operator time table, on standard output."""
    events = [e for e in prof.events()
              if e.device_type.name == "CUDA" and e.time_range.end > 0]
    if events:
        busy = sum(e.time_range.end - e.time_range.start for e in events)
        span = max(e.time_range.end for e in events) - min(
            e.time_range.start for e in events)
        print(f"profile: {len(events)} device kernels, summed device time "
              f"{busy / 1e3:.1f} ms over a {span / 1e3:.1f} ms span "
              f"(busy share {busy / max(span, 1):.3f})", flush=True)
        # the port's own kernels, each with its share of the device time,
        # whether or not the table below shows them
        own: dict = {}
        for e in events:
            m = re.search(r"\(anonymous namespace\)::(\w+)", e.name)
            if m and m.group(1) in PORT_KERNELS:
                n, us = own.get(m.group(1), (0, 0.0))
                own[m.group(1)] = (n + 1, us + e.time_range.end
                                   - e.time_range.start)
        for name, (n, us) in sorted(own.items()):
            print(f"profile: kernel {name}: {n} launches, {us / 1e3:.1f} ms "
                  f"({us / n:.1f} us each), {100 * us / busy:.2f} % of the "
                  f"device time", flush=True)
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=25), flush=True)


@contextlib.contextmanager
def profiled(enabled: bool, title: str):
    """Profile the enclosed work (CPU and CUDA activities, ending in a
    synchronize) when ``enabled``, then print ``title`` and the profile."""
    if not enabled:
        yield
        return
    import torch
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        yield
        torch.cuda.synchronize()
    print(title, flush=True)
    print_profile(prof)


SERVE_KERNELS = ("reorth_right_batched", "reorth_left_batched",
                 "dkv_attention_stats")
SERVE_LENS = (512, 384, 300, 128)           # phase 4's prompt lengths
SERVE_ARRIVALS = {0: [0, 1], 3: [2], 6: [3]}   # two arrive mid-decode


def drive(eng, prompts, arrivals, max_new: int, itl=None):
    """Submit ``prompts[i]`` for each i of ``arrivals[r]`` once the engine
    has run r decode rounds (a single-step engine runs one round a step),
    and step until every one of them finished.  A fused engine's blocks
    are cut at each arrival round (``decode_block`` lowered for that
    block), so it admits every request at the round a single-step engine
    does and the two give the same tokens.  ``itl`` (a dict of two
    lists), when given, collects the inter-token latencies of the streams
    already live in each step: under ``"admission"`` those of steps that
    dispatched or spliced a prefill, under ``"other"`` the rest."""
    from repro_torch.serving import Request
    n = sum(len(v) for v in arrivals.values())
    block, rounds = eng.decode_block, sorted(arrivals)
    done = []
    for _ in range(2000):
        while rounds and rounds[0] <= eng._round:
            for i in arrivals[rounds.pop(0)]:
                eng.submit(Request(uid=i, prompt=prompts[i],
                                   max_new_tokens=max_new))
        eng.decode_block = min(block, rounds[0] - eng._round) if rounds \
            else block
        st = eng.stats
        mark = (st.prefills, len(st.ttft_s), len(st.itl_s))
        done.extend(eng.step())
        if itl is not None:
            adm = (st.prefills, len(st.ttft_s)) != mark[:2]
            # the step's latencies: the newest of the recent window
            recent = list(st.itl_s)
            itl["admission" if adm else "other"].extend(
                recent[len(recent) - (len(st.itl_s) - mark[2]):])
        if len(done) == n and not eng._occupied():
            break
    return done


def init_weights(cfg):
    """Random bf16 weights of the full model from seed 0, on the card."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.api import model_fns
    gen = torch.Generator(device="cuda").manual_seed(0)
    before = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    params = model_fns(cfg).init(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    gib = T.param_bytes(params) / 2 ** 30
    print(f"init: {cfg.name} {cfg.num_layers} layers, {gib:.2f} GiB "
          f"{cfg.dtype} weights drawn in {time.perf_counter() - t0:.1f}s "
          f"({before:.2f} GiB of device memory in use before)", flush=True)
    return params


def serve_traffic(engine, prompts, profile: bool, title: str):
    """Warm up a throwaway ``engine()`` (library handles and allocator:
    one 64-token request, 20 new tokens), then drive phase 4's traffic
    (32 new tokens each) through a fresh one with every launch count at
    0, profiled when asked.  Returns (engine, finished requests, launch
    counts, peak device memory in GiB)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import Request
    warm = engine()
    warm.submit(Request(uid=-1, prompt=prompts[3][:64], max_new_tokens=20))
    warm.run()
    del warm
    torch.cuda.synchronize()
    eng = engine()
    torch.cuda.reset_peak_memory_stats()
    with profiled(profile, title):
        ops.reset_launch_counts()
        done = drive(eng, prompts, SERVE_ARRIVALS, 32)
        torch.cuda.synchronize()
    return eng, done, ops.launch_counts(), \
        torch.cuda.max_memory_allocated() / 2 ** 30


def check_finished(done, vocab: int, what: str, n: int = 32) -> None:
    """Requests 0-3 finished with ``n`` tokens each, all in the vocab."""
    if sorted(r.uid for r in done) != [0, 1, 2, 3] or any(
            len(r.out_tokens) != n or not all(0 <= t < vocab
                                              for t in r.out_tokens)
            for r in done):
        raise AssertionError(f"{what}: unfinished or bad requests "
                             f"{ {r.uid: r.out_tokens for r in done} }")


# ---------------------------------------------------------------------------
# Fused decode blocks (phases 4, 7a and 8): the same traffic at
# decode_block = FUSED_BLOCK, every block a replayed CUDA graph
# ---------------------------------------------------------------------------

FUSED_BLOCK = 8                       # the decode_block space's default
LONG_NEW = 128                        # new tokens of the long pair


def serve_once(engine, prompts, max_new: int, profile: bool = False,
               title: str = "", eos_id=None):
    """Phase 4's traffic (``max_new`` new tokens each) through a fresh
    ``engine()`` with every launch count at 0, profiled when asked.
    Returns (engine, {uid: tokens}, launch counts, peak GiB)."""
    import torch
    from repro_torch.kernels import ops
    eng = engine()
    eng.eos_id = eos_id
    torch.cuda.reset_peak_memory_stats()
    with profiled(profile, title):
        ops.reset_launch_counts()
        done = drive(eng, prompts, SERVE_ARRIVALS, max_new)
        torch.cuda.synchronize()
    if eos_id is None:
        check_finished(done, eng.cfg.vocab, title, max_new)
    return eng, {r.uid: r.out_tokens for r in done}, ops.launch_counts(), \
        torch.cuda.max_memory_allocated() / 2 ** 30


def decode_rates(st, graphs=None) -> str:
    """decode tok/s of a run and, for a fused run, without the host time
    its warm-up and captures took (they run inside decode rounds)."""
    out = f"{st.decode_tok_s:.2f}"
    if graphs is not None and graphs.capture_s:
        out += (f" ({st.tokens_out / (st.decode_s - graphs.capture_s):.2f}"
                f" without {graphs.capture_s:.2f} s of capture)")
    return out


def check_fused(what: str, eng, tokens, launches, single_tokens,
                single_launches=None) -> None:
    """A fused run: its tokens are the single-step run's, every block
    replayed a graph (none decoded eagerly), and, given the single-step
    run's launch counts, its replays' kernel launches (without the
    warm-up's) equal them."""
    if tokens != single_tokens:
        raise AssertionError(f"{what}: fused tokens {tokens} != single-step "
                             f"tokens {single_tokens}")
    g, st = eng.graphs, eng.stats
    if g.eager or g.replays != st.blocks or not g.replays:
        raise AssertionError(f"{what}: {g.eager} blocks decoded eagerly, "
                             f"{g.replays} replays for {st.blocks} blocks")
    if single_launches is not None:
        got = {k: v - g.warmup_launches.get(k, 0)
               for k, v in launches.items()}
        if got != single_launches:
            raise AssertionError(f"{what}: fused launches {got} (warm-up "
                                 f"{g.warmup_launches}) != single-step "
                                 f"{single_launches}")


def fused_line(what: str, max_new: int, st, fused, peak) -> None:
    """One line comparing a single-step run (its stats ``st``) with its
    fused twin (engine ``fused``)."""
    fs, g = fused.stats, fused.graphs
    print(f"{what}: {max_new} new tokens, decode_block={fused.decode_block}"
          f" tokens equal to single-step; decode_tok/s fused "
          f"{decode_rates(fs, g)} vs single-step {decode_rates(st)}; "
          f"decode_s {fs.decode_s:.4f} vs {st.decode_s:.4f}; blocks "
          f"{fs.blocks} for {fs.decode_steps} steps (single-step "
          f"{st.blocks}); graph captures={g.captures} replays={g.replays} "
          f"warm-up launches {json.dumps(g.warmup_launches)}; capture_s="
          f"{g.capture_s:.3f}; folds {fs.tail_folds}/{st.tail_folds}; "
          f"fused peak_mem_gib={peak:.2f}", flush=True)


def fused_pairs(what: str, engine, prompts, single, tokens, launches,
                profile: bool, long_ref=None):
    """The fused twin of a finished 32-token single-step run (its stats
    ``single``, ``tokens`` and ``launches``), then the pair at LONG_NEW
    tokens
    (single-step, then fused; the single-step tokens are also held
    against ``long_ref`` where given).  Returns the long run's
    single-step tokens."""
    fused, ftok, flaunch, peak = serve_once(
        lambda: engine(FUSED_BLOCK), prompts, 32, profile,
        f"{what}: profile of the fused serving run "
        f"(decode_block={FUSED_BLOCK})")
    check_fused(what, fused, ftok, flaunch, tokens, launches)
    fused_line(f"{what} fused", 32, single, fused, peak)
    del fused
    long1, ltok, llaunch, _ = serve_once(lambda: engine(1), prompts,
                                         LONG_NEW)
    if long_ref is not None and ltok != long_ref:
        raise AssertionError(f"{what}: {LONG_NEW}-token tokens differ from "
                             f"phase 4's")
    longf, ftok, flaunch, peak = serve_once(lambda: engine(FUSED_BLOCK),
                                            prompts, LONG_NEW)
    check_fused(f"{what} {LONG_NEW}", longf, ftok, flaunch, ltok, llaunch)
    if longf.graphs.replays <= longf.graphs.captures:
        raise AssertionError(f"{what}: {longf.graphs.replays} replays for "
                             f"{longf.graphs.captures} captures")
    fused_line(f"{what} fused", LONG_NEW, long1.stats, longf, peak)
    return ltok


def serve_llama(cfg, params, profile: bool = False):
    import numpy as np
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.serving import Engine

    ecfg = EngineConfig(kv_rank=64, kv_tail=16)

    def engine(decode_block: int = 1):
        return Engine(cfg, params, slots=4, max_len=1024,
                      decompose_engine=DecomposeEngine(ecfg), device="cuda",
                      decode_block=decode_block)

    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, n, dtype=np.int32)
               for n in SERVE_LENS]
    eng, done, launches, peak = serve_traffic(
        engine, prompts, profile, "serve: profile of the serving run")
    st = eng.stats
    check_finished(done, cfg.vocab, "serve")
    if st.tail_folds <= 0:
        raise AssertionError("no tail fold happened")
    if st.prefill_batches < 3:
        raise AssertionError("staggered requests were not admitted apart")
    missing = [k for k in SERVE_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing} ({launches})")
    print(f"serve: tokens={st.tokens_out} decode_steps={st.decode_steps} "
          f"folds={st.tail_folds} prefill_batches={st.prefill_batches} "
          f"prefill_s={st.prefill_s:.4f} decode_s={st.decode_s:.4f} "
          f"decode_tok/s={st.decode_tok_s:.2f} "
          f"mean_ttft_ms={st.mean_ttft_s * 1e3:.2f} "
          f"mean_itl_ms={st.mean_itl_s * 1e3:.2f} peak_mem_gib={peak:.2f}",
          flush=True)
    print("serve: launches " + json.dumps(launches), flush=True)
    tokens = {r.uid: r.out_tokens for r in done}

    long_tokens = fused_pairs("serve", engine, prompts, st, tokens,
                              launches, profile)
    # a stop token: request 0's 16th single-step token ends every request
    # that emits it, at the same round single-step and fused
    eos = tokens[0][15]
    e1, t1, _, _ = serve_once(engine, prompts, 32, eos_id=eos)
    ef, tf, _, _ = serve_once(lambda: engine(FUSED_BLOCK), prompts, 32,
                              eos_id=eos)
    check_fused("serve eos", ef, tf, {}, t1)
    if not 1 <= ef.stats.stopped_eos == e1.stats.stopped_eos:
        raise AssertionError(f"serve eos: stopped_eos fused "
                             f"{ef.stats.stopped_eos} vs single-step "
                             f"{e1.stats.stopped_eos}")
    print(f"serve eos: eos_id={eos} (request 0's 16th token): tokens equal, "
          f"stopped_eos {ef.stats.stopped_eos} = {e1.stats.stopped_eos}, "
          f"stopped_budget {ef.stats.stopped_budget} = "
          f"{e1.stats.stopped_budget}, decode steps {ef.stats.decode_steps} "
          f"in {ef.stats.blocks} blocks", flush=True)
    del e1, ef
    measure_dispatch(engine, prompts)

    check_decode_routes(cfg, params, prompts, ecfg)
    return launches, tokens, long_tokens


def measure_dispatch(engine, prompts) -> None:
    """Host dispatch of one decode step: the same step (4 admitted slots)
    eager, sampled and read back, against one replay of its captured
    1-step graph, read back (median of 7 each; the cost model's
    ``H100_HOST_DISPATCH_S`` is their difference)."""
    import torch
    from repro_torch.serving import Request
    eng = engine(FUSED_BLOCK)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=32))
    eng._admit()
    tok, stops = eng._last_tokens(), eng._stop_table()
    tok_dev = torch.from_numpy(tok).long().to(eng.device)

    def eager():
        eng._sample_host(eng.family.decode(tok_dev))

    def replay():
        eng.family.decode_block(tok, 1, stops)

    def median_s(fn):
        fn()
        ts = []
        for _ in range(7):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    e, r = median_s(eager), median_s(replay)
    print(f"dispatch: one eager decode step {e * 1e3:.3f} ms, one replay of "
          f"its captured graph {r * 1e3:.3f} ms (4 slots, both read back); "
          f"host dispatch per step {(e - r) * 1e3:.3f} ms", flush=True)


def check_decode_routes(cfg, params, prompts, ecfg, tag: str = "serve"):
    """One decode step through the kernel route vs the plain oracle route
    (``_lowrank_attention``, what ``backend="reference"`` decodes with)
    on a full-width prefilled cache (2 prompts of 300 tokens, 14 of them
    already in the dense tail)."""
    import numpy as np
    import torch
    from repro_torch.engine import DecomposeEngine
    from repro_torch.models import decomposed_kv as DK
    toks = torch.from_numpy(np.stack([prompts[0][:286],
                                      prompts[1][:286]])).long().cuda()
    _, cache = DK.prefill_dkv(params, cfg, toks, 64, tail=16,
                              engine=DecomposeEngine(ecfg))
    frozen = torch.tensor([286, 200], dtype=torch.int32, device="cuda")
    pos = torch.tensor([300, 300], dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for key in ("k", "v"):
        cache["tail"][key].normal_(generator=gen)
    # (a) every layer's attention output, main-path bf16 cache
    q = torch.randn(2, 1, cfg.num_heads, cfg.resolved_head_dim,
                    generator=gen, device="cuda").bfloat16()
    worst = 0.0
    for i in range(cfg.num_layers):
        c = {k: cache[k][i] for k in ("k_u", "k_vt", "v_u", "v_vt")}
        tail = {k: cache["tail"][k][i] for k in ("k", "v")}
        o_k = DK._factored_attention(q, c, tail, pos, frozen, cfg)
        o_p = DK._lowrank_attention(q, c, tail, pos, frozen, cfg)
        worst = max(worst, ((o_k - o_p).norm() / o_p.norm()).item())
    if not worst <= 1e-4:
        raise AssertionError(f"attention routes differ: rel err {worst:.3e}")
    # (b) logits of one decode step, float32 weights and cache (so the
    # comparison sees the routes' float32 roundoff, not bf16 rounding
    # amplified through the layers)
    p32, c32 = to_float32(params), to_float32(cache)
    cfg32 = cfg.replace(dtype="float32")
    tok = torch.tensor([7, 11], device="cuda")
    lg_k, _ = DK.decode_step_dkv(p32, cfg32, tok, c32, pos, frozen)
    lg_p, _ = DK.decode_step_dkv(p32, cfg32, tok, c32, pos, frozen,
                                 attention="plain")
    del p32, c32
    lg_k, lg_p = lg_k[:, :cfg.vocab], lg_p[:, :cfg.vocab]
    rel = ((lg_k - lg_p).norm() / lg_p.norm()).item()
    if not (torch.isfinite(lg_k).all() and rel <= 1e-3):
        raise AssertionError(f"decode logits, kernel vs plain route: "
                             f"relative L2 error {rel:.3e} > 1e-3")
    print(f"{tag}: kernel vs plain decode route: attention rel err "
          f"{worst:.3e} over {cfg.num_layers} bf16 layers (tol 1e-4); "
          f"float32 logits rel L2 err {rel:.3e} (tol 1e-3), argmax equal "
          f"{bool((lg_k.argmax(-1) == lg_p.argmax(-1)).all())}", flush=True)


# ---------------------------------------------------------------------------
# Phase 5: dkv == dense greedy tokens on a small input
# ---------------------------------------------------------------------------

def conformance(cfg):
    import numpy as np
    import torch
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving import Engine, Request
    small = cfg.reduced().replace(dtype="float32")
    params = T.init(small, torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, small.vocab, n, dtype=np.int32)
               for n in (12, 7, 15)]

    def serve(**kw):
        eng = Engine(small, params, slots=2, max_len=64, device="cuda", **kw)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=12))
        return {r.uid: r.out_tokens for r in eng.run()}, eng.stats

    before = ops.launch_counts()["dkv_attention_stats"]
    dense, _ = serve()
    dkv, st = serve(decompose_engine=DecomposeEngine(EngineConfig(
        kv_rank=64, kv_tail=4, kv_exact=True)))
    if st.tail_folds <= 0 or \
            ops.launch_counts()["dkv_attention_stats"] <= before:
        raise AssertionError("conformance run did not fold or launch")
    if dkv != dense:
        raise AssertionError(f"dkv tokens {dkv} != dense tokens {dense}")
    print(f"conformance: dkv (exact, full rank) == dense greedy tokens on "
          f"{small.name} float32, {len(dense)} requests, "
          f"{st.tail_folds} folds", flush=True)


def conformance_mamba2():
    """Reduced float32 mamba2-780m through the SSD kernel: staggered
    arrivals (one every 3 steps, slots 4, max_len 96, 12 new tokens) give
    each request's solo tokens and the ``backend="reference"`` route's
    tokens; the kernel launches once per layer per prefill."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.kernels import ops
    from repro_torch.models import mamba2 as M
    from repro_torch.serving import Engine
    small = get_arch(MAMBA_ARCH).reduced().replace(dtype="float32")
    params = M.init(small, torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, small.vocab, n, dtype=np.int32)
               for n in (7, 12, 19, 5, 70)]

    def serve(slots, uids, backend="cuda"):
        eng = Engine(small, params, slots=slots, max_len=96, device="cuda",
                     decompose_engine=DecomposeEngine(EngineConfig(
                         backend=backend)))
        ops.reset_launch_counts()
        done = drive(eng, prompts, {3 * k: [u] for k, u in enumerate(uids)},
                     12)
        torch.cuda.synchronize()
        return {r.uid: r.out_tokens for r in done}, eng.stats, \
            ops.launch_counts()

    uids = list(range(len(prompts)))
    got, st, counts = serve(4, uids)
    solo = {u: serve(1, [u])[0][u] for u in uids}
    ref, _, ref_counts = serve(4, uids, "reference")
    if counts["ssd_chunk_intra"] != small.num_layers * st.prefill_batches \
            or any(v for k, v in counts.items() if k != "ssd_chunk_intra") \
            or any(ref_counts.values()) or st.prefill_batches < 2:
        raise AssertionError(f"mamba2 conformance launches {counts} "
                             f"(reference {ref_counts}), "
                             f"{st.prefill_batches} prefills")
    if got != solo or got != ref:
        raise AssertionError(f"mamba2 staggered tokens {got} != solo {solo}"
                             f" or != reference route {ref}")
    print(f"conformance: {small.name} float32 staggered == solo == "
          f"reference-route greedy tokens, {len(got)} requests, "
          f"{st.prefill_batches} prefills, {counts['ssd_chunk_intra']} SSD "
          f"kernel launches", flush=True)


# ---------------------------------------------------------------------------
# Phase 6: the activation-decomposition forward of llama2-7b
# ---------------------------------------------------------------------------

ACT_LAUNCHES = {"lowrank_matmul": 50, "outlier_stats": 20,
                "reorth_left_batched": 400, "reorth_right_batched": 380,
                "dkv_attention_stats": 0, "dkv_attention_stats_paged": 0,
                "ssd_chunk_intra": 0, "ssd_chunk_intra_bwd": 0,
                "matvec": 0, "rmatvec": 0, "matvec_batched": 0,
                "rmatvec_batched": 0}
ACT_LOGITS_TOL = 2e-2    # relative L2, bf16 kernel route vs plain route
ACT_F32_TOL = 1e-3       # the same, float32 weights and forward
ACT_SEQ = 4096           # the paper's 4K setting: tokens [1, ACT_SEQ]


def median_ms(fn, runs: int = 3):
    """Median of ``runs`` CUDA-event times of ``fn()`` (its result is
    dropped before the next run), with every run's time."""
    import torch
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), [round(t, 2) for t in times]


def _recording(engine, log, keep_input: bool):
    """Wrap ``engine.decompose_activation`` so each call appends (its
    input or None, the selected outlier channels) to ``log``."""
    orig = engine.decompose_activation

    def rec(x, *a, **kw):
        out = orig(x, *a, **kw)
        log.append((x if keep_input else None, out.o_idx))
        return out
    engine.decompose_activation = rec


def _forced_selection(log_k, agree):
    """A stand-in for ``select_outlier_channels`` that returns, call by
    call, the channels the kernel route selected (``log_k``), and appends
    to ``agree`` whether the plain selection on this call's own input is
    the same set."""
    import torch
    from repro_torch.core import outlier as ol
    real, picks = ol.select_outlier_channels, iter(log_k)

    def select(x, threshold, num_channels, stats=None):
        idx = next(picks)[1]
        agree.append(torch.equal(real(x, threshold, num_channels, stats),
                                 idx))
        return idx
    return select


def _route_gap(logits_k, logits_r, log_k, log_r) -> dict:
    """Logits relative L2 gap and outlier-set agreement of two routes."""
    import torch
    lk, lr_ = logits_k.float(), logits_r.float()
    same = [torch.equal(a[1], b[1]) for a, b in zip(log_k, log_r)]
    return dict(finite=bool(torch.isfinite(lk).all()
                            and torch.isfinite(lr_).all()),
                rel=((lk - lr_).norm() / lr_.norm()).item(),
                argmax=(lk.argmax(-1) == lr_.argmax(-1)).float().mean().item(),
                n=len(same), same=sum(same), first_equal=same[:1] == [True])


def act_engines(cfg):
    """(policy, {backend: engine}) of phase 6's decomposed forward: the
    paper's best layer list at its rank, 3 % outliers, threshold 3.0,
    attn_mode dense, the kernel route ("cuda") and the plain one."""
    from repro_torch.core.outlier import ThresholdTable
    from repro_torch.core.policy import (PAPER_BEST_CONFIG,
                                         PAPER_LAYER_CONFIGS,
                                         DecompositionPolicy)
    from repro_torch.engine import DecomposeEngine, EngineConfig
    name, rank = PAPER_BEST_CONFIG
    policy = DecompositionPolicy.from_layer_list(
        cfg.num_layers, PAPER_LAYER_CONFIGS[name], rank=rank,
        outlier_frac=0.03)
    # Random-weight rmsnorm outputs are about unit scale, so the default
    # threshold of 6 would leave every count at 0; 3.0 makes the counts,
    # and not only the max |x| tiebreak, pick the channels.
    policy.thresholds = ThresholdTable(default=3.0)
    return policy, {b: DecomposeEngine(EngineConfig(
        policy=policy, attn_mode="dense", backend=b))
        for b in ("cuda", "reference")}


def act_tokens(cfg, seed: int):
    """Phase 6's prompt [1, ACT_SEQ] from ``RandomState(seed)``."""
    import numpy as np
    import torch
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab, (1, ACT_SEQ))).long().cuda()


def activation_llama(cfg, params, profile: bool = False):
    """Phase 6; returns the launch counts of one decomposed forward."""
    import numpy as np
    import torch
    from repro_torch.core import outlier as ol
    from repro_torch.core.policy import PAPER_BEST_CONFIG, PAPER_LAYER_CONFIGS
    from repro_torch.kernels import ops
    from repro_torch.kernels.outlier_extract import outlier_stats_plain
    from repro_torch.models import transformer as T
    from repro_torch.runtime.steps import (make_decomposed_forward_step,
                                           make_decomposed_quality_step)

    name, rank = PAPER_BEST_CONFIG
    policy, engines = act_engines(cfg)
    fwd = {b: make_decomposed_forward_step(cfg, e)
           for b, e in engines.items()}
    tokens = act_tokens(cfg, 0)
    num_c = max(1, round(0.03 * cfg.d_model))
    print(f"activation: {cfg.name} tokens [1, {ACT_SEQ}], layers "
          f"{PAPER_LAYER_CONFIGS[name]} rank {rank}, {num_c} outlier "
          f"channels, threshold 3.0, attn_mode dense", flush=True)

    # (a) one forward through the kernels: exact launch counts
    log_k, log_r = [], []
    _recording(engines["cuda"], log_k, keep_input=True)
    _recording(engines["reference"], log_r, keep_input=False)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    logits_k = fwd["cuda"](params, tokens)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    if launches != ACT_LAUNCHES:
        raise AssertionError(f"decomposed forward launches {launches} != "
                             f"{ACT_LAUNCHES}: something bypassed the "
                             f"kernels")
    print("activation: launches " + json.dumps(launches), flush=True)

    # (b) route check: the same forward through the plain versions on the
    # card.  (b1) The selection itself: on the very input each
    # kernel-route decomposition saw, the plain statistics pick the same
    # channels, in all 20.  (b2) Free running, each route selects on its
    # own inputs, which drift apart by bf16 rounding after the first
    # decomposed layer.  (b3) Index-forced: the plain route takes the
    # kernel route's selection at each decomposition, so what is left of
    # the logits gap is the kernels' rounding alone.  (b4) b2 again on a
    # second prompt (tokens from RandomState(1)).
    per_call = [torch.equal(idx, ol.select_outlier_channels(
        x.float(), 3.0, num_c, stats=outlier_stats_plain))
        for x, idx in log_k]
    logits_r = fwd["reference"](params, tokens)
    free = _route_gap(logits_k, logits_r, log_k, log_r)
    del logits_r
    log_r.clear()
    agree = []
    with mock.patch.object(ol, "select_outlier_channels",
                           _forced_selection(log_k, agree)):
        logits_f = fwd["reference"](params, tokens)
    forced = _route_gap(logits_k, logits_f, log_k, log_r)
    del logits_k, logits_f
    tokens1 = act_tokens(cfg, 1)
    x10 = log_k[2][0].float()        # layer 10's attention input, for (c)
    log_k.clear()
    log_r.clear()
    second = _route_gap(fwd["cuda"](params, tokens1),
                        fwd["reference"](params, tokens1), log_k, log_r)
    torch.cuda.synchronize()
    if ops.launch_counts() != {k: 2 * v for k, v in ACT_LAUNCHES.items()}:
        raise AssertionError("the reference backend launched a kernel")
    for e in engines.values():
        del e.decompose_activation             # drop the recorder
    del log_k, log_r, tokens1
    for label, g in (("free running", free), ("index-forced", forced),
                     ("free running, second prompt", second)):
        print(f"activation: kernel vs reference route, {label}: logits rel "
              f"L2 {g['rel']:.3e} (tol {ACT_LOGITS_TOL}), outlier sets "
              f"equal in {g['same']}/{g['n']} decompositions, argmax "
              f"agreement {g['argmax']:.4f}", flush=True)
    print(f"activation: on the kernel route's own inputs the plain "
          f"statistics select the kernel's channels in "
          f"{sum(per_call)}/{len(per_call)} decompositions; in the "
          f"index-forced run the plain route's own choice agreed in "
          f"{sum(agree)}/{len(agree)}", flush=True)
    gaps = (free, forced, second)
    if not (len(per_call) == len(agree) == 20 and all(per_call)
            and forced["same"] == 20
            and all(g["finite"] and g["n"] == 20 and g["first_equal"]
                    and g["rel"] <= ACT_LOGITS_TOL for g in gaps)):
        raise AssertionError(f"activation routes disagree: {gaps} "
                             f"per_call={per_call}")

    # (c) layer 10's real attention input, float32, kernel vs plain
    lp = policy.layer(10)
    wq = {"w": params["layers"]["attn"]["wq"]["w"][10].float()}
    lrs = {b: engines[b].decompose_activation(x10, lp=lp, threshold=3.0)
           for b in engines}
    s_k, s_r = lrs["cuda"].core, lrs["reference"].core
    s_err = ((s_k - s_r).abs().max() / s_r.abs().max()).item()
    rec = {b: lrs[b].reconstruct() for b in lrs}
    rec_err = ((rec["cuda"] - rec["reference"]).norm()
               / rec["reference"].norm()).item()
    q = {b: engines[b].project(lrs[b], wq).reconstruct() for b in lrs}
    q_err = ((q["cuda"] - q["reference"]).norm()
             / q["reference"].norm()).item()
    idx_eq = torch.equal(lrs["cuda"].o_idx, lrs["reference"].o_idx)
    print(f"activation: layer 10 float32, kernel vs plain: singular "
          f"values max rel err {s_err:.3e}, reconstruction rel err "
          f"{rec_err:.3e}, Q projection rel err {q_err:.3e} (tol 1e-3 "
          f"each), outlier sets equal {idx_eq}", flush=True)
    if not (s_err <= 1e-3 and rec_err <= 1e-3 and q_err <= 1e-3
            and idx_eq):
        raise AssertionError("layer-10 decomposition: kernel route and "
                             "plain route disagree")
    del x10, wq, lrs, rec, q

    # (d) KL(dense ‖ decomposed), then times and peak memory
    kl = make_decomposed_quality_step(cfg, engines["cuda"])(params,
                                                           tokens).item()
    if not (np.isfinite(kl) and kl > 0):
        raise AssertionError(f"KL(dense || decomposed) = {kl}")
    T.forward(params, cfg, tokens)                 # warm the dense path
    dense_ms, dense_all = median_ms(lambda: T.forward(params, cfg, tokens))
    torch.cuda.reset_peak_memory_stats()
    dec_ms, dec_all = median_ms(lambda: fwd["cuda"](params, tokens))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ref_ms, ref_all = median_ms(lambda: fwd["reference"](params, tokens))
    print(f"activation: KL(dense || decomposed) {kl:.6f}; forward ms "
          f"(median of 3): dense {dense_ms:.2f} {dense_all}, decomposed "
          f"via kernels {dec_ms:.2f} {dec_all}, decomposed via plain "
          f"versions {ref_ms:.2f} {ref_all}; peak memory of the decomposed "
          f"forward {peak:.2f} GiB", flush=True)
    if profile:
        with profiled(True, "activation: profile of one decomposed forward"):
            fwd["cuda"](params, tokens)

    # (e) the route check in float32 at full size: float32 rounding keeps
    # the two routes' inputs together, so every decomposition must select
    # the same channels end to end and the logits agree within ACT_F32_TOL
    p32, cfg32 = to_float32(params), cfg.replace(dtype="float32")
    logs = {b: [] for b in engines}
    for b, e in engines.items():
        _recording(e, logs[b], keep_input=False)
    out = {b: make_decomposed_forward_step(cfg32, e)(p32, tokens)
           for b, e in engines.items()}
    for e in engines.values():
        del e.decompose_activation
    g = _route_gap(out["cuda"], out["reference"], logs["cuda"],
                   logs["reference"])
    del p32, out
    print(f"activation: kernel vs reference route, float32: logits rel L2 "
          f"{g['rel']:.3e} (tol {ACT_F32_TOL}), outlier sets equal in "
          f"{g['same']}/{g['n']} decompositions, argmax agreement "
          f"{g['argmax']:.4f}", flush=True)
    if not (g["finite"] and g["n"] == g["same"] == 20
            and g["rel"] <= ACT_F32_TOL):
        raise AssertionError(f"float32 activation routes disagree: {g}")
    return launches


# ---------------------------------------------------------------------------
# Phase 7: paged serving with shared-prefix reuse
# ---------------------------------------------------------------------------

PREFIX_LEN, USER_LEN, PREFIX_REQS = 496, 16, 8
REORTH = ("reorth_right_batched", "reorth_left_batched")


def paged_engine(cfg, params, prefix_cache: int = 0,
                 decode_block: int = 1):
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.serving import Engine
    ecfg = EngineConfig(kv_rank=64, kv_tail=16, kv_page=16,
                        kv_prefix_cache=prefix_cache)
    return Engine(cfg, params, slots=4, max_len=1024, device="cuda",
                  paged=True, decompose_engine=DecomposeEngine(ecfg),
                  decode_block=decode_block)


def check_pages_back(eng, what: str) -> None:
    pg = eng.pager
    if (pg.alloc.free_pages, pg.talloc.free_pages) != (
            pg.num_pages - 1, pg.num_tail_pages - 1):
        raise AssertionError(f"{what}: pages leaked ({pg.alloc.free_pages}"
                             f"/{pg.num_pages - 1} U, {pg.talloc.free_pages}"
                             f"/{pg.num_tail_pages - 1} tail free)")


def paged_same_traffic(cfg, params, slot_tokens, long_tokens,
                       profile: bool = False):
    """(7a) Phase 4's traffic through ``paged=True`` (no prefix cache):
    the same greedy tokens as the slot engine, every page back after the
    drain, decode through the paged kernel only.  Slot and paged engines
    run in turns (slot, paged, paged, slot) so their speeds compare
    within the call.  Then the paged fused twins at 32 and LONG_NEW new
    tokens (tokens equal to phase 4's)."""
    import numpy as np
    import torch
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.kernels import ops
    from repro_torch.serving import Engine
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, n, dtype=np.int32)
               for n in SERVE_LENS]
    runs = {"slot": [], "paged": []}
    for kind in ("slot", "paged", "paged", "slot"):
        eng = paged_engine(cfg, params) if kind == "paged" else Engine(
            cfg, params, slots=4, max_len=1024, device="cuda",
            decompose_engine=DecomposeEngine(EngineConfig(kv_rank=64,
                                                          kv_tail=16)))
        ops.reset_launch_counts()
        done = drive(eng, prompts, SERVE_ARRIVALS, 32)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        got = {r.uid: r.out_tokens for r in done}
        if got != slot_tokens:
            raise AssertionError(f"{kind} tokens {got} != phase 4 tokens "
                                 f"{slot_tokens}")
        if kind == "paged":
            check_pages_back(eng, "paged 7a")
            if launches["dkv_attention_stats"] or \
                    launches["dkv_attention_stats_paged"] <= 0:
                raise AssertionError(f"paged decode bypassed the paged "
                                     f"kernel: {launches}")
            pool = eng.pager.pool_bytes
        runs[kind].append((eng.stats, launches))
        del eng
        torch.cuda.empty_cache()
    fmt = lambda k, f: " / ".join(f(st) for st, _ in runs[k])  # noqa: E731
    st = runs["paged"][0][0]
    print(f"paged (a): phase 4 traffic, tokens equal to phase 4's "
          f"({st.tokens_out} tokens, {st.tail_folds} folds), runs in turns "
          f"slot, paged, paged, slot: decode_tok/s paged "
          f"{fmt('paged', lambda x: f'{x.decode_tok_s:.2f}')} vs slot "
          f"{fmt('slot', lambda x: f'{x.decode_tok_s:.2f}')}; prefill_s "
          f"paged {fmt('paged', lambda x: f'{x.prefill_s:.4f}')} vs slot "
          f"{fmt('slot', lambda x: f'{x.prefill_s:.4f}')}; pool "
          f"{pool / 2 ** 20:.1f} MiB; every page back", flush=True)
    print("paged (a): launches " + json.dumps(runs["paged"][0][1]),
          flush=True)
    fused_pairs("paged (a)", lambda blk: paged_engine(
        cfg, params, decode_block=blk), prompts, st, slot_tokens,
        runs["paged"][0][1], profile, long_ref=long_tokens)


def paged_prefix_llama(cfg, params, profile: bool = False):
    """(7b) Shared-prefix serving: request 0 misses and decomposes the
    496-token system prompt; requests 1-7 admit as prefix hits with a
    16-token suffix prefill and no re-orth launch.  Returns the launch
    counts of the run."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    rng = np.random.RandomState(2)
    system = rng.randint(0, cfg.vocab, PREFIX_LEN, dtype=np.int32)
    prompts = [np.concatenate([system, rng.randint(
        0, cfg.vocab, USER_LEN, dtype=np.int32)])
        for _ in range(PREFIX_REQS)]
    eng = paged_engine(cfg, params, prefix_cache=8)
    hit_reorth, miss_reorth = [], []
    for name, log in (("_dispatch_hits", hit_reorth),
                      ("_dispatch_misses", miss_reorth)):
        def counted(*a, _orig=getattr(eng.family, name), _log=log, **kw):
            before = ops.launch_counts()
            out = _orig(*a, **kw)
            after = ops.launch_counts()
            _log.append(sum(after[k] - before[k] for k in REORTH))
            return out
        setattr(eng.family, name, counted)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    with profiled(profile, "paged (b): profile of the shared-prefix run"):
        ops.reset_launch_counts()
        done = drive(eng, prompts,
                     {0: [0], 2: list(range(1, PREFIX_REQS))}, 32)
        torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    st = eng.stats
    by = {r.uid: r for r in done}
    if sorted(by) != list(range(PREFIX_REQS)) or any(
            len(r.out_tokens) != 32 or not all(0 <= t < cfg.vocab
                                               for t in r.out_tokens)
            for r in done):
        raise AssertionError(f"prefix run: unfinished or bad requests "
                             f"{ {u: len(r.out_tokens) for u, r in by.items()} }")
    if (st.prefix_misses, st.prefix_hits) != (1, PREFIX_REQS - 1):
        raise AssertionError(f"prefix run: {st.prefix_misses} misses, "
                             f"{st.prefix_hits} hits (want 1 and "
                             f"{PREFIX_REQS - 1})")
    if any(hit_reorth) or not hit_reorth or not all(miss_reorth):
        raise AssertionError(f"re-orth launches per hit admission "
                             f"{hit_reorth}, per miss {miss_reorth}")
    if st.tail_folds <= 0 or launches["dkv_attention_stats"] or \
            launches["dkv_attention_stats_paged"] <= 0:
        raise AssertionError(f"prefix run: folds {st.tail_folds}, "
                             f"launches {launches}")
    pg = eng.pager
    cached = len(pg.prefix)
    pg.prefix.drop_all()
    check_pages_back(eng, "paged 7b")
    miss = by[0]
    on_arrival = [by[u] for u in range(1, PREFIX_REQS)
                  if by[u].t_dispatch - by[u].t_submit < 0.05]
    ms = lambda x: x * 1e3   # noqa: E731
    hit_ttft = [ms(r.t_first - r.t_submit) for r in on_arrival]
    hit_admit = [ms(by[u].t_first - by[u].t_dispatch)
                 for u in range(1, PREFIX_REQS)]
    print(f"paged (b): shared prefix {PREFIX_LEN} + {USER_LEN} tokens x "
          f"{PREFIX_REQS} requests: misses {st.prefix_misses}, hits "
          f"{st.prefix_hits}, stalls {st.stalls}, folds {st.tail_folds}, "
          f"{cached} prefix entries, re-orth launches per hit admission "
          f"{hit_reorth} (per miss {miss_reorth}); every page back after "
          f"drop_all", flush=True)
    print(f"paged (b): miss TTFT {ms(miss.t_first - miss.t_submit):.2f} ms"
          f"; hit TTFT (admitted on arrival, {len(hit_ttft)}) mean "
          f"{statistics.mean(hit_ttft):.2f} ms {[round(x, 2) for x in hit_ttft]}"
          f"; hit admission (dispatch to first token, {len(hit_admit)}) "
          f"mean {statistics.mean(hit_admit):.2f} ms; prefill_s "
          f"{st.prefill_s:.4f}, decode_s {st.decode_s:.4f}, decode_tok/s "
          f"{st.decode_tok_s:.2f}, mean_itl_ms {ms(st.mean_itl_s):.2f}, "
          f"peak_mem_gib {peak:.2f} (resident before the run "
          f"{resident:.2f}: weights and this engine's pools; 7a's engines "
          f"freed)", flush=True)
    print("paged (b): launches " + json.dumps(launches), flush=True)
    check_paged_routes(cfg, params, prompts)
    return launches


def check_paged_routes(cfg, params, prompts):
    """One paged decode step, kernel route vs the plain oracle route
    (gathered slab + ``_lowrank_attention``), on a full-width paged cache
    (2 prompts of 286 tokens on shuffled pages, frozen 286 / 200, random
    tails): every layer's attention in bf16, then the float32 logits."""
    import numpy as np
    import torch
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.models import decomposed_kv as DK
    from repro_torch.serving.paged import PagedDKV
    toks = torch.from_numpy(np.stack([prompts[0][:286],
                                      prompts[1][:286]])).long().cuda()
    _, fresh = DK.prefill_dkv(params, cfg, toks, 64, tail=16,
                              engine=DecomposeEngine(EngineConfig(
                                  kv_rank=64, kv_tail=16)))
    pg = PagedDKV(cfg, slots=2, max_len=1024, rank=64, tail=16, page=16,
                  device="cuda")
    n = pg.pages_for(286)
    ids = pg.alloc.alloc(2 * n)
    np.random.RandomState(3).shuffle(ids)
    bt_u = pg.bt_tensor([ids[:n], ids[n:]])
    bt_t = pg.bt_tensor([pg.talloc.alloc(pg.ntp) for _ in range(2)])
    pg.write_fresh(fresh, bt_u, bt_t, [0, 1], [0, 1])
    r = fresh["k_u"].shape[-1]
    del fresh
    gen = torch.Generator(device="cuda").manual_seed(1)
    for pool in pg.cache["tail"].values():
        pool[:, 1:].normal_(generator=gen)
    frozen = torch.tensor([286, 200], dtype=torch.int32, device="cuda")
    pos = torch.tensor([300, 300], dtype=torch.int32, device="cuda")
    geom = (286, r, 16)
    tail_rows = DK._tail_rows(bt_t, pg.page, 16)
    q = torch.randn(2, 1, cfg.num_heads, cfg.resolved_head_dim,
                    generator=gen, device="cuda").bfloat16()
    worst = 0.0
    views = DK._paged_views(pg.cache, r)
    for i in range(cfg.num_layers):
        c = {k: v[i] for k, v in views.items()}
        args = (q, c, pos, frozen, bt_u, tail_rows, 286, cfg)
        o_k = DK._paged_attention(*args)
        o_p = DK._paged_lowrank_attention(*args)
        worst = max(worst, ((o_k - o_p).norm() / o_p.norm()).item())
    if not worst <= 1e-4:
        raise AssertionError(f"paged attention routes differ: rel err "
                             f"{worst:.3e}")
    p32, cfg32 = to_float32(params), cfg.replace(dtype="float32")
    tok = torch.tensor([7, 11], device="cuda")
    lg = {}
    for route in ("kernel", "plain"):
        lg[route], _ = DK.decode_step_dkv_paged(
            p32, cfg32, tok, to_float32(pg.cache), pos, frozen, bt_u, bt_t,
            *geom, attention=route)
    del p32
    lg_k, lg_p = lg["kernel"][:, :cfg.vocab], lg["plain"][:, :cfg.vocab]
    rel = ((lg_k - lg_p).norm() / lg_p.norm()).item()
    if not (torch.isfinite(lg_k).all() and rel <= 1e-3):
        raise AssertionError(f"paged decode logits, kernel vs plain route: "
                             f"relative L2 error {rel:.3e} > 1e-3")
    print(f"paged (b): kernel vs plain paged decode route: attention rel "
          f"err {worst:.3e} over {cfg.num_layers} bf16 layers (tol 1e-4); "
          f"float32 logits rel L2 err {rel:.3e} (tol 1e-3), argmax equal "
          f"{bool((lg_k.argmax(-1) == lg_p.argmax(-1)).all())}", flush=True)


# ---------------------------------------------------------------------------
# Phase 8: Mamba2 serving of mamba2-780m
# ---------------------------------------------------------------------------

MAMBA_ARCH = "mamba2-780m"
MAMBA_TOL = {"bfloat16": 2e-2, "float32": 1e-3}   # route check, rel L2


def serve_mamba2(cfg, params, profile: bool = False):
    """Phase 8: phase 4's traffic through the ssm family; returns the
    launch counts of the run."""
    import numpy as np
    from repro_torch.serving import Engine

    def engine(decode_block: int = 1):
        return Engine(cfg, params, slots=4, max_len=1024, device="cuda",
                      decode_block=decode_block)

    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, n, dtype=np.int32)
               for n in SERVE_LENS]
    eng, done, launches, peak = serve_traffic(
        engine, prompts, profile, "mamba2: profile of the serving run")
    st = eng.stats
    check_finished(done, cfg.vocab, "mamba2")
    if st.prefill_batches < 3:
        raise AssertionError("mamba2: staggered requests were not admitted "
                             "apart")
    want = cfg.num_layers * st.prefill_batches
    if launches["ssd_chunk_intra"] != want or any(
            v for k, v in launches.items() if k != "ssd_chunk_intra"):
        raise AssertionError(f"mamba2 launches {launches}: want exactly "
                             f"{want} ssd_chunk_intra and nothing else")
    cache_mib = sum(t.numel() * t.element_size()
                    for t in eng.cache.values()) / 2 ** 20
    print(f"mamba2: {cfg.name} tokens={st.tokens_out} decode_steps="
          f"{st.decode_steps} prefill_batches={st.prefill_batches} "
          f"prefill_s={st.prefill_s:.4f} decode_s={st.decode_s:.4f} "
          f"decode_tok/s={st.decode_tok_s:.2f} "
          f"mean_ttft_ms={st.mean_ttft_s * 1e3:.2f} "
          f"mean_itl_ms={st.mean_itl_s * 1e3:.2f} peak_mem_gib={peak:.2f} "
          f"state_slots_mib={cache_mib:.1f}", flush=True)
    print("mamba2: launches " + json.dumps(launches), flush=True)
    fused_pairs("mamba2", engine, prompts, st,
                {r.uid: r.out_tokens for r in done}, launches, profile)
    check_mamba2_routes(cfg, params, prompts)
    return launches


def _rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def check_mamba2_routes(cfg, params, prompts):
    """One prefill each of the 512- and the 300-token prompt (left-padded
    to its bucket of 304, as the engine pads it) through the kernel route
    and the ``backend="reference"`` route, in bf16 and with float32
    weights: logits, final SSM state and conv state."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import mamba2 as M
    routes = {b: ops.make_kernels(b) for b in ("cuda", "reference")}
    p32, cfg32 = to_float32(params), cfg.replace(dtype="float32")
    by_len = {len(x): x for x in prompts}
    for n in (512, 300):
        plen = -(-n // 16) * 16
        toks = torch.zeros(1, plen, dtype=torch.long, device="cuda")
        toks[0, plen - n:] = torch.from_numpy(by_len[n]).long()
        for dt, (p, c) in (("bfloat16", (params, cfg)),
                           ("float32", (p32, cfg32))):
            out = {}
            for b, ks in routes.items():
                before = ops.launch_counts()["ssd_chunk_intra"]
                out[b] = M.prefill(p, c, toks, kernels=ks)
                torch.cuda.synchronize()
                ran = ops.launch_counts()["ssd_chunk_intra"] - before
                if ran != (cfg.num_layers if b == "cuda" else 0):
                    raise AssertionError(f"mamba2 route {b}: {ran} SSD "
                                         f"kernel launches")
            (lk, sk), (lr_, sr) = out["cuda"], out["reference"]
            lk, lr_ = lk[:, :cfg.vocab], lr_[:, :cfg.vocab]
            gaps = {"logits": _rel(lk, lr_), "ssm": _rel(sk["ssm"], sr["ssm"]),
                    "conv": _rel(sk["conv"], sr["conv"])}
            tol = MAMBA_TOL[dt]
            ok = torch.isfinite(lk).all().item() and all(
                g <= tol for g in gaps.values())
            if dt == "float32":
                for key in ("ssm", "conv"):
                    scale = sr[key].abs().max().item()
                    ok = ok and torch.allclose(sk[key], sr[key], rtol=1e-3,
                                               atol=1e-3 * scale)
            print(f"mamba2: kernel vs reference route, prompt {n} (Q = "
                  f"{64 if plen % 64 == 0 else plen}), {dt}: rel L2 logits "
                  f"{gaps['logits']:.3e}, ssm state {gaps['ssm']:.3e}, conv "
                  f"state {gaps['conv']:.3e} (tol {tol}), argmax equal "
                  f"{bool((lk.argmax(-1) == lr_.argmax(-1)).all())}",
                  flush=True)
            if not ok:
                raise AssertionError(f"mamba2 routes disagree ({dt}, "
                                     f"prompt {n}): {gaps}")
            del out
    del p32


# ---------------------------------------------------------------------------
# Phase 9: the autotuner and the Fig. 12 expansion sweep
# ---------------------------------------------------------------------------

FIG12_SCALAR = (4096, 4096)              # float32, L2 flushed per call
FIG12_BATCHED = (64, 4096, 4096)         # the paper's Fig. 12 geometry, bf16
FIG12_POINTS = (("matvec", FIG12_SCALAR, "float32"),
                ("matvec", FIG12_BATCHED, "bfloat16"),
                ("rmatvec", FIG12_SCALAR, "float32"),
                ("rmatvec", FIG12_BATCHED, "bfloat16"))
REORTH_TUNE = (32, 512, 4096)            # phase 4's re-orth shape (B = 32)
REORTH_TUNE_ACT = (1, 4096, 4096)        # phase 6's (B = 1)
#: the knob spaces' measured tunes (bf16): the Eq. 6 GEMM at phase 6's two
#: shapes (k, H, N), the dkv statistics at phase 4's (B, G, T, r) and at
#: batch 1 over 8192 rows
KNOB_TUNES = (("lowrank_matmul", (20, 4096, 4096)),
              ("lowrank_matmul", (20, 4096, 11008)),
              ("dkv_attention", (4, 32, 512, 64)),
              ("dkv_attention", (1, 32, 8192, 64)))


def _knob_library(kernel: str, shape, dev: str = "cuda"):
    """(the card's plan, the one-call library yardstick) at a tune's
    measured shape, on the tune's own inputs: the kernel with no knobs
    and ``torch.matmul`` for the GEMM; the dkv kernel's 32-row chunks
    and SDPA over the same rows for the statistics."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import dkv_attention as dk
    from repro_torch.kernels import lowrank_matmul as lm
    from repro_torch.tune.measure import _rand
    dv = torch.device(dev)
    if kernel == "lowrank_matmul":
        k, h, n = shape
        vt, w = _rand(0, (k, h), "bfloat16", dv), _rand(1, (h, n),
                                                        "bfloat16", dv)
        return lambda: lm.lowrank_matmul(vt, w), lambda: torch.matmul(vt, w)
    b, g, t, r = shape
    inner = _rand(0, (b, g, r), "float32", dv)
    k_u, v_u = _rand(1, (b, t, r), "bfloat16", dv), _rand(2, (b, t, r),
                                                          "bfloat16", dv)
    tv = torch.full((b,), t, dtype=torch.int32, device=dv)
    q4, k4, v4 = inner.bfloat16()[:, None], k_u[:, None], v_u[:, None]
    return (lambda: dk.dkv_attention_stats(inner, k_u, v_u, tv),
            lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0))


def knob_tunes() -> None:
    """Measured tunes of the ``lowrank_matmul`` and ``dkv_attention``
    spaces (every candidate the kernel takes, 7 launches each: asserted)
    at :data:`KNOB_TUNES`; a second tune must answer from the cache, and
    no other kernel's launch count may move.  Prints the measured and
    model curves (the tuner times the bucketed shape) beside the card's
    own plan and the library call at that shape, under the same timer.
    Speed is not gated."""
    import torch
    from repro_torch import tune
    from repro_torch.kernels import ops
    name = {"lowrank_matmul": "lowrank_matmul",
            "dkv_attention": "dkv_attention_stats"}
    for kernel, shape in KNOB_TUNES:
        before = ops.launch_counts()
        res = tune.tune(kernel, shape, "bfloat16", prune=None,
                        measure_candidates=True, device="cuda", force=True)
        after = ops.launch_counts()
        ran = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        if ran != {name[kernel]: len(res.table) * 7}:
            raise AssertionError(f"{kernel} tune at {shape}: launches {ran}, "
                                 f"want {len(res.table) * 7} of "
                                 f"{name[kernel]} and no other")
        again = tune.tune(kernel, shape, "bfloat16", measure_candidates=True,
                          device="cuda")
        if again.source != "cache" or again.best != res.best:
            raise AssertionError(f"{kernel} tune at {shape} did not hit its "
                                 f"cache entry: {again.source} {again.best}")
        if ops.launch_counts() != after:
            raise AssertionError(f"{kernel}: the cached tune launched")
        # the card's plan, the measured best again and the library call,
        # each the median of 21 calls under the tuner's timer
        plan, lib = _knob_library(kernel, res.shape)
        plan_s = tune.timeit(plan, reps=21, device="cuda")
        best_s = tune.measure_candidate(kernel, res.shape, "bfloat16",
                                        res.best, reps=21, device="cuda")
        lib_s = tune.timeit(lib, reps=21, device="cuda")
        torch.cuda.empty_cache()
        key = lambda c: "/".join(f"{c[p]}" for p in sorted(c))  # noqa: E731
        curve = " ".join(f"{key(c)}={m * 1e3:.5f}" for c, _, m in res.table)
        model = " ".join(f"{key(c)}={p * 1e3:.5f}" for c, p, _ in res.table)
        pick = min(res.table, key=lambda r: r[1])[0]
        print(f"fig12: {kernel} tune at {list(shape)} (measured at "
              f"{list(res.shape)}, bf16; points {'/'.join(sorted(pick))}): "
              f"measured ms {curve}; model ms {model}; model pick {pick}, "
              f"measured best {res.best} at {res.measured_s * 1e3:.5f} ms "
              f"({best_s * 1e3:.5f} over 21 calls); card's plan "
              f"{plan_s * 1e3:.5f} ms; "
              f"{'torch.matmul' if kernel == 'lowrank_matmul' else 'SDPA'} "
              f"{lib_s * 1e3:.5f} ms (not gated); second tune answered from "
              f"the {again.source}", flush=True)
        print("fig12: " + json.dumps(dict(
            kernel=kernel, shape=list(shape), measured_shape=list(res.shape),
            table=[[c, p, m] for c, p, m in res.table], best=res.best,
            model_pick=pick, best_ms_21=best_s * 1e3, plan_ms=plan_s * 1e3,
            library_ms=lib_s * 1e3,
            launches=len(res.table) * 7)), flush=True)


def phase_fig12():
    """The Fig. 12 A/B (``launch.fig12.run_ab``) at each operating point:
    the whole f grid swept through the CUDA kernel, the tuner's pruning
    replayed, tuned within 1.05x of the swept optimum (asserted), and the
    launch counters raised by exactly the calls the A/B made.  Then a
    measured tune of the re-orth kernel's blocks per element at phase 4's
    and phase 6's shapes (not gated; a second tune must hit the cache),
    and an
    ``EngineConfig(expansion="auto")`` decomposition of one [32, 512,
    4096] batch, bit-identical to the engine pinned at the resolved f.
    Before that, :func:`knob_tunes`: the Eq. 6 GEMM's and the dkv
    statistics' spaces tuned on the card.  Returns the launch counts of
    the four A/Bs."""
    import torch
    from repro_torch import tune
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import fig12
    model = fig12.model_rows()
    print(f"fig12: the paper's accelerator model (arithmetic, not a "
          f"measurement): f*={model['f_star']}, f=1 over f* "
          f"{model['speedup_vs_f1']:.2f}x", flush=True)
    sweeps = {}
    ops.reset_launch_counts()
    for op, shape, dt in FIG12_POINTS:
        name = op if len(shape) == 2 else f"{op}_batched"
        before = ops.launch_counts()
        data = fig12.run_ab(op, shape, dt, reps=5, device="cuda")
        torch.cuda.empty_cache()
        after = ops.launch_counts()
        ran = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        for line in fig12.ab_lines(data):
            print(line, flush=True)
        print("fig12: " + json.dumps(data), flush=True)
        if ran != {name: data["calls"]}:
            raise AssertionError(f"fig12 {name}: launches {ran}, want "
                                 f"exactly {data['calls']} of {name}")
        if sorted(data["swept_s"]) != [1, 2, 4, 8, 16, 32, 64, 128]:
            raise AssertionError(f"fig12 {name}: swept f "
                                 f"{sorted(data['swept_s'])}")
        fig12.check_gate(data)
        sweeps[(op, len(shape))] = data["swept_s"]
    launches = ops.launch_counts()
    fit = tune.cost_model.fit_h100(
        sweeps[("matvec", 2)], FIG12_SCALAR, sweeps[("matvec", 3)],
        FIG12_BATCHED, "float32", "bfloat16")
    print(f"fig12: H100 model constants fitted to the matvec sweeps: "
          f"sat_warps={fit['sat_warps']:.1f} (per-warp rate "
          f"{fit['per_warp_bytes_s'] / 1e9:.3f} GB/s) cta_s="
          f"{fit['cta_s']:.3e}; in use: sat_warps={tune.H100.sat_warps} "
          f"cta_s={tune.H100.cta_s:.1e}", flush=True)

    fix = {"backend": "cuda"}
    for shape in (REORTH_TUNE, REORTH_TUNE_ACT):
        before = ops.launch_counts()["reorth_right_batched"]
        res = tune.tune("lanczos_reorth", shape, "float32", fix=fix,
                        prune=None, measure_candidates=True, device="cuda",
                        force=True)
        ran = ops.launch_counts()["reorth_right_batched"] - before
        if ran != len(res.table) * 7:
            raise AssertionError(f"re-orth tune: {ran} launches, want "
                                 f"{len(res.table) * 7}")
        again = tune.tune("lanczos_reorth", shape, "float32", fix=fix,
                          measure_candidates=True, device="cuda")
        if again.source != "cache" or again.best != res.best:
            raise AssertionError(f"re-orth tune did not hit its cache "
                                 f"entry: {again.source} {again.best}")
        table = sorted(res.table, key=lambda r: r[0]["expansion"])
        curve = " ".join(f"f{c['expansion']}={m * 1e3:.4f}"
                         for c, _, m in table)
        model = " ".join(f"f{c['expansion']}={p * 1e3:.4f}"
                         for c, p, _ in table)
        pick = min(res.table, key=lambda r: r[1])[0]["expansion"]
        print(f"fig12: re-orth (right) blocks per element at B, S, H = "
              f"{shape} (cluster of min(f, 16) CTAs): measured ms {curve}; "
              f"model ms {model}; model pick f={pick}, measured best "
              f"f={res.best['expansion']} (not gated); second tune "
              f"answered from the {again.source}", flush=True)
        torch.cuda.empty_cache()
    # the left step has no space of its own (the tuner times right steps):
    # its curve at the same shapes, warm, on the tune's k = 16 zero basis
    from repro_torch.kernels import lanczos_reorth as lr
    gen = torch.Generator(device="cuda").manual_seed(9)
    for b, s, h in (REORTH_TUNE, REORTH_TUNE_ACT):
        a = torch.randn(b, s, h, generator=gen, device="cuda")
        v = torch.randn(b, h, generator=gen, device="cuda")
        u_buf = torch.zeros(b, s, 16, device="cuda")
        def step(f):
            return lambda: lr.reorth_left_batched(a, v, u_buf, expansion=f)
        curve = " ".join(f"f{f}={time_ms(step(f)):.4f}"
                         for f in tune.EXPANSION_GRID)
        print(f"fig12: re-orth (left) blocks per element at B, S, H = "
              f"{(b, s, h)}: measured ms {curve} (warm)", flush=True)
        del a
        torch.cuda.empty_cache()

    knob_tunes()
    if {k: ops.launch_counts()[k] for k in MATVEC_LINES} != {
            k: launches[k] for k in MATVEC_LINES}:
        raise AssertionError("fig12: the knob tunes moved the matvec "
                             "launch counts")

    x = torch.randn(*REORTH_TUNE, generator=gen, device="cuda")
    auto = DecomposeEngine(EngineConfig(expansion="auto"))
    f = auto.resolve_expansion(REORTH_TUNE[1], REORTH_TUNE[2],
                               REORTH_TUNE[0], "float32", "cuda")
    pinned = DecomposeEngine(EngineConfig(expansion=f))
    lr_a, lr_p = auto.decompose(x, 64, iters=72), pinned.decompose(x, 64,
                                                                 iters=72)
    kv_a, kv_p = auto.decompose_kv(x, 64), pinned.decompose_kv(x, 64)
    torch.cuda.synchronize()
    same = all(torch.equal(p, q) for p, q in (
        (lr_a.u, lr_p.u), (lr_a.core, lr_p.core), (lr_a.vt, lr_p.vt),
        (kv_a[0], kv_p[0]), (kv_a[1], kv_p[1])))
    if not same:
        raise AssertionError(f"expansion='auto' (f={f}) differs from the "
                             f"engine pinned at f={f}")
    print(f"fig12: {auto!r} resolved f={f} for {list(REORTH_TUNE)} "
          f"(the measured entry); decompose and decompose_kv bit-identical "
          f"to expansion={f}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 10: async admission on llama2-7b's decomposed KV
# ---------------------------------------------------------------------------

def _mean_ms(xs) -> str:
    return f"{statistics.fmean(xs) * 1e3:.2f}" if xs else "n/a"


def _itl_text(itl) -> str:
    adm = itl["admission"]
    return (f"itl_ms admission steps mean {_mean_ms(adm)} max "
            f"{max(adm) * 1e3 if adm else 0:.2f} ({len(adm)} tokens), "
            f"other steps mean {_mean_ms(itl['other'])}")


def run_async(tag: str, what: str, eng, prompts, max_new: int = 32):
    """Phase 4's traffic through ``eng``; an async engine must end with
    no ticket, no reserved slot and (paged) every page back.  Prints one
    line (decode tok/s, the TTFT split, the live streams' ITL in
    admission steps against the others).  Returns ({uid: tokens},
    stats)."""
    import torch
    itl = {"admission": [], "other": []}
    # tickets whose prefill had already finished when dispatch returned
    # (its host waited for the device inside the prefill)
    early = []
    if eng.prefill_stream is not None:
        dispatch = eng.family.dispatch

        def probed(*a, **kw):
            tickets = dispatch(*a, **kw)
            early.extend(t.ready() for t in tickets)
            return tickets
        eng.family.dispatch = probed
    done = drive(eng, prompts, SERVE_ARRIVALS, max_new, itl)
    # the wrapper and the family hold each other: drop it, or the cycle
    # keeps the family's graph buffers until a garbage collection
    eng.family.__dict__.pop("dispatch", None)
    torch.cuda.synchronize()
    check_finished(done, eng.cfg.vocab, f"{tag} {what}", max_new)
    if eng._pool or eng._reserved.any() or eng._occupied():
        raise AssertionError(f"{tag} {what}: tickets or slots left over")
    if eng.pager is not None:
        check_pages_back(eng, f"{tag} {what}")
    if eng.decode_block > 1 and (eng.graphs.eager
                                 or eng.graphs.replays != eng.stats.blocks):
        raise AssertionError(f"{tag} {what}: {eng.graphs.eager} eager "
                             f"blocks")
    st = eng.stats
    print(f"{tag}: {what}: decode_tok/s={st.decode_tok_s:.2f} "
          f"ttft_ms={_mean_ms(st.ttft_s)} (queue {_mean_ms(st.ttft_queue_s)}"
          f" + prefill {_mean_ms(st.ttft_compute_s)}) prefill_s="
          f"{st.prefill_s:.4f} {_itl_text(itl)} inflight_peak="
          f"{st.prefill_inflight_peak} folds={st.tail_folds} "
          f"blocks={st.blocks}"
          + (f" tickets done at dispatch {sum(early)} of {len(early)}"
             if early else ""), flush=True)
    return {r.uid: r.out_tokens for r in done}, st


def sync_ready_turns(tag: str, engine, prompts):
    """Sync and async ``"ready"`` single-step runs in turns (sync, ready,
    ready, sync), so their TTFT and ITL compare within the call.  A ready
    run must finish everything with a ticket in flight at least once.
    Returns the sync run's tokens and whether each ready run's equal
    them."""
    runs = {}
    for kind in ("sync", "ready", "ready", "sync"):
        kw = {} if kind == "sync" else dict(prefill_async=True,
                                            ready_order="ready")
        got, st = run_async(tag, f"{kind} single-step", engine(1, **kw),
                            prompts)
        if kind == "ready" and st.prefill_inflight_peak < 1:
            raise AssertionError(f"{tag}: no ticket was ever in flight")
        runs.setdefault(kind, []).append(got)
    sync = runs["sync"][0]
    if runs["sync"][1] != sync:
        raise AssertionError(f"{tag}: two sync runs gave different tokens")
    return sync, [got == sync for got in runs["ready"]]


def phase_async(cfg, params, slot_tokens=None):
    """Phase 4's traffic through ``prefill_async=True`` engines: sync and
    ``"ready"`` slab runs in turns (every request finished, every slot
    back, a ticket in flight); in deterministic order, slab and paged,
    single-step and fused, the sync run's tokens (and phase 4's); a
    ready paged run with every page back."""
    import numpy as np
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.serving import Engine
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, n, dtype=np.int32)
               for n in SERVE_LENS]

    def engine(block=1, paged=False, **kw):
        ecfg = EngineConfig(kv_rank=64, kv_tail=16, kv_page=16)
        return Engine(cfg, params, slots=4, max_len=1024, device="cuda",
                      paged=paged, decompose_engine=DecomposeEngine(ecfg),
                      decode_block=block, **kw)

    sync, ready_equal = sync_ready_turns("async", engine, prompts)
    if slot_tokens is not None and sync != slot_tokens:
        raise AssertionError("async phase: sync tokens differ from phase 4's")
    for paged in (False, True):
        for block in (1, FUSED_BLOCK):
            what = f"deterministic {'paged' if paged else 'slab'} " \
                   f"decode_block={block}"
            got, st = run_async("async", what, engine(
                block, paged, prefill_async=True,
                ready_order="deterministic"), prompts)
            if got != sync or st.prefill_inflight_peak:
                raise AssertionError(f"async {what}: tokens differ from the "
                                     f"sync run's")
    got, st = run_async("async", "ready paged single-step", engine(
        1, True, prefill_async=True, ready_order="ready"), prompts)
    if st.prefill_inflight_peak < 1:
        raise AssertionError("async ready paged: no ticket was in flight")
    print(f"async: deterministic tokens equal to sync everywhere; ready "
          f"runs' tokens equal to sync: slab {ready_equal}, paged "
          f"{got == sync} (co-folds follow admission rounds); every slot "
          f"and page back", flush=True)


# ---------------------------------------------------------------------------
# Phase 11: hybrid serving of zamba2-1.2b
# ---------------------------------------------------------------------------

HYBRID_ARCH = "zamba2-1.2b"


def _n_mamba(cfg) -> int:
    return cfg.num_layers - cfg.num_layers // cfg.attn_period


def _step_bound_ms(params, cache) -> float:
    """The least time of one decode step: every weight and every cache
    leaf read once, over the card's memory rate; of an untied embedding
    table only one row is read (a tied one is the head: read whole)."""
    import torch
    from repro_torch.models import transformer as T
    leaves = [t for t in _leaves(cache) if isinstance(t, torch.Tensor)]
    b = T.param_bytes(params) + sum(t.numel() * t.element_size()
                                    for t in leaves)
    if "lm_head" in params:
        b -= T.param_bytes(params["embed"])
    return b / rates().HBM_BW * 1e3


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def replayed_step_ms(engine, prompts) -> tuple:
    """One replayed fused block of FUSED_BLOCK steps on 4 admitted slots
    (no stop token, so every step runs), read back: median of 5, per
    step.  Returns (ms per step, the step's bound in ms)."""
    import torch
    from repro_torch.serving import Request
    eng = engine(FUSED_BLOCK)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=32))
    eng._admit()
    tok, stops = eng._last_tokens(), eng._stop_table()
    eng.family.decode_block(tok, FUSED_BLOCK, stops)        # capture
    ts = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, steps = eng.family.decode_block(tok, FUSED_BLOCK, stops)
        ts.append((time.perf_counter() - t0) / steps)
    if eng.graphs.eager:
        raise AssertionError("replayed step: a block ran eagerly")
    return statistics.median(ts) * 1e3, _step_bound_ms(eng.params,
                                                       eng.cache)


def serve_family_phase(tag: str, cfg, params, profile: bool, launch_check,
                       rows_independent: bool):
    """Phase 4's traffic through the config's own family: single-step
    (profiled when asked), its fused twin at FUSED_BLOCK (tokens equal,
    every block a replay), sync and ``"ready"`` runs in turns (ready
    tokens equal to sync's where rows never interact, i.e. where an
    admission a step later changes no other row), and async
    deterministic single-step and fused (tokens equal to the sync
    run's).  ``launch_check(launches, prefill_batches)`` holds the
    kernel launches of the first sync run.  Returns (the engine
    factory, prompts, the fused engine)."""
    import numpy as np
    from repro_torch.serving import Engine

    def engine(decode_block: int = 1, **kw):
        return Engine(cfg, params, slots=4, max_len=1024, device="cuda",
                      decode_block=decode_block, **kw)

    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, n, dtype=np.int32)
               for n in SERVE_LENS]
    eng, done, launches, peak = serve_traffic(
        engine, prompts, profile, f"{tag}: profile of the serving run")
    st = eng.stats
    check_finished(done, cfg.vocab, tag)
    if st.prefill_batches < 3:
        raise AssertionError(f"{tag}: staggered requests were not admitted "
                             f"apart")
    launch_check(launches, st.prefill_batches)
    tokens = {r.uid: r.out_tokens for r in done}
    print(f"{tag}: {cfg.name} tokens={st.tokens_out} decode_steps="
          f"{st.decode_steps} prefill_batches={st.prefill_batches} "
          f"prefill_s={st.prefill_s:.4f} decode_s={st.decode_s:.4f} "
          f"decode_tok/s={st.decode_tok_s:.2f} "
          f"mean_ttft_ms={st.mean_ttft_s * 1e3:.2f} "
          f"mean_itl_ms={st.mean_itl_s * 1e3:.2f} peak_mem_gib={peak:.2f}",
          flush=True)
    print(f"{tag}: launches " + json.dumps(launches), flush=True)
    del eng
    fused, ftok, flaunch, fpeak = serve_once(
        lambda: engine(FUSED_BLOCK), prompts, 32, profile,
        f"{tag}: profile of the fused serving run "
        f"(decode_block={FUSED_BLOCK})")
    check_fused(tag, fused, ftok, flaunch, tokens, launches)
    fused_line(f"{tag} fused", 32, st, fused, fpeak)
    sync, ready_equal = sync_ready_turns(tag, engine, prompts)
    if sync != tokens or (rows_independent and not all(ready_equal)):
        raise AssertionError(f"{tag}: sync or ready tokens differ from the "
                             f"first run's ({ready_equal})")
    print(f"{tag} async: ready runs' tokens equal to sync {ready_equal}",
          flush=True)
    for blk in (1, FUSED_BLOCK):
        det, dtok, dlaunch, _ = serve_once(
            lambda: engine(blk, prefill_async=True,
                           ready_order="deterministic"), prompts, 32)
        if dtok != tokens:
            raise AssertionError(f"{tag}: async deterministic tokens "
                                 f"(decode_block={blk}) differ from sync")
        if blk > 1:
            check_fused(f"{tag} async", det, dtok, dlaunch, tokens,
                        launches)
        print(f"{tag} async: deterministic, decode_block={blk}: tokens "
              f"equal to sync; decode_tok/s={det.stats.decode_tok_s:.2f} "
              f"ttft_ms={_mean_ms(det.stats.ttft_s)} (queue "
              f"{_mean_ms(det.stats.ttft_queue_s)} + prefill "
              f"{_mean_ms(det.stats.ttft_compute_s)})", flush=True)
        del det
    return engine, prompts, fused


def serve_hybrid(cfg, params, profile: bool = False):
    """Phase 11: zamba2-1.2b on phase 4's traffic; exactly one
    ``ssd_chunk_intra`` launch per Mamba2 block per prefill launch and
    no other kernel; the prefill route check.  Returns the launch counts
    of the sync run."""
    n = _n_mamba(cfg)
    seen = {}

    def check(launches, batches):
        seen.update(launches)
        if launches["ssd_chunk_intra"] != n * batches or any(
                v for k, v in launches.items() if k != "ssd_chunk_intra"):
            raise AssertionError(f"hybrid launches {launches}: want exactly "
                                 f"{n * batches} ssd_chunk_intra and "
                                 f"nothing else")
        print(f"hybrid: {launches['ssd_chunk_intra']} ssd_chunk_intra "
              f"launches = {n} Mamba2 blocks x {batches} prefill launches",
              flush=True)

    engine, prompts, fused = serve_family_phase("hybrid", cfg, params,
                                                profile, check, True)
    ms, bms = replayed_step_ms(engine, prompts)
    print(f"hybrid: replayed decode step {ms:.3f} ms (4 slots, block of "
          f"{FUSED_BLOCK}) vs bound {bms:.3f} ms (weights and state read "
          f"once)", flush=True)
    del fused
    check_hybrid_routes(cfg, params, prompts)
    return seen


def check_hybrid_routes(cfg, params, prompts):
    """Phase 8's route check on the hybrid prefill: the 512- and 300-token
    prompts through the kernel route and ``backend="reference"``, bf16
    and float32 weights: logits, the Mamba2 states and the shared
    block's K."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import hybrid as H
    routes = {b: ops.make_kernels(b) for b in ("cuda", "reference")}
    p32, cfg32 = to_float32(params), cfg.replace(dtype="float32")
    by_len = {len(x): x for x in prompts}
    n_m = _n_mamba(cfg)
    for n in (512, 300):
        plen = -(-n // 16) * 16
        toks = torch.zeros(1, plen, dtype=torch.long, device="cuda")
        toks[0, plen - n:] = torch.from_numpy(by_len[n]).long()
        for dt, (p, c) in (("bfloat16", (params, cfg)),
                           ("float32", (p32, cfg32))):
            out = {}
            for b, ks in routes.items():
                before = ops.launch_counts()["ssd_chunk_intra"]
                out[b] = H.prefill(p, c, toks, kernels=ks)
                torch.cuda.synchronize()
                ran = ops.launch_counts()["ssd_chunk_intra"] - before
                if ran != (n_m if b == "cuda" else 0):
                    raise AssertionError(f"hybrid route {b}: {ran} SSD "
                                         f"kernel launches")
            (lk, sk), (lr_, sr) = out["cuda"], out["reference"]
            lk, lr_ = lk[:, :cfg.vocab], lr_[:, :cfg.vocab]
            pairs = {"ssm": (sk["mamba"]["ssm"], sr["mamba"]["ssm"]),
                     "conv": (sk["mamba"]["conv"], sr["mamba"]["conv"]),
                     "attn_k": (sk["attn"]["k"], sr["attn"]["k"])}
            gaps = {"logits": _rel(lk, lr_)}
            gaps.update({k: _rel(a, b) for k, (a, b) in pairs.items()})
            tol = MAMBA_TOL[dt]
            ok = torch.isfinite(lk).all().item() and all(
                g <= tol for g in gaps.values())
            if dt == "float32":
                for a, b in (pairs["ssm"], pairs["conv"]):
                    scale = b.abs().max().item()
                    ok = ok and torch.allclose(a, b, rtol=1e-3,
                                               atol=1e-3 * scale)
            print(f"hybrid: kernel vs reference route, prompt {n}, {dt}: "
                  f"rel L2 " + ", ".join(f"{k} {v:.3e}"
                                         for k, v in gaps.items())
                  + f" (tol {tol}), argmax equal "
                  f"{bool((lk.argmax(-1) == lr_.argmax(-1)).all())}",
                  flush=True)
            if not ok:
                raise AssertionError(f"hybrid routes disagree ({dt}, "
                                     f"prompt {n}): {gaps}")
            del out
    del p32


# ---------------------------------------------------------------------------
# Phase 12: MoE serving of olmoe-1b-7b
# ---------------------------------------------------------------------------

MOE_ARCH = "olmoe-1b-7b"


def serve_moe(cfg, params, profile: bool = False):
    """Phase 12: olmoe-1b-7b at its own capacity factor on phase 4's
    traffic (no kernel of the port on this path: every count stays 0);
    the replayed decode step against its bound."""
    import torch
    from repro_torch.models import transformer as T

    def check(launches, batches):
        if any(launches.values()):
            raise AssertionError(f"moe launched port kernels: {launches}")

    torch.cuda.reset_peak_memory_stats()
    # MoE rows interact through expert capacity: a ready admission a step
    # later changes the batches, so ready tokens may differ from sync's
    engine, prompts, fused = serve_family_phase("moe", cfg, params, profile,
                                                check, False)
    del fused
    ms, bms = replayed_step_ms(engine, prompts)
    e, h, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    experts = 3 * e * h * f * 2 * (cfg.num_layers - cfg.first_k_dense)
    print(f"moe: replayed decode step {ms:.3f} ms (4 slots, capacity "
          f"factor {cfg.capacity_factor}, block of {FUSED_BLOCK}) vs bound "
          f"{bms:.3f} ms (every weight and the KV cache read once; all "
          f"{e} experts' weights alone {experts / 2 ** 30:.2f} GiB = "
          f"{experts / rates().HBM_BW * 1e3:.3f} ms); weights "
          f"{T.param_bytes(params) / 2 ** 30:.2f} GiB, peak_mem_gib="
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}", flush=True)


# ---------------------------------------------------------------------------
# Phase 13: keyed sampling on llama2-7b
# ---------------------------------------------------------------------------

def sampler_llama(cfg, params):
    """Phase 13: ``categorical_sampler(1.0)``, seed 0, on phase 4's
    traffic through decomposed-KV engines (rank 64, tail 16): tokens at
    decode_block 1, 3 and 8 equal, every fused block a replay whose
    launches are the single-step run's; seed 0 again gives the same
    tokens and seed 1 others; async deterministic (blocks 1 and 8) gives
    sync's tokens."""
    import numpy as np
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.serving import Engine, categorical_sampler

    ecfg = EngineConfig(kv_rank=64, kv_tail=16)

    def engine(block: int = 1, seed: int = 0, **kw):
        return Engine(cfg, params, slots=4, max_len=1024,
                      decompose_engine=DecomposeEngine(ecfg), device="cuda",
                      decode_block=block, sampler=categorical_sampler(1.0),
                      sample_seed=seed, **kw)

    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, n, dtype=np.int32)
               for n in SERVE_LENS]
    single, tokens, launches, _ = serve_once(engine, prompts, 32,
                                             title="sampler single-step")
    if single.stats.tail_folds <= 0:
        raise AssertionError("sampler: no tail fold happened")
    rates = {1: decode_rates(single.stats)}
    del single
    for blk in (3, FUSED_BLOCK):
        eng, tok, lau, _ = serve_once(lambda: engine(blk), prompts, 32,
                                      title=f"sampler block {blk}")
        check_fused(f"sampler block {blk}", eng, tok, lau, tokens,
                    launches)
        rates[blk] = (f"{decode_rates(eng.stats, eng.graphs)} in "
                      f"{eng.stats.blocks} blocks, "
                      f"{eng.graphs.replays} replays")
        del eng
    _, again, _, _ = serve_once(lambda: engine(FUSED_BLOCK), prompts, 32,
                                title="sampler seed 0 again")
    _, other, _, _ = serve_once(lambda: engine(FUSED_BLOCK, seed=1),
                                prompts, 32, title="sampler seed 1")
    if again != tokens or other == tokens:
        raise AssertionError("sampler: seed 0 twice gave other tokens, or "
                             "seed 1 the same")
    for blk in (1, FUSED_BLOCK):
        det, dtok, dlau, _ = serve_once(
            lambda: engine(blk, prefill_async=True,
                           ready_order="deterministic"), prompts, 32,
            title=f"sampler async block {blk}")
        if dtok != tokens:
            raise AssertionError(f"sampler: async deterministic tokens "
                                 f"(decode_block={blk}) differ from sync")
        if blk > 1:
            check_fused("sampler async", det, dtok, dlau, tokens, launches)
        del det
    differ = sum(a != b for u in tokens for a, b in zip(tokens[u],
                                                       other[u]))
    print(f"sampler: categorical T=1.0 seed 0 on {cfg.name}: tokens equal "
          f"at decode_block 1, 3, {FUSED_BLOCK} (every fused block a "
          f"replay, launches equal to single-step's) and in async "
          f"deterministic runs (blocks 1, {FUSED_BLOCK}); seed 0 again "
          f"equal, seed 1 differs in {differ}/128 tokens; decode tok/s "
          + "; ".join(f"block {k}: {v}" for k, v in rates.items()),
          flush=True)


# ---------------------------------------------------------------------------
# Phase 14: the dense family's other variants at full width and depth
# ---------------------------------------------------------------------------

VARIANT_ARCHS = ("starcoder2-7b", "gemma-2b", "granite-3-2b")
BIAS_STD = 0.02          # biases, norm biases and cross gates, N(0, std²)
VARIANT_ACT_SEQ = 2048   # the activation forward's tokens [1, 2048]


def nonzero_biases(params, seed: int = 1) -> int:
    """Redraw every bias, norm bias and cross gate of ``params`` from
    N(0, BIAS_STD²) in place (the init zeroes them: a missing bias add or
    a closed cross block would go unseen).  Returns how many tensors."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = 0

    def walk(tree):
        nonlocal n
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("b", "bias", "gate_attn", "gate_mlp"):
                v.copy_(torch.randn(v.shape, generator=gen, device=v.device)
                        * BIAS_STD)
                n += 1
    walk(params)
    return n


def serve_variant(cfg, params, profile: bool = False):
    """Phase 14 for one variant: phase 4's traffic decomposed-KV (rank 64,
    tail 16) single-step and fused, the decode route check, the replayed
    step against its bound.  Returns the single-step run's launches."""
    import numpy as np
    import torch
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.serving import Engine

    tag = cfg.name
    ecfg = EngineConfig(kv_rank=64, kv_tail=16)

    def engine(decode_block: int = 1):
        return Engine(cfg, params, slots=4, max_len=1024,
                      decompose_engine=DecomposeEngine(ecfg), device="cuda",
                      decode_block=decode_block)

    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, n, dtype=np.int32)
               for n in SERVE_LENS]
    eng, done, launches, peak = serve_traffic(
        engine, prompts, profile, f"{tag}: profile of the serving run")
    st = eng.stats
    check_finished(done, cfg.vocab, tag)
    missing = [k for k in SERVE_KERNELS if launches[k] <= 0]
    if st.tail_folds <= 0 or missing:
        raise AssertionError(f"{tag}: folds {st.tail_folds}, kernels never "
                             f"launched {missing} ({launches})")
    print(f"{tag}: kv_width {cfg.kv_width}, {cfg.num_heads} query heads; "
          f"tokens={st.tokens_out} folds={st.tail_folds} prefill_batches="
          f"{st.prefill_batches} prefill_s={st.prefill_s:.4f} decode_s="
          f"{st.decode_s:.4f} decode_tok/s={st.decode_tok_s:.2f} "
          f"mean_ttft_ms={st.mean_ttft_s * 1e3:.2f} peak_mem_gib={peak:.2f}",
          flush=True)
    print(f"{tag}: launches " + json.dumps(launches), flush=True)
    tokens = {r.uid: r.out_tokens for r in done}
    del eng
    fused, ftok, flaunch, fpeak = serve_once(
        lambda: engine(FUSED_BLOCK), prompts, 32, profile,
        f"{tag}: profile of the fused serving run")
    check_fused(tag, fused, ftok, flaunch, tokens, launches)
    fused_line(f"{tag} fused", 32, st, fused, fpeak)
    del fused
    check_decode_routes(cfg, params, prompts, ecfg, tag=tag)
    torch.cuda.empty_cache()
    ms, bms = replayed_step_ms(engine, prompts)
    print(f"{tag}: replayed decode step {ms:.3f} ms (4 slots, block of "
          f"{FUSED_BLOCK}) vs bound {bms:.3f} ms (weights, the tied head "
          f"whole, and the decomposed cache read once)", flush=True)
    return launches


def activation_variant(cfg, params):
    """Phase 14's activation forward of ``cfg`` (starcoder2-7b): tokens
    [1, VARIANT_ACT_SEQ], phase 6's policy (10 layers, rank 20, 3 %
    outlier channels, threshold 3.0) through the kernels (biases as one
    extra rank of every projection, an ungated MLP: 4 Eq. 6 GEMMs a
    decomposed layer) against ``backend="reference"``, within phase 6's
    bf16 bar."""
    import numpy as np
    import torch
    from repro_torch.core.outlier import ThresholdTable
    from repro_torch.core.policy import (PAPER_BEST_CONFIG,
                                         PAPER_LAYER_CONFIGS,
                                         DecompositionPolicy)
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.kernels import ops
    from repro_torch.runtime.steps import make_decomposed_forward_step

    name, rank = PAPER_BEST_CONFIG
    policy = DecompositionPolicy.from_layer_list(
        cfg.num_layers, PAPER_LAYER_CONFIGS[name], rank=rank,
        outlier_frac=0.03)
    policy.thresholds = ThresholdTable(default=3.0)
    fwd = {b: make_decomposed_forward_step(cfg, DecomposeEngine(
        EngineConfig(policy=policy, attn_mode="dense", backend=b)))
        for b in ("cuda", "reference")}
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (1, VARIANT_ACT_SEQ))).long().cuda()
    per_layer = 3 + (2 if cfg.gated_mlp else 1)
    want = dict(ACT_LAUNCHES, lowrank_matmul=per_layer * len(
        PAPER_LAYER_CONFIGS[name]))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = {}
    ms = {}
    for b in ("cuda", "reference"):
        ms[b], _ = median_ms(lambda: out.__setitem__(
            b, fwd[b](params, tokens)), runs=1)
        if b == "cuda" and ops.launch_counts() != want:
            raise AssertionError(f"{cfg.name} decomposed forward launches "
                                 f"{ops.launch_counts()} != {want}")
    lk, lr_ = out["cuda"][..., :cfg.vocab], out["reference"][..., :cfg.vocab]
    rel = _rel(lk, lr_)
    argmax = (lk.argmax(-1) == lr_.argmax(-1)).float().mean().item()
    print(f"{cfg.name} activation: tokens [1, {VARIANT_ACT_SEQ}], layers "
          f"{PAPER_LAYER_CONFIGS[name]} rank {rank}: launches "
          f"{json.dumps({k: v for k, v in want.items() if v})}; kernel vs "
          f"reference route logits rel L2 {rel:.3e} (tol {ACT_LOGITS_TOL}),"
          f" argmax agreement {argmax:.4f}; forward ms (one run) via "
          f"kernels {ms['cuda']:.2f}, via plain versions "
          f"{ms['reference']:.2f}", flush=True)
    if not (torch.isfinite(lk).all() and rel <= ACT_LOGITS_TOL):
        raise AssertionError(f"{cfg.name} activation routes disagree: rel "
                             f"L2 {rel:.3e}")
    return want


# ---------------------------------------------------------------------------
# Phase 15: the VLM and audio families at full width and depth
# ---------------------------------------------------------------------------

MODAL_ARCHS = ("llama-3.2-vision-11b", "seamless-m4t-medium")


def serve_modal(cfg, params, profile: bool = False):
    """Phase 15 for one config: phase 4's traffic through its own family
    (zero image embeddings / frames, as the reference's engine feeds
    them; no port kernel on this path): every request finished, the
    admission cost counts the image tokens / frames, fused tokens equal
    single-step's (every block a replay), each request's staggered
    tokens equal its solo run's, the replayed step against its bound."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serving import Engine, Request

    tag = cfg.family

    def engine(decode_block: int = 1):
        return Engine(cfg, params, slots=4, max_len=1024, device="cuda",
                      decode_block=decode_block)

    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, n, dtype=np.int32)
               for n in SERVE_LENS]
    eng, done, launches, peak = serve_traffic(
        engine, prompts, profile, f"{tag}: profile of the serving run")
    st = eng.stats
    check_finished(done, cfg.vocab, tag)
    extra = cfg.num_image_tokens or cfg.num_audio_frames
    costs = [eng.family.prefill_cost(Request(uid=-1, prompt=p))
             for p in prompts]
    if any(launches.values()) or st.prefill_batches < 3 or \
            costs != [len(p) + extra for p in prompts]:
        raise AssertionError(f"{tag}: launches {launches}, "
                             f"{st.prefill_batches} prefills, admission "
                             f"costs {costs}")
    print(f"{tag}: {cfg.name} ({type(eng.family).__name__}) tokens="
          f"{st.tokens_out} prefill_batches={st.prefill_batches} "
          f"prefill_s={st.prefill_s:.4f} decode_s={st.decode_s:.4f} "
          f"decode_tok/s={st.decode_tok_s:.2f} mean_ttft_ms="
          f"{st.mean_ttft_s * 1e3:.2f} peak_mem_gib={peak:.2f}; admission "
          f"costs {costs} (prompt + {extra}); no port kernel launched",
          flush=True)
    tokens = {r.uid: r.out_tokens for r in done}
    del eng
    fused, ftok, flaunch, fpeak = serve_once(
        lambda: engine(FUSED_BLOCK), prompts, 32, profile,
        f"{tag}: profile of the fused serving run")
    check_fused(tag, fused, ftok, flaunch, tokens, launches)
    fused_line(f"{tag} fused", 32, st, fused, fpeak)
    del fused
    for i in range(len(prompts)):
        solo = {r.uid: r.out_tokens
                for r in drive(engine(), prompts, {0: [i]}, 32)}
        if solo[i] != tokens[i]:
            raise AssertionError(f"{tag}: request {i} staggered tokens "
                                 f"differ from its solo run's")
    print(f"{tag}: each request's staggered tokens equal its solo run's "
          f"(4 runs)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    ms, bms = replayed_step_ms(engine, prompts)
    print(f"{tag}: replayed decode step {ms:.3f} ms (4 slots, block of "
          f"{FUSED_BLOCK}) vs bound {bms:.3f} ms (weights but the embedding"
          f" table, the self and cross K/V read once); weights "
          f"{T.param_bytes(params) / 2 ** 30:.2f} GiB, peak_mem_gib="
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}", flush=True)


# ---------------------------------------------------------------------------
# Phase 16: observability and backend="auto" on llama2-7b
# ---------------------------------------------------------------------------

def _counts(snap) -> dict:
    """The counters of a ``repro.obs/v1`` snapshot (wall time and
    latencies apart, the latencies' counts kept)."""
    out = {k: v for k, v in snap.items()
           if isinstance(v, int) and not isinstance(v, bool)}
    out.update({k: snap[k]["count"] for k in ("ttft", "ttft_queue",
                                              "ttft_compute", "itl")})
    return out


def _pctl(snap) -> str:
    """p50/p95/p99 (ms) of the snapshot's TTFT, its split and ITL."""
    def q(block):
        return "/".join(f"{snap[block][k] * 1e3:.2f}"
                        for k in ("p50_s", "p95_s", "p99_s"))
    return (f"ttft_ms p50/p95/p99={q('ttft')} (queue {q('ttft_queue')}, "
            f"prefill {q('ttft_compute')}) itl_ms p50/p95/p99={q('itl')} "
            f"over {snap['blocks']} blocks")


def obs_pair(what: str, make, prompts) -> dict:
    """Phase 4's traffic through ``make(obs)`` four times in turns, with
    observability off, on (``Observability(trace=True)``), on, off; each
    engine is dropped before the next run starts, so no run serves beside
    another's cache and graphs.  Tokens, every counter of the snapshot
    and the launch counts equal in all four, every block a replay, a
    valid trace with the four lifecycle spans of each request.  Prints
    the quantiles and the runs' host wall (and wall without warm-up and
    capture).  Returns the last obs-on run's tokens, ``obs``, snapshot
    (with ``prefill_s``/``decode_s`` as extra keys) and graph counts, and
    the captures of all four runs."""
    from repro_torch.obs import Observability, engine_snapshot, \
        validate_trace
    runs = []
    for on in (False, True, True, False):
        obs = Observability(trace=True) if on else None
        t0 = time.perf_counter()
        eng, tokens, launches, _ = serve_once(lambda: make(obs), prompts, 32,
                                              title=f"obs {what}")
        wall = time.perf_counter() - t0
        g = eng.graphs
        if g.eager or not g.replays or g.replays != eng.stats.blocks:
            raise AssertionError(f"obs {what}: {g.eager} eager blocks, "
                                 f"{g.replays} replays for "
                                 f"{eng.stats.blocks} blocks")
        runs.append(dict(
            on=on, tokens=tokens, launches=launches, obs=eng.obs,
            snap=engine_snapshot(eng, prefill_s=eng.stats.prefill_s,
                                 decode_s=eng.stats.decode_s),
            graphs={"captures": g.captures, "replays": g.replays,
                    "eager": g.eager},
            wall=wall, capture_s=g.capture_s))
        del eng, g
    first = runs[0]
    for r in runs[1:]:
        if r["tokens"] != first["tokens"]:
            raise AssertionError(f"obs {what}: tokens differ (obs "
                                 f"{'on' if r['on'] else 'off'})")
        if _counts(r["snap"]) != _counts(first["snap"]) \
                or r["launches"] != first["launches"]:
            raise AssertionError(f"obs {what}: counters {_counts(r['snap'])}"
                                 f" vs {_counts(first['snap'])}, launches "
                                 f"{r['launches']} vs {first['launches']}")
    last = runs[2]
    obs = last["obs"]
    spans = validate_trace(obs.tracer.to_json())
    ev = obs.tracer.events
    per_req = [sum(e["name"] in ("request", "queue", "prefill", "decode")
                   and e["tid"] == obs.tracer._tids[f"req/{i}"] for e in ev)
               for i in range(len(prompts))]
    if per_req != [4] * len(prompts) or obs.tracer.dropped:
        raise AssertionError(f"obs {what}: lifecycle spans per request "
                             f"{per_req}, {obs.tracer.dropped} dropped")
    names = {}
    for e in ev:
        names[e["name"]] = names.get(e["name"], 0) + 1

    def walls(on):
        return ", ".join(f"{r['wall']:.3f} ({r['wall'] - r['capture_s']:.3f})"
                         for r in runs if r["on"] == on)
    print(f"obs {what}: tokens equal in turns off, on, on, off; counters "
          f"and launches equal ({json.dumps(first['launches'])}); every "
          f"block a replay ({last['graphs']['replays']} replays, "
          f"{last['graphs']['captures']} captures); {_pctl(last['snap'])}; "
          f"trace {spans} spans, events {json.dumps(names, sort_keys=True)}"
          f"; host wall s (without warm-up and capture) obs off "
          f"{walls(False)}, on {walls(True)}", flush=True)
    return dict(last, captures=sum(r["graphs"]["captures"] for r in runs))


def phase_obs(cfg, params, slot_tokens=None, nvcc_built: int = 0):
    """Phase 16: observability (``repro_torch.obs``) and
    ``backend="auto"`` on llama2-7b, phase 4's traffic at full width
    (rank 64, tail 16, ``decode_block=8``): (a) slab, sync and (b) paged,
    async ``"ready"`` engines with obs off, on, on, off (tokens, snapshot
    counters and launches equal, every block a replay, a valid trace;
    (b) with ticket, splice and drain-pool spans; (b)'s tokens against
    (a)'s are printed, not held: a ready ticket splices a round later, and
    the co-folds move with it); (c) the
    Prometheus text and the JSON snapshots written through ``ioutil`` and
    read back; (d) the graph counters in the exposition equal
    ``BlockGraphs``', the compile watch counts the phase's captures under
    ``decode`` and the run's nvcc builds; (e) ``tune_backend`` at phase
    4's re-orth shape, ``resolve_backend`` gives its winner, and an
    ``EngineConfig(backend="auto")`` engine serves the pinned winner's
    tokens."""
    import numpy as np
    from repro_torch import tune
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.ioutil import atomic_write_json
    from repro_torch.obs import (GLOBAL, compile_stats, parse_prometheus,
                                 write_json_snapshot, write_prometheus)
    from repro_torch.serving import Engine

    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, n, dtype=np.int32)
               for n in SERVE_LENS]
    graph_base = compile_stats(kind="cuda_graph").get(
        "decode", {"compiles": 0})["compiles"]

    def engine(obs, paged=False, backend="cuda", **kw):
        ecfg = EngineConfig(kv_rank=64, kv_tail=16, kv_page=16,
                            backend=backend)
        return Engine(cfg, params, slots=4, max_len=1024, device="cuda",
                      paged=paged, decompose_engine=DecomposeEngine(ecfg),
                      decode_block=FUSED_BLOCK, obs=obs, **kw)

    a = obs_pair("(a) slab sync", engine, prompts)
    b = obs_pair("(b) paged async ready", lambda obs: engine(
        obs, paged=True, prefill_async=True, ready_order="ready"), prompts)
    captures = a["captures"] + b["captures"]
    # a ready ticket splices at the next step boundary, a round after a
    # sync engine admits; with blocks cut at the arrivals the co-folds
    # then fall at other rounds, so (b)'s tokens need not be (a)'s
    a_tokens, sa, sb = a["tokens"], a["snap"], b["snap"]
    same = sum(b["tokens"][i] == a_tokens[i] for i in a_tokens)
    print(f"obs (b): {same} of {len(a_tokens)} requests' tokens equal to "
          f"(a)'s; folds {sb['tail_folds']} vs (a) {sa['tail_folds']}, "
          f"blocks {sb['blocks']} vs {sa['blocks']}, in flight peak "
          f"{sb['prefill_inflight_peak']}", flush=True)
    missing = {"ticket", "splice", "drain-pool"} - {
        e["name"] for e in b["obs"].tracer.events}
    if missing:
        raise AssertionError(f"obs (b): no {sorted(missing)} spans")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as d:
        prom = os.path.join(d, "metrics.prom")
        write_prometheus(prom, a["obs"].registry, GLOBAL)
        write_json_snapshot(os.path.join(d, "metrics.json"),
                            a["obs"].registry, GLOBAL)
        atomic_write_json(os.path.join(d, "snapshot.json"), sa)
        with open(prom) as fh:
            parsed = parse_prometheus(fh.read())
        with open(os.path.join(d, "metrics.json")) as fh:
            reg = json.load(fh)
        with open(os.path.join(d, "snapshot.json")) as fh:
            snap = json.load(fh)
        files = sorted(os.listdir(d))
    if snap["schema"] != "repro.obs/v1" or "p99" not in \
            reg["serving_itl_seconds"][0] or files != [
                "metrics.json", "metrics.prom", "snapshot.json"]:
        raise AssertionError(f"obs (c): snapshot {snap.get('schema')}, "
                             f"files {files}")
    exported = {k: parsed[f"repro_serving_graph_{k}"][0][1]
                for k in ("captures", "replays", "eager")}
    if exported != a["graphs"] or snap != json.loads(json.dumps(sa)):
        raise AssertionError(f"obs (d): exported {exported} != graphs "
                             f"{a['graphs']}, or the snapshot changed")
    print(f"obs (c): metrics.prom ({sum(len(v) for v in parsed.values())} "
          f"samples, strict parse), metrics.json and snapshot.json "
          f"(schema {snap['schema']}) written through ioutil and read "
          f"back", flush=True)

    # (e) backend selection at phase 4's re-orth shape
    res = tune.tune_backend(REORTH_TUNE, "float32", reps=10, device="cuda")
    winner = res.best["backend"]
    if tune.resolve_backend() != winner:
        raise AssertionError(f"obs (e): resolve_backend() "
                             f"{tune.resolve_backend()} != {winner}")
    print(f"obs (e): tune_backend {list(REORTH_TUNE)} float32: "
          + " ".join(f"{best['backend']} {meas * 1e3:.4f} ms "
                     f"(f={best['expansion']})"
                     for best, _, meas in res.table)
          + f"; winner {winner}", flush=True)
    auto, a_toks, _, _ = serve_once(lambda: engine(None, backend="auto"),
                                    prompts, 32, title="obs auto")
    resolved = auto.dengine.resolved_backend
    captures += auto.graphs.captures
    del auto
    pinned, p_toks, _, _ = serve_once(lambda: engine(None, backend=winner),
                                      prompts, 32, title="obs pinned")
    captures += pinned.graphs.captures
    del pinned
    if resolved != winner or a_toks != p_toks:
        raise AssertionError(f"obs (e): auto resolved {resolved} (winner "
                             f"{winner}); tokens equal {a_toks == p_toks}")
    if winner == "cuda" and p_toks != a_tokens:
        raise AssertionError("obs (e): the pinned cuda engine's tokens "
                             "differ from (a)'s")
    print(f"obs (e): EngineConfig(backend='auto') resolved {resolved}; "
          f"tokens equal to the engine pinned to {winner}", flush=True)

    graphs = compile_stats(kind="cuda_graph")
    nvcc = compile_stats(kind="nvcc")
    got = graphs.get("decode", {"compiles": 0})["compiles"] - graph_base
    built = sum(v["compiles"] for v in nvcc.values())
    if got != captures or built != nvcc_built:
        raise AssertionError(f"obs (d): compile watch: {got} captures "
                             f"under decode for {captures}; {built} nvcc "
                             f"builds for {nvcc_built}")
    print(f"obs (d): graph counters in the exposition equal BlockGraphs' "
          f"({exported}); compile watch: cuda_graph "
          f"{json.dumps(graphs, sort_keys=True)}, nvcc "
          f"{json.dumps(nvcc, sort_keys=True)} (this phase's captures "
          f"{captures} under decode)", flush=True)
    if slot_tokens is not None and a_tokens != slot_tokens:
        raise AssertionError("obs (a): tokens differ from phase 4's")


# ---------------------------------------------------------------------------
# Phase 17: training
# ---------------------------------------------------------------------------

TRAIN_ARCH = "granite-3-2b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 5
TRAIN_LOSS_TOL = 1e-3    # relative, kernel route vs reference route
TRAIN_PEAK_GIB = 70.0
RESTART_TOL = 1e-6       # relative, restarted vs uninterrupted losses


def _train_batches(cfg, n: int):
    """Batches 0..n-1 of ``SyntheticLM(seed=0)`` at 4 × 512, on the card."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.runtime.driver import to_device
    src = SyntheticLM(cfg, ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH,
                                     "train"), DataConfig(seed=0))
    return [to_device(src.batch_at(i), "cuda") for i in range(n)]


def _n_params(params) -> int:
    from repro_torch.tree import leaves
    return sum(t.numel() for t in leaves(params))


def train_granite() -> dict:
    """(a) granite-3-2b at full width and depth: 5 AdamW steps of
    make_train_step (remat full), then one PowerSGD round trip of the
    last gradient.  Returns what phase 21 (b) holds the dry-run against:
    the bytes the parameters and AdamW's state took on the card
    (``state_bytes``), the median step (``step_ms``) and the peak above
    what the card held before (``peak_bytes``)."""
    import torch
    from repro_torch import optim
    from repro_torch.configs import get_arch
    from repro_torch.distributed import compression as comp
    from repro_torch.runtime import steps
    from repro_torch.tree import named_leaves
    cfg = get_arch(TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    params = init_weights(cfg)
    n = _n_params(params)
    opt = optim.make_optimizer(cfg, warmup=1)
    kept = {}

    def keep_last(grads):
        if kept.get("on"):
            kept["grads"] = grads
        return grads
    step = steps.make_train_step(cfg, opt, grad_transform=keep_last)
    state = opt.init(params)
    state_bytes = torch.cuda.memory_allocated() - held
    batches = _train_batches(cfg, TRAIN_STEPS)
    losses, norms, ms = [], [], []
    for i, batch in enumerate(batches):
        kept["on"] = i == TRAIN_STEPS - 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        loss, gn = m["loss"].item(), m["grad_norm"].item()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        norms.append(gn)
        print(f"train (a): {cfg.name} step {i} loss {loss:.6f} grad_norm "
              f"{gn:.6f} {ms[-1]:.1f} ms", flush=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops_ms = 8 * n * tokens / rates().PEAK_FLOPS["bfloat16"] * 1e3
    bytes_ms = 22 * n / rates().HBM_BW * 1e3
    med = statistics.median(ms[1:])
    print(f"train (a): {cfg.name} {cfg.num_layers} layers, {n / 1e9:.3f} B "
          f"parameters, batch {TRAIN_BATCH} x {TRAIN_SEQ}, AdamW, remat "
          f"{cfg.remat_policy}: median step {med:.1f} ms (steps 2-5: "
          f"{', '.join(f'{x:.1f}' for x in ms[1:])}); bound 8*N*T / 989 "
          f"TFLOP/s + 22 B*N / 3.35 TB/s = {flops_ms:.1f} + {bytes_ms:.1f} = "
          f"{flops_ms + bytes_ms:.1f} ms ({(flops_ms + bytes_ms) / med:.3f} "
          f"of the step); peak {peak:.2f} GiB", flush=True)
    if not all(math.isfinite(v) for v in losses + norms):
        raise AssertionError(f"train (a): non-finite loss or norm {losses} "
                             f"{norms}")
    if peak >= TRAIN_PEAK_GIB:
        raise AssertionError(f"train (a): peak {peak:.2f} GiB >= "
                             f"{TRAIN_PEAK_GIB}")
    grads = kept.pop("grads")
    del state, batches
    pc = comp.PowerSGDConfig(rank=4)
    pstate = comp.init_state(grads, pc)
    out, pstate = comp.compress_decompress(grads, pstate, pc)    # warm
    del out
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out, pstate = comp.compress_decompress(grads, pstate, pc)
    end.record()
    torch.cuda.synchronize()
    sent = dense = 0
    for name, g in named_leaves(grads):
        dense += g.numel()
        st = pstate
        for k in name.split("/"):
            st = st[k]
        sent += g.numel() if st["q"] is None else \
            pc.rank * (st["q"].shape[0] + g.numel() // st["q"].shape[0])
    ratio, want = dense / sent, comp.compression_ratio(params, pc)
    finite = all(torch.isfinite(t).all() for _, t in named_leaves(out))
    print(f"train (a): PowerSGD rank {pc.rank} of the last gradient: "
          f"{start.elapsed_time(end):.3f} ms, ratio {ratio:.3f} "
          f"(compression_ratio {want:.3f})", flush=True)
    if ratio != want or not finite:
        raise AssertionError(f"train (a): PowerSGD ratio {ratio} != {want} "
                             f"or a non-finite round trip")
    return {"state_bytes": state_bytes, "step_ms": med,
            "peak_bytes": peak * 2 ** 30 - held}


def train_mamba2(profile: bool = False) -> dict:
    """(b) mamba2-780m at full width and depth: the same traffic through
    the CUDA kernels and through backend="reference" from the same
    weights, step by step in turns.  Returns the kernel route's launch
    counts over its 5 steps.  ``profile``: afterwards, one more
    kernel-route step (batch 0 again) under the profiler."""
    import torch
    from repro_torch import optim
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.runtime import steps
    from repro_torch.tree import tree_map
    cfg = get_arch(MAMBA_ARCH)
    params = init_weights(cfg)
    runs = {}
    for backend in ("cuda", "reference"):
        p = params if backend == "cuda" else tree_map(torch.clone, params)
        opt = optim.make_optimizer(cfg, warmup=1)
        runs[backend] = dict(p=p, opt=opt, st=opt.init(p), losses=[],
                             norms=[], ms=[],
                             step=steps.make_train_step(cfg, opt,
                                                        backend=backend))
    del params, p
    total = {}
    for i, batch in enumerate(_train_batches(cfg, TRAIN_STEPS)):
        for backend, r in runs.items():
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r["p"], r["st"], m = r["step"](r["p"], r["st"], batch)
            r["losses"].append(m["loss"].item())
            r["norms"].append(m["grad_norm"].item())
            torch.cuda.synchronize()
            r["ms"].append((time.perf_counter() - t0) * 1e3)
            counts = ops.launch_counts()
            if backend == "cuda":
                for k, v in counts.items():
                    total[k] = total.get(k, 0) + v
                print(f"train (b): step {i} kernel route: SSD forward "
                      f"{counts['ssd_chunk_intra']}, backward "
                      f"{counts['ssd_chunk_intra_bwd']} launches", flush=True)
            elif any(counts.values()):
                raise AssertionError(f"train (b): the reference route "
                                     f"launched {counts}")
        k, ref = runs["cuda"], runs["reference"]
        rel = abs(k["losses"][-1] - ref["losses"][-1]) / abs(
            ref["losses"][-1])
        print(f"train (b): step {i} loss kernel {k['losses'][-1]:.6f} "
              f"reference {ref['losses'][-1]:.6f} (rel {rel:.2e}); grad_norm "
              f"{k['norms'][-1]:.6f} / {ref['norms'][-1]:.6f}; "
              f"{k['ms'][-1]:.1f} / {ref['ms'][-1]:.1f} ms", flush=True)
        if not rel <= TRAIN_LOSS_TOL:
            raise AssertionError(f"train (b): step {i} losses differ by "
                                 f"{rel:.2e} > {TRAIN_LOSS_TOL}")
    k, ref = runs["cuda"], runs["reference"]
    rel_n = abs(k["norms"][0] - ref["norms"][0]) / ref["norms"][0]
    print(f"train (b): {cfg.name} step-0 grad_norm rel {rel_n:.2e}; median "
          f"step {statistics.median(k['ms'][1:]):.1f} ms kernel route, "
          f"{statistics.median(ref['ms'][1:]):.1f} ms reference route; "
          f"launches over {TRAIN_STEPS} steps: SSD forward "
          f"{total['ssd_chunk_intra']}, backward "
          f"{total['ssd_chunk_intra_bwd']}", flush=True)
    if not rel_n <= TRAIN_LOSS_TOL or total["ssd_chunk_intra_bwd"] <= 0:
        raise AssertionError(f"train (b): step-0 grad_norm rel {rel_n:.2e} "
                             f"or no backward launch ({total})")
    if profile:
        k = runs["cuda"]
        batch = _train_batches(cfg, 1)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profiled(True, f"profile: {cfg.name} train step (kernel "
                            f"route, after {TRAIN_STEPS} steps)"):
            k["p"], k["st"], _ = k["step"](k["p"], k["st"], batch)
        print(f"profile: the profiled step took "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
    return total


def train_restart() -> None:
    """(c) the driver on mamba2-780m at depth 2, full width: 6 steps, a
    checkpoint every 2 (keep 1), a failure at step 3; the losses after
    the restart against an uninterrupted run's."""
    import torch
    from repro_torch import optim
    from repro_torch.configs import ShapeSpec, get_arch
    from repro_torch.runtime.driver import SimulatedFailure, train_loop
    cfg = get_arch(MAMBA_ARCH).replace(num_layers=2)
    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    crashed = {"done": False}

    def fail_at_3(step):
        if step == 3 and not crashed["done"]:
            crashed["done"] = True
            raise SimulatedFailure("injected at step 3")
    res = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        for name, hook in (("plain", None), ("crash", fail_at_3)):
            t0 = time.perf_counter()
            res[name] = train_loop(
                cfg, shape, total_steps=6, ckpt_dir=os.path.join(tmp, name),
                ckpt_every=2, keep=1, seed=0, failure_hook=hook,
                print_fn=lambda line: None, device="cuda",
                optimizer=optim.make_optimizer(cfg, warmup=1))
            torch.cuda.synchronize()
            r = res[name]
            print(f"train (c): {name}: {len(r.losses)} losses, restarts "
                  f"{r.restarts}, {r.ckpt_bytes} checkpoint bytes written, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    plain, crash = res["plain"].losses, res["crash"].losses
    after = crash[3:]
    rel = max(abs(a - b) / abs(b) for a, b in zip(after, plain[2:]))
    print(f"train (c): losses after the restart {after} vs uninterrupted "
          f"{plain[2:]}: max rel {rel:.2e}, bit-equal {after == plain[2:]}",
          flush=True)
    if res["crash"].restarts != 1 or len(after) != 4 or not rel <= \
            RESTART_TOL:
        raise AssertionError(f"train (c): restart losses {after} != "
                             f"{plain[2:]} (rel {rel:.2e})")


# ---------------------------------------------------------------------------
# Phase 18: the "data" axis at world 1
# ---------------------------------------------------------------------------

MESH_TRAIN_STEPS = 3
MESH_TRAIN_TOL = 1e-6        # relative, DP steps vs the same steps unmeshed
MESH_GATED = REORTH + ("dkv_attention_stats", "dkv_attention_stats_paged")


def _mesh():
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(1, 1, "cuda")


def check_collectives(what: str, counts: dict, blocks) -> None:
    """A serving run's counted collectives: none without a mesh
    (``blocks`` None); on the mesh one all-gather of the sampled tokens
    per decode launch, all-gathers of the admissions' factors (u, core,
    vt a decomposition), and nothing else."""
    if blocks is None:
        bad = bool(counts)
    else:
        tok = counts.get("all_gather/tokens", (0, 0))[0]
        fac = counts.get("all_gather/factors", (0, 0))[0]
        bad = tok != blocks or not fac or fac % 3 or set(counts) - {
            "all_gather/tokens", "all_gather/factors"}
    if bad:
        raise AssertionError(f"{what}: collectives {counts} (decode "
                             f"launches {blocks})")


def mesh_serving(cfg, params) -> None:
    """Phase 18 (a) and (b) on the loaded llama2-7b weights."""
    import numpy as np
    import torch
    from repro_torch.distributed import sharding as sh
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.serving import Engine, Request
    mesh = _mesh()
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, n, dtype=np.int32)
               for n in SERVE_LENS]

    def engine(on: bool, block: int = 1, paged: bool = False):
        ecfg = EngineConfig(kv_rank=64, kv_tail=16, kv_page=16,
                            mesh=mesh if on else None)
        return lambda: Engine(cfg, params, slots=4, max_len=1024,
                              decompose_engine=DecomposeEngine(ecfg),
                              device="cuda", decode_block=block, paged=paged)
    # a throwaway fused mesh engine: library handles, the allocator and
    # the capture stream, so neither side of an A/B pays for them
    warm = engine(True, FUSED_BLOCK)()
    warm.submit(Request(uid=-1, prompt=prompts[3][:64], max_new_tokens=20))
    warm.run()
    del warm
    for what, block, paged, order in (
            ("slab", 1, False, (False, True, True, False)),
            ("slab fused", FUSED_BLOCK, False, (False, True)),
            ("paged", 1, True, (False, True))):
        runs = {False: [], True: []}
        for on in order:
            sh.reset_collective_counts()
            eng, toks, launches, peak = serve_once(
                engine(on, block, paged), prompts, 32,
                title=f"mesh (a) {what}")
            st = eng.stats
            runs[on].append((toks, launches, st.decode_tok_s,
                             st.decode_steps, st.blocks, peak,
                             sh.collective_counts()))
            check_collectives(f"mesh (a) {what}", runs[on][-1][6],
                              st.blocks if on else None)
            if paged:
                check_pages_back(eng, f"mesh (a) {what}")
            if on and not (eng.shard.sharded and eng.shard.n == 4):
                raise AssertionError(f"mesh (a) {what}: the slots are not "
                                     f"held as a sharded block "
                                     f"({eng.shard})")
            del eng
        base, meshed = runs[False][0], runs[True][0]
        for r in runs[True] + runs[False]:
            if r[0] != base[0]:
                raise AssertionError(f"mesh (a) {what}: tokens differ from "
                                     f"the no-mesh run's")
            got = {k: r[1][k] for k in MESH_GATED}
            want = {k: base[1][k] for k in MESH_GATED}
            if got != want:
                raise AssertionError(f"mesh (a) {what}: launches {got} != "
                                     f"no-mesh {want}")
        print(f"mesh (a) {what}: tokens and launches ("
              f"{json.dumps({k: meshed[1][k] for k in MESH_GATED})}) equal "
              f"to no mesh; decode_tok/s mesh "
              f"{', '.join(f'{r[2]:.2f}' for r in runs[True])} vs no mesh "
              f"{', '.join(f'{r[2]:.2f}' for r in runs[False])}; "
              f"collectives issued (op/payload: [calls, bytes sent]) "
              f"{json.dumps(meshed[6])} for {meshed[4]} decode launches of "
              f"{meshed[3]} steps; peak_mem_gib {meshed[5]:.2f} vs "
              f"{base[5]:.2f}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(*REORTH_TUNE, device="cuda", generator=gen)
    outs, ms = {}, {}
    sh.reset_collective_counts()
    for on in (False, True, True, False):
        de = DecomposeEngine(EngineConfig(mesh=mesh if on else None))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = de.decompose_kv(x, 64)
        torch.cuda.synchronize()
        ms.setdefault(on, []).append((time.perf_counter() - t0) * 1e3)
        outs.setdefault(on, got)
    same = all(torch.equal(a, b) for a, b in zip(outs[False], outs[True]))
    counts = sh.collective_counts()
    if set(counts) != {"all_gather/factors"} or \
            counts["all_gather/factors"][0] != 2 * 3:
        raise AssertionError(f"mesh (b): collectives {counts} != three "
                             f"all-gathers a sharded decomposition")
    print(f"mesh (b): decompose_kv {list(REORTH_TUNE)} float32 rank 64 on "
          f"the mesh bit-equal to no mesh: {same}; collectives of the two "
          f"mesh calls {json.dumps(counts)}; ms mesh "
          f"{', '.join(f'{v:.1f}' for v in ms[True])} vs no mesh "
          f"{', '.join(f'{v:.1f}' for v in ms[False])}", flush=True)
    if not same:
        raise AssertionError("mesh (b): the sharded decomposition is not "
                             "bit-equal to the unsharded one")


def mesh_training() -> None:
    """Phase 18 (c): DP train steps with PowerSGD's all-reduces against
    the same steps without a mesh; then plain DP steps resumed from the
    elastic restore of their checkpoint against the uninterrupted ones;
    destroys the process group."""
    import torch
    from repro_torch import checkpoint, optim
    from repro_torch.configs import get_arch
    from repro_torch.distributed import compression as comp
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import shutdown_distributed
    from repro_torch.runtime import driver, steps
    from repro_torch.tree import named_leaves
    mesh = _mesh()
    cfg = get_arch(MAMBA_ARCH).replace(num_layers=2)
    pc = comp.PowerSGDConfig(rank=4)
    batches = _train_batches(cfg, MESH_TRAIN_STEPS)

    def train(params, state, opt, on, tr, batches):
        step = steps.make_train_step(cfg, opt, grad_transform=tr,
                                     mesh=mesh if on else None)
        losses, ms = [], []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            losses.append(m["loss"].item())
            ms.append((time.perf_counter() - t0) * 1e3)
        return losses, ms, params, state

    runs = {}
    for on in (False, True):
        params = init_weights(cfg)
        opt = optim.make_optimizer(cfg, warmup=1)
        tr = comp.PowerSGD(params, pc,
                           group=sh.dp_group(mesh) if on else None)
        ops.reset_launch_counts()
        sh.reset_collective_counts()
        losses, ms, _, _ = train(params, opt.init(params), opt, on, tr,
                                 batches)
        counts = ops.launch_counts()
        runs[on] = (losses, ms, sh.collective_counts(),
                    {k: counts[k] for k in ("ssd_chunk_intra",
                                            "ssd_chunk_intra_bwd")})
        del params, tr
    a, b = runs[False][0], runs[True][0]
    rel = max(abs(x - y) / abs(x) for x, y in zip(a, b))
    print(f"mesh (c): {cfg.name} depth 2, {MESH_TRAIN_STEPS} steps with "
          f"PowerSGD rank {pc.rank}: losses mesh {b} vs no mesh {a}, max rel "
          f"{rel:.2e}, bit-equal {a == b}; step ms mesh "
          f"{', '.join(f'{v:.1f}' for v in runs[True][1])} vs no mesh "
          f"{', '.join(f'{v:.1f}' for v in runs[False][1])}; SSD launches "
          f"mesh {json.dumps(runs[True][3])} vs no mesh "
          f"{json.dumps(runs[False][3])}; collectives of the mesh steps "
          f"{json.dumps(runs[True][2])}", flush=True)
    per_step = {k: n // MESH_TRAIN_STEPS for k, (n, _) in
                runs[True][2].items()}
    if not rel <= MESH_TRAIN_TOL or runs[True][3] != runs[False][3] \
            or not runs[True][3]["ssd_chunk_intra_bwd"] or runs[False][2] \
            or per_step.get("all_reduce/loss") != 1 \
            or not per_step.get("all_reduce/powersgd_q"):
        raise AssertionError(f"mesh (c): DP losses differ by {rel:.2e}, "
                             f"or SSD launches {runs[True][3]} != "
                             f"{runs[False][3]}, or collectives "
                             f"{runs[True][2]} / {runs[False][2]}")
    del runs

    # one plain DP step, its checkpoint, restore_for_mesh, unshard, the
    # other steps: the uninterrupted steps' losses and parameters
    opt = optim.make_optimizer(cfg, warmup=1)

    def fresh():
        params = init_weights(cfg)
        return params, opt.init(params)
    whole = train(*fresh(), opt, True, None, batches)
    first = train(*fresh(), opt, True, None, batches[:1])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        state = {"params": first[2], "opt": first[3]}
        checkpoint.save(state, tmp, 1)
        saved = dict(named_leaves(state))
        back = driver.restore_for_mesh(cfg, tmp, mesh, optimizer=opt)
    n, equal, n_saved = 0, True, len(saved)
    for name, leaf in named_leaves(back):
        n += 1
        equal &= torch.equal(leaf.full_tensor(), saved[name])
    del first, state, saved
    st = driver.unshard(back)
    del back
    rest = train(st["params"], st["opt"], opt, True, None, batches[1:])
    got = whole[0][:1] + rest[0]
    lrel = max(abs(x - y) / abs(x) for x, y in zip(whole[0], got))
    want = dict(named_leaves(whole[2]))
    prel = max(float((t.float() - want[k].float()).abs().max() /
                     want[k].float().abs().max().clamp(min=1e-30))
               for k, t in named_leaves(rest[2]))
    print(f"mesh (c): restore_for_mesh of the DP run's step-1 checkpoint: "
          f"{n} leaves (DTensors on the 1x1 mesh), every leaf equal: "
          f"{equal}; resumed through driver.unshard, steps 2-"
          f"{MESH_TRAIN_STEPS} losses {rest[0]} vs uninterrupted "
          f"{whole[0][1:]}: max rel {lrel:.2e}, params max rel {prel:.2e}, "
          f"bit-equal {got == whole[0] and prel == 0}", flush=True)
    if not equal or n != n_saved or not lrel <= MESH_TRAIN_TOL \
            or not prel <= MESH_TRAIN_TOL:
        raise AssertionError("mesh (c): the restored state differs, or the "
                             "resumed steps differ from the uninterrupted")
    del whole, rest, st, want
    shutdown_distributed()


MODEL_TRAIN_LAYERS = 4          # phase 19 (b, c): granite-3-2b's depth cut
MODEL_TRAIN_STEPS = 3


def _one_decode_step_collectives(eng, prompt) -> dict:
    """The collectives of one decode step of a finished ``eng`` with one
    live request (admitted and decoding first), counted where issued."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.serving import Request
    eng.submit(Request(uid=-2, prompt=prompt, max_new_tokens=4))
    while not eng._decoding():
        eng.step()
    eng.step()                          # the admission round's decode
    sh.reset_collective_counts()
    before = eng.stats.decode_steps
    eng.step()
    if eng.stats.decode_steps != before + 1:
        raise AssertionError("model (a): the counted step was not one "
                             "decode step")
    return sh.collective_counts()


def model_axis_serving(cfg, params) -> None:
    """Phase 19 (a): phase 4's traffic on full-width llama2-7b decomposed
    KV, with no mesh and with a (1, 1) mesh (the model's one body under
    ``distributed.tp.use``, whose helpers are the identity on a "model"
    axis of 1); tokens and launch counts must be equal, and no
    model-axis collective issued."""
    import numpy as np
    from repro_torch.distributed import sharding as sh
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.serving import Engine
    mesh = _mesh()
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, n, dtype=np.int32)
               for n in SERVE_LENS]

    def engine(on: bool):
        ecfg = EngineConfig(kv_rank=64, kv_tail=16,
                            mesh=mesh if on else None)
        return lambda: Engine(cfg, params, slots=4, max_len=1024,
                              decompose_engine=DecomposeEngine(ecfg),
                              device="cuda")
    runs = {False: [], True: []}
    step_counts = None
    for on in (False, True, True, False):
        sh.reset_collective_counts()
        eng, toks, launches, peak = serve_once(engine(on), prompts, 32,
                                               title="model (a)")
        st = eng.stats
        runs[on].append((toks, launches, st.decode_tok_s, st.decode_steps,
                         sh.collective_counts(), peak))
        if on and step_counts is None:
            step_counts = _one_decode_step_collectives(eng, prompts[3][:64])
        del eng
    base = runs[False][0]
    for r in runs[True] + runs[False]:
        got = {k: r[1][k] for k in MESH_GATED}
        want = {k: base[1][k] for k in MESH_GATED}
        if r[0] != base[0] or got != want:
            raise AssertionError(f"model (a): tokens or launches {got} "
                                 f"differ from no mesh's {want}")
    meshed = runs[True][0]
    model_axis = {"all_reduce/tp_out", "all_gather/logits", "all_reduce/"
                  "embed", "all_gather/prefill_kv", "all_gather/k_vt"}
    if runs[False][0][4] or model_axis & set(meshed[4]):
        raise AssertionError(f"model (a): collectives {meshed[4]} (no "
                             f"mesh: {runs[False][0][4]})")
    print(f"model (a): llama2-7b dkv on a (1, 1) mesh, the model's one "
          f"body with no model-axis collective: tokens and launches "
          f"({json.dumps({k: meshed[1][k] for k in MESH_GATED})}) equal to "
          f"no mesh; decode_tok/s (1, 1) "
          f"{', '.join(f'{r[2]:.2f}' for r in runs[True])} vs no mesh "
          f"{', '.join(f'{r[2]:.2f}' for r in runs[False])}; collectives "
          f"of the run (op/payload: [calls, bytes sent]) "
          f"{json.dumps(meshed[4])} for {meshed[3]} decode steps; one "
          f"decode step of 4 slots: {json.dumps(step_counts)}; peak_mem_gib "
          f"{meshed[5]:.2f} vs {base[5]:.2f}", flush=True)


def model_axis_training(arch: str = TRAIN_ARCH, tags=("b", "c")) -> None:
    """Phase 19 (b, c): granite-3-2b at full width (depth cut to
    ``MODEL_TRAIN_LAYERS``), three AdamW steps with no mesh and with
    ZeRO-1 on a (1, 1) mesh (losses bit-equal, and the kernels' launch
    counts equal);
    the mesh run's state after its first step saved whole
    (``driver.save_for_mesh``), ``restore_for_mesh``'d and fed to the
    step as it is, two more steps: the uninterrupted losses.  Phase 19
    (e) is the same on ``mamba2-780m`` (``arch``, ``tags``), whose steps
    run the SSD kernels forward and backward."""
    import torch
    from repro_torch import optim
    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.runtime import driver, steps
    mesh = _mesh()
    t1, t2 = tags
    cfg = get_arch(arch).replace(num_layers=MODEL_TRAIN_LAYERS)
    batches = _train_batches(cfg, MODEL_TRAIN_STEPS)
    on = dict(zero1=True)
    runs, step_counts, launches = {}, None, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_model_") as tmp:
        for tp in (False, True):
            params = init_weights(cfg)
            opt = optim.make_optimizer(cfg, warmup=1)
            state = opt.init(params)
            kw = dict(on, optimizer=opt) if tp else {}
            if tp:
                params, state = steps.shard_train_state(
                    cfg, params, state, mesh, **kw)
            fn = steps.make_train_step(cfg, opt, mesh=mesh if tp else None,
                                       **({} if not tp else on))
            losses, ms = [], []
            ops.reset_launch_counts()
            for i, batch in enumerate(batches):
                sh.reset_collective_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, state, m = fn(params, state, batch)
                losses.append(m["loss"].item())
                ms.append((time.perf_counter() - t0) * 1e3)
                if tp and i == len(batches) - 1:
                    step_counts = sh.collective_counts()
                if tp and i == 0:
                    driver.save_for_mesh(cfg, {"params": params,
                                               "opt": state}, tmp, 1, mesh,
                                         **kw)
            runs[tp] = (losses, ms)
            launches[tp] = {k: v for k, v in ops.launch_counts().items()
                            if v}
            del params, state
        a, b = runs[False][0], runs[True][0]
        print(f"model ({t1}): {cfg.name} full width, depth "
              f"{MODEL_TRAIN_LAYERS}, {MODEL_TRAIN_STEPS} AdamW steps with "
              f"ZeRO-1 on a (1, 1) mesh: losses {b} vs no mesh {a}, "
              f"bit-equal {a == b}; kernel launches {launches[True]} vs "
              f"no mesh {launches[False]}; step ms ZeRO-1 "
              f"{', '.join(f'{v:.1f}' for v in runs[True][1])} vs no mesh "
              f"{', '.join(f'{v:.1f}' for v in runs[False][1])}; "
              f"collectives of one step {json.dumps(step_counts)}",
              flush=True)
        if a != b or launches[True] != launches[False]:
            raise AssertionError(f"model ({t1}): ZeRO-1 losses {b} or "
                                 f"launches {launches[True]} are not those "
                                 f"of no mesh ({a}, {launches[False]})")
        opt = optim.make_optimizer(cfg, warmup=1)
        back = driver.restore_for_mesh(cfg, tmp, mesh, optimizer=opt)
        fn = steps.make_train_step(cfg, opt, mesh=mesh, **on)
        resumed = []
        params, state = back["params"], back["opt"]
        for batch in batches[1:]:
            params, state, m = fn(params, state, batch)
            resumed.append(m["loss"].item())
        del params, state, back
    rel = max(abs(x - y) / abs(y) for x, y in zip(resumed, b[1:]))
    print(f"model ({t2}): {cfg.name} restore_for_mesh of the ZeRO-1 "
          f"step-1 checkpoint fed to the step as DTensors (no unshard): "
          f"losses {resumed} vs uninterrupted {b[1:]}, max rel {rel:.2e}, "
          f"bit-equal {resumed == b[1:]}; phase 19 ran at (1, 1) only (one "
          f"card: M > 1 is the four-card NCCL tests)", flush=True)
    if not rel <= MESH_TRAIN_TOL:
        raise AssertionError(f"model ({t2}): resumed losses differ by "
                             f"{rel}")


#: phase 19 (d): each family's depth cut at full width (zamba2-1.2b keeps
#: one group of 5 Mamba2 blocks and its shared attention block; the VLM
#: one group of 4 self blocks and a cross block)
MODEL_FAMILY_CUTS = {
    MAMBA_ARCH: dict(num_layers=4),
    HYBRID_ARCH: dict(num_layers=6),
    "llama-3.2-vision-11b": dict(num_layers=5),
    "seamless-m4t-medium": dict(num_layers=4, enc_layers=2),
}
MODEL_FAMILY_NEW = 16               # phase 19 (d)'s new tokens a request


def model_axis_families() -> None:
    """Phase 19 (d): the ssm, hybrid, vlm and audio families at full
    width (depth cut by ``MODEL_FAMILY_CUTS``), bf16 weights from seed
    0, phase 4's traffic with no mesh and on a (1, 1) mesh (the models'
    one body under ``distributed.tp.use``): tokens and the SSD kernel's
    launches equal, no "model"-axis collective issued."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as sh
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.serving import Engine
    mesh = _mesh()
    for arch, cut in MODEL_FAMILY_CUTS.items():
        t = time.perf_counter()
        cfg = get_arch(arch).replace(**cut)
        params = init_weights(cfg)
        rng = np.random.RandomState(0)
        prompts = [rng.randint(0, cfg.vocab, n, dtype=np.int32)
                   for n in SERVE_LENS]
        runs = {}
        for on in (False, True):
            ecfg = EngineConfig(mesh=mesh if on else None)
            sh.reset_collective_counts()
            eng, toks, launches, peak = serve_once(
                lambda: Engine(cfg, params, slots=4, max_len=1024,
                               decompose_engine=DecomposeEngine(ecfg),
                               device="cuda"),
                prompts, MODEL_FAMILY_NEW, title=f"model (d) {arch}")
            runs[on] = (toks, launches["ssd_chunk_intra"],
                        sh.collective_counts(), eng.stats.decode_tok_s, peak)
            del eng
        (a_tok, a_ssd, a_coll, a_rate, _), (b_tok, b_ssd, b_coll, b_rate,
                                            peak) = runs[False], runs[True]
        # at M = 1 only the data axis's token all-gather runs
        model = sorted(set(b_coll) - {"all_gather/tokens"})
        print(f"model (d): {cfg.name} ({cfg.family}) full width, depth "
              f"{cfg.num_layers}, on a (1, 1) mesh: tokens equal to no "
              f"mesh {a_tok == b_tok}; ssd_chunk_intra launches {b_ssd} vs "
              f"{a_ssd}; collectives {json.dumps(b_coll)} (no mesh "
              f"{json.dumps(a_coll)}); decode_tok/s {b_rate:.2f} vs no "
              f"mesh {a_rate:.2f}; peak_mem_gib {peak:.2f}; "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        if a_tok != b_tok or a_ssd != b_ssd or a_coll or model or (
                cfg.family in ("ssm", "hybrid") and not b_ssd):
            raise AssertionError(
                f"model (d) {arch}: tokens, SSD launches ({b_ssd} vs "
                f"{a_ssd}) or collectives ({model}; no mesh {a_coll}) "
                f"differ from no mesh's")
        del params
        check_freed(f"model (d) {arch}")


# ---------------------------------------------------------------------------
# Phase 20: the rest of the "model" axis on one card (a one-rank group)
# ---------------------------------------------------------------------------

SEQ_T = 524_288                 # long_500k: tokens of the batch-1 cache
SEQ_DECODE_STEPS = 4            # (a)
SEQ_F32_T = 65_536              # (a)'s float32 token check
SEQ_DKV_T, SEQ_DKV_RANK, SEQ_DKV_TAIL = 32_768, 64, 16   # (b), (b')
SEQ_DKV_STEPS = 8
SEQ_SV_TOL = 1e-5               # (b'): singular values, relative
CARD = "card not read"          # nvidia-smi's name and power limit (main)
SEQ_DKV_PEAK_GIB = 70.0         # (b'): above it, halve the prompt
SEQ_TRAIN_S = 8192              # (c): one sequence of 8192 tokens
SEQ_TRAIN_LAYERS = 4            # (c), (d), (e): depth cut, full width
SEQ_LOGIT_TOL = 1e-2            # bf16 logits, relative to the largest
SEQ_LOSS_TOL = 1e-5             # relative, (c), (d), (e)
SEQ_RESUME_TOL = 1e-6           # relative, (e)'s resumed steps
SEQ_RANKS = 4                   # the four-card cells' DP ranks
SEQ_PREFILL_S = 16_384          # (f): a batch-1 prompt's tokens
SEQ_PREFILL_EXTRA = 1024        # (f): cache rows past the prompt
# (f): a prefill's final Mamba2 states, relative to the largest entry:
# without a mesh they take the reference's formula (the decay to the end
# from a float32 cumsum over all 16,384 steps), sequence-sharded the
# chunked scan's end state, another float32 sum (3.04e-4 apart on the
# card)
SEQ_STATE_TOL = 1e-3


def _rel_max(a, b) -> float:
    """max |a − b| over max |b| (float32)."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


def _one_step_collectives(before) -> dict:
    from repro_torch.distributed import sharding as sh
    now = sh.collective_counts()
    return {k: [v[0] - before.get(k, (0, 0))[0],
                v[1] - before.get(k, (0, 0))[1]] for k, v in now.items()
            if v != tuple(before.get(k, (0, 0)))}


def _ms_list(ms) -> str:
    return "[" + ", ".join(f"{v:.1f}" for v in ms) + "]"


def _greedy_decode(step, params, cache, tok, pos0: int, n: int, *extra):
    """``n`` greedy steps of ``step`` from token ``tok`` at ``pos0``:
    (each step's logits, tokens, the collectives of the last step, each
    step's ms)."""
    import torch
    from repro_torch.distributed import sharding as sh
    logits, toks, last, ms = [], [], {}, []
    for i in range(n):
        before = {k: tuple(v) for k, v in sh.collective_counts().items()}
        pos = torch.full((1,), pos0 + i, dtype=torch.long, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = step(params, tok, cache, pos, *extra)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        last = _one_step_collectives(before)
        logits.append(lg.float())
        tok = lg.argmax(-1)
        toks.append(int(tok.item()))
    return logits, toks, last, ms


def seq_long_decode() -> None:
    """Phase 20 (a): zamba2-1.2b at full width and depth, ``long_500k``
    decode: a batch-1 cache of SEQ_T rows (each of the 6 shared-attention
    applications' K and V, bf16, N(0, 1) from a seeded generator; the
    Mamba2 states N(0, 0.1²)), SEQ_DECODE_STEPS greedy steps with no mesh
    and on a (1, 1) mesh, whose decode holds every time axis as the
    rank's block over "data" (the whole, at one rank) and merges the
    ranks' flash statistics: logits within SEQ_LOGIT_TOL; then float32
    weights over SEQ_F32_T rows: tokens equal."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import hybrid
    from repro_torch.runtime import steps
    from repro_torch.tree import named_leaves
    mesh = _mesh()
    cfg = get_arch(HYBRID_ARCH)
    params = init_weights(cfg)
    for dtype, t in (("bfloat16", SEQ_T), ("float32", SEQ_F32_T)):
        t0 = time.perf_counter()
        if dtype == "float32":
            params = to_float32(params)
        c = cfg.replace(dtype=dtype)
        gen = torch.Generator(device="cuda").manual_seed(1)
        cache = hybrid.init_state(c, 1, t, device="cuda")
        for name, leaf in named_leaves(cache):
            leaf.normal_(generator=gen)
            if not name.startswith("attn"):
                leaf.mul_(0.1)
        attn_gb = sum(v.numel() * v.element_size()
                      for v in cache["attn"].values()) / 1e9
        pos0 = t - SEQ_DECODE_STEPS
        keep = {n: v.clone() for n, v in named_leaves(cache)
                if not n.startswith("attn")}
        rows = {k: v[:, :, pos0:].clone() for k, v in cache["attn"].items()}
        tok = torch.ones(1, dtype=torch.long, device="cuda")
        runs = {}
        for on in (False, True):
            for n, v in named_leaves(cache):
                if n in keep:
                    v.copy_(keep[n])
            for k, v in rows.items():
                cache["attn"][k][:, :, pos0:] = v
            step = steps.make_decode_step(c, mesh if on else None)
            sh.reset_collective_counts()
            runs[on] = _greedy_decode(step, params, cache, tok, pos0,
                                      SEQ_DECODE_STEPS)
        (lg_a, tok_a, coll_a, s_a), (lg_b, tok_b, coll_b, s_b) = \
            runs[False], runs[True]
        rel = _rel_max(lg_b[0], lg_a[0])
        print(f"seq (a): {cfg.name} {dtype} long_500k-style decode at B = "
              f"1, T = {t} ({attn_gb:.1f} GB of K/V, 6 applications), "
              f"{SEQ_DECODE_STEPS} steps: (1, 1) mesh step-0 logits rel "
              f"{rel:.2e} vs no mesh; tokens {tok_b} vs {tok_a}; step ms "
              f"{_ms_list(s_b)} vs {_ms_list(s_a)}; collectives of one mesh "
              f"step (op/payload: [calls, bytes sent]) "
              f"{json.dumps(coll_b)}; no mesh {json.dumps(coll_a)}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if coll_a or coll_b.get("all_gather/attn_stats", [0])[0] != 6 \
                or coll_b.get("all_reduce/attn_out", [0])[0] != 6:
            raise AssertionError(f"seq (a): collectives {coll_b} (no mesh "
                                 f"{coll_a})")
        if dtype == "bfloat16" and not rel <= SEQ_LOGIT_TOL:
            raise AssertionError(f"seq (a): logits rel {rel}")
        if dtype == "float32" and tok_a != tok_b:
            raise AssertionError(f"seq (a): float32 tokens {tok_b} vs "
                                 f"{tok_a}")
        del cache, keep, rows
    del params
    check_freed("seq (a)")


def seq_dkv_prefill(cfg, params) -> None:
    """Phase 20 (b′), on the loaded llama2-7b weights (bf16, full width and
    depth): a batch-1 prompt of SEQ_DKV_T tokens (the reference's
    ``prefill_32k`` length) through ``make_dkv_prefill_step`` at rank
    SEQ_DKV_RANK, tail SEQ_DKV_TAIL, with no mesh and sequence-sharded on
    a (1, 1) mesh (the time blocks moved to layer blocks by an
    all-to-all, every layer's whole K and V through the batched re-orth
    kernels, U·Σ moved back, Vᵀ all-gathered: at one rank each a copy):
    the factors bit-equal, the singular values within SEQ_SV_TOL, the
    re-orth launches equal; then SEQ_DKV_STEPS greedy decode steps from
    each cache (the mesh run fed the no-mesh run's tokens), logits within
    SEQ_LOGIT_TOL, tokens equal, ``dkv_attention_stats`` launched
    SEQ_DKV_STEPS x L times each.  Prints the prefill's ms, its
    decomposition's ms, its peak and the mesh run's collectives; then
    times the re-orth pair at one of four ranks' shape [L/4, S, kvw]
    float32, k = rank + 8."""
    import torch
    from repro_torch.distributed import sharding as sh
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.kernels import ops
    from repro_torch.runtime import steps

    class Timed(DecomposeEngine):
        """The engine, its ``decompose_kv`` calls timed on the host clock
        (synchronized on both sides)."""
        ms = 0.0

        def decompose_kv(self, *a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = super().decompose_kv(*a, **kw)
            torch.cuda.synchronize()
            self.ms += (time.perf_counter() - t) * 1e3
            return out

    mesh = _mesh()
    t0 = time.perf_counter()
    s, r, nl = SEQ_DKV_T, SEQ_DKV_RANK, cfg.num_layers
    tok = torch.randint(0, cfg.vocab, (1, s),
                        generator=torch.Generator().manual_seed(6)).cuda()
    runs = {}
    for on in (False, True):
        eng = Timed()
        step = steps.make_dkv_prefill_step(cfg, r, tail=SEQ_DKV_TAIL,
                                           engine=eng,
                                           mesh=mesh if on else None)
        sh.reset_collective_counts()
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ts = time.perf_counter()
        lg, cache = step(params, tok)
        torch.cuda.synchronize()
        n = ops.launch_counts()
        runs[on] = dict(lg=lg, cache=cache,
                        ms=(time.perf_counter() - ts) * 1e3, dec_ms=eng.ms,
                        peak=torch.cuda.max_memory_allocated() / 2 ** 30,
                        right=n["reorth_right_batched"],
                        left=n["reorth_left_batched"],
                        coll=sh.collective_counts())
    a, b = runs[False], runs[True]
    factors = ("k_u", "k_vt", "v_u", "v_vt")
    equal = all(torch.equal(a["cache"][k], b["cache"][k]) for k in factors)
    svrel = max(_rel_max(b["cache"][k].float().norm(dim=2),
                         a["cache"][k].float().norm(dim=2))
                for k in ("k_u", "v_u"))
    frozen = torch.tensor([s], dtype=torch.int32, device="cuda")
    dec = {}
    for on in (False, True):
        step = steps.make_dkv_decode_step(cfg, mesh if on else None)
        ops.reset_launch_counts()
        feed = None if not on else dec[False][1]
        dec[on] = _forced_decode(step, params, runs[on]["cache"],
                                 runs[on]["lg"], s, SEQ_DKV_STEPS, feed,
                                 frozen) + (
            ops.launch_counts()["dkv_attention_stats"],)
    rel = max(_rel_max(x, y) for x, y in zip(dec[True][0], dec[False][0]))
    print(f"seq (b'): {cfg.name} bf16 full width, depth {nl}, batch-1 "
          f"decomposed-KV prefill of {s} tokens (rank {r}, tail "
          f"{SEQ_DKV_TAIL}) on {CARD}: (1, 1) mesh vs no mesh: factors "
          f"bit-equal {equal}, singular values rel {svrel:.2e}; re-orth "
          f"launches right/left {b['right']}/{b['left']} vs "
          f"{a['right']}/{a['left']}; prefill ms {b['ms']:.1f} vs "
          f"{a['ms']:.1f}, decomposition ms {b['dec_ms']:.1f} vs "
          f"{a['dec_ms']:.1f}; peak GiB {b['peak']:.2f} vs "
          f"{a['peak']:.2f}; mesh collectives {json.dumps(b['coll'])}; "
          f"{SEQ_DKV_STEPS} greedy steps: logits rel {rel:.2e}, tokens "
          f"{dec[True][2]} vs {dec[False][2]}, dkv_attention_stats "
          f"launches {dec[True][3]} vs {dec[False][3]}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    moved = {f"all_to_all/dkv_{k}_{w}" for k in "kv" for w in ("rows", "u")}
    if not (equal and svrel <= SEQ_SV_TOL and a["right"] == b["right"] > 0
            and a["left"] == b["left"] > 0 and rel <= SEQ_LOGIT_TOL
            and dec[True][2] == dec[False][2] and not a["coll"]
            and moved <= set(b["coll"])
            and dec[True][3] == dec[False][3] == SEQ_DKV_STEPS * nl):
        raise AssertionError(f"seq (b'): factors equal {equal}, sv rel "
                             f"{svrel}, launches {b} vs {a}, logits rel "
                             f"{rel}, tokens {dec[True][2]} vs "
                             f"{dec[False][2]}, dkv {dec[True][3]} vs "
                             f"{dec[False][3]}")
    if b["peak"] > SEQ_DKV_PEAK_GIB:
        raise AssertionError(f"seq (b'): peak {b['peak']:.1f} GiB over "
                             f"{SEQ_DKV_PEAK_GIB}: halve the prompt")
    launches = {"right": b["right"], "left": b["left"]}
    del runs, a, b, dec
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(7)
    k = r + 8                          # decompose_kv: rank + kv_iters_extra
    for side in ("right", "left"):
        row = reorth_case(side, nl // SEQ_RANKS, s, cfg.kv_width, k, k // 2,
                          EngineConfig().expansion, gen)
        keep = {key: row[key] for key in (
            "name", "shape", "max_abs_err", "ms", "ms_l2_cold", "plain_ms",
            "bound_ms", "bound_by", "library_ms")}
        print(f"seq (b') row ({CARD}): " + json.dumps(dict(
            keep, launches_per_sharded_prefill=launches[side])), flush=True)
        del row
        torch.cuda.empty_cache()


def _forced_decode(step, params, cache, lg, pos0: int, n: int, feed,
                   *extra):
    """``n`` decode steps of ``step`` from prefill logits ``lg`` at
    ``pos0``: greedy, or fed ``feed``'s tokens (the mesh run takes the
    no-mesh run's, so that every step's logits compare): (each step's
    logits, the tokens fed, each step's own greedy token)."""
    import torch
    logits, fed, own = [], [], []
    nxt = int(lg.argmax(-1).item()) if feed is None else feed[0]
    for i in range(n):
        fed.append(nxt)
        tok = torch.full((1,), nxt, dtype=torch.long, device="cuda")
        pos = torch.full((1,), pos0 + i, dtype=torch.long, device="cuda")
        out, cache = step(params, tok, cache, pos, *extra)
        logits.append(out.float())
        own.append(int(out.argmax(-1).item()))
        nxt = feed[i + 1] if feed is not None and i + 1 < n else own[-1]
    return logits, fed, own


def seq_dkv_decode(cfg, params) -> None:
    """Phase 20 (b), on the loaded llama2-7b weights: decomposed-KV decode
    at B = 1 over a frozen prefix of SEQ_DKV_T rows (seeded rank-64
    factors: U N(0, 1), Vᵀ N(0, 1/r), bf16; tail SEQ_DKV_TAIL),
    SEQ_DKV_STEPS greedy steps with no mesh and on a (1, 1) mesh (the
    rank's block of the prefix rows and of the tail, the statistics
    merged over "data"): logits within SEQ_LOGIT_TOL, the dkv kernel
    launched as often.  Also times ``dkv_attention_stats`` at the four-card
    cell's rows a rank."""
    import torch
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.models import decomposed_kv as DK
    from repro_torch.runtime import steps
    mesh = _mesh()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(2)
    r, t = SEQ_DKV_RANK, SEQ_DKV_T
    cache = DK.init_cache(cfg, 1, t, r, tail=SEQ_DKV_TAIL, device="cuda")
    for k in ("k_u", "v_u"):
        cache[k].normal_(generator=gen)
    for k in ("k_vt", "v_vt"):
        cache[k].normal_(generator=gen).mul_(r ** -0.5)
    frozen = torch.tensor([t], dtype=torch.int32, device="cuda")
    tok = torch.ones(1, dtype=torch.long, device="cuda")
    runs = {}
    for on in (False, True):
        for v in cache["tail"].values():
            v.zero_()
        step = steps.make_dkv_decode_step(cfg, mesh if on else None)
        sh.reset_collective_counts()
        ops.reset_launch_counts()
        out = _greedy_decode(step, params, cache, tok, t, SEQ_DKV_STEPS,
                             frozen)
        runs[on] = out + (ops.launch_counts()["dkv_attention_stats"],)
    (lg_a, tok_a, coll_a, s_a, n_a), (lg_b, tok_b, coll_b, s_b, n_b) = \
        runs[False], runs[True]
    rel = max(_rel_max(x, y) for x, y in zip(lg_b, lg_a))
    row = dkv_case(1, cfg.num_heads, t // SEQ_RANKS, r, [t // SEQ_RANKS],
                   torch.bfloat16, torch.Generator(device="cuda")
                   .manual_seed(3))
    print(f"seq (b): {cfg.name} decomposed KV at B = 1, frozen T = {t} "
          f"(rank {r}, tail {SEQ_DKV_TAIL}), {SEQ_DKV_STEPS} steps: (1, 1) "
          f"mesh logits rel {rel:.2e} vs no mesh; tokens {tok_b} vs {tok_a}; "
          f"dkv_attention_stats launches {n_b} vs {n_a}; step ms "
          f"{_ms_list(s_b)} vs {_ms_list(s_a)}; collectives of one mesh step "
          f"{json.dumps(coll_b)}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    print("seq (b) row: " + json.dumps({k: row[k] for k in (
        "name", "shape", "max_abs_err", "ms", "ms_l2_cold", "plain_ms",
        "bound_ms", "bound_by", "library_ms")}), flush=True)
    if coll_a or not rel <= SEQ_LOGIT_TOL or n_a != n_b \
            or n_b != SEQ_DKV_STEPS * cfg.num_layers \
            or coll_b.get("all_gather/dkv_stats", [0])[0] != cfg.num_layers:
        raise AssertionError(f"seq (b): logits rel {rel}, launches {n_b} vs "
                             f"{n_a}, collectives {coll_b} / {coll_a}")
    del cache


def seq_mamba2() -> None:
    """Phase 20 (c): mamba2-780m at full width, depth SEQ_TRAIN_LAYERS,
    one sequence of SEQ_TRAIN_S tokens: prefill and three AdamW steps
    with no mesh and sequence-sharded on a (1, 1) mesh (a batch-1 batch
    on a mesh: the conv halo, the SSD kernels on the rank's chunks, the
    state scan over the group): logits within SEQ_LOGIT_TOL, losses
    within SEQ_LOSS_TOL, both SSD kernels launched as often.  Then both
    SSD kernels timed at one rank's chunks of the four-card cell."""
    import torch
    from repro_torch import optim
    from repro_torch.configs import ShapeSpec, get_arch
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.runtime import steps
    from repro_torch.runtime.driver import to_device
    mesh = _mesh()
    t0 = time.perf_counter()
    cfg = get_arch(MAMBA_ARCH).replace(num_layers=SEQ_TRAIN_LAYERS)
    src = SyntheticLM(cfg, ShapeSpec("t", SEQ_TRAIN_S, 1, "train"),
                      DataConfig(seed=0))
    batches = [to_device(src.batch_at(i), "cuda") for i in range(3)]
    runs = {}
    for on in (False, True):
        params = init_weights(cfg)
        m = mesh if on else None
        ops.reset_launch_counts()
        sh.reset_collective_counts()
        torch.cuda.synchronize()
        ts = time.perf_counter()
        lg, _ = steps.make_prefill_step(cfg, m)(params, batches[0]["tokens"])
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - ts
        pre_n = ops.launch_counts()["ssd_chunk_intra"]
        opt = optim.make_optimizer(cfg, warmup=1)
        state = opt.init(params)
        fn = steps.make_train_step(cfg, opt, mesh=m)
        losses, ms = [], []
        ops.reset_launch_counts()
        for b in batches:
            torch.cuda.synchronize()
            ts = time.perf_counter()
            params, state, met = fn(params, state, b)
            losses.append(met["loss"].item())
            ms.append((time.perf_counter() - ts) * 1e3)
        counts = ops.launch_counts()
        runs[on] = (lg.float(), pre_s, pre_n, losses, ms,
                    counts["ssd_chunk_intra"], counts["ssd_chunk_intra_bwd"],
                    sh.collective_counts())
        del params, state, lg
    a, b = runs[False], runs[True]
    rel = _rel_max(b[0], a[0])
    lrel = max(abs(x - y) / abs(y) for x, y in zip(b[3], a[3]))
    print(f"seq (c): {cfg.name} full width, depth {cfg.num_layers}, B = 1 "
          f"x S = {SEQ_TRAIN_S}, sequence-sharded on a (1, 1) mesh: prefill "
          f"logits rel {rel:.2e} vs no mesh, ssd_chunk_intra launches "
          f"{b[2]} vs {a[2]}, prefill s {b[1]:.3f} vs {a[1]:.3f}; 3 AdamW "
          f"steps losses {b[3]} vs {a[3]} (max rel {lrel:.2e}), step ms "
          f"{', '.join(f'{v:.1f}' for v in b[4])} vs "
          f"{', '.join(f'{v:.1f}' for v in a[4])}; train launches fwd "
          f"{b[5]} vs {a[5]}, bwd {b[6]} vs {a[6]}; collectives "
          f"{json.dumps(b[7])}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    if not (rel <= SEQ_LOGIT_TOL and lrel <= SEQ_LOSS_TOL and a[2] == b[2]
            and a[5:7] == b[5:7] and b[6] > 0 and not a[7]):
        raise AssertionError(f"seq (c): logits rel {rel}, losses rel "
                             f"{lrel}, launches {b[2]}/{b[5:7]} vs "
                             f"{a[2]}/{a[5:7]}, no-mesh collectives {a[7]}")
    g = SEQ_TRAIN_S // SEQ_RANKS // 64
    gen = torch.Generator(device="cuda").manual_seed(4)
    for case in (ssd_case(g, 64, cfg.ssm_heads, cfg.ssm_head_dim, gen,
                          per_run=cfg.num_layers),
                 ssd_bwd_case(g, 64, cfg.ssm_heads, cfg.ssm_head_dim, gen,
                              per_step=cfg.num_layers)):
        print("seq (c) row: " + json.dumps({k: case[k] for k in (
            "name", "shape", "max_abs_err", "ms", "ms_l2_cold", "plain_ms",
            "bound_ms", "bound_by")}), flush=True)
    check_freed("seq (c)")


def seq_prefill_memory() -> None:
    """Phase 20 (f): zamba2-1.2b at full width and depth, float32, one
    prompt of SEQ_PREFILL_S tokens prefilled with no mesh and
    sequence-sharded on a (1, 1) mesh, into a cache of the prompt's
    length (the rank keeps its own K/V rows, no collective) and of
    SEQ_PREFILL_S + SEQ_PREFILL_EXTRA rows (each layer's rows moved to
    the blocks that hold them: one all-to-all a leaf and layer): logits
    and K/V within SEQ_LOSS_TOL, the Mamba2 states within SEQ_STATE_TOL,
    and each run's peak device memory above what was allocated before
    it."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as sh
    from repro_torch.runtime import steps
    from repro_torch.tree import named_leaves
    mesh = _mesh()
    t0 = time.perf_counter()
    cfg = get_arch(HYBRID_ARCH).replace(dtype="float32")
    params = to_float32(init_weights(cfg))
    tok = torch.randint(0, cfg.vocab, (1, SEQ_PREFILL_S),
                        generator=torch.Generator().manual_seed(5)).cuda()
    lines = []
    for max_len in (None, SEQ_PREFILL_S + SEQ_PREFILL_EXTRA):
        runs = {}
        for on in (False, True):
            sh.reset_collective_counts()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ts = time.perf_counter()
            lg, cache = steps.make_prefill_step(cfg, mesh if on else None)(
                params, tok, max_len=max_len)
            torch.cuda.synchronize()
            runs[on] = (lg.float(), cache, time.perf_counter() - ts,
                        (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
                        sh.collective_counts())
            del lg, cache
        (lg_a, c_a, s_a, m_a, _), (lg_b, c_b, s_b, m_b, coll) = \
            runs[False], runs[True]
        del runs
        rel = _rel_max(lg_b, lg_a)
        whole = dict(named_leaves(c_a))
        crel = max(_rel_max(c_b["attn"][k], c_a["attn"][k])
                   for k in ("k", "v"))
        srel = max(_rel_max(v, whole[n]) for n, v in named_leaves(c_b)
                   if not n.startswith("attn"))
        t = c_b["attn"]["k"].shape[2]
        del lg_a, lg_b, c_a, c_b, whole
        lines.append((max_len, rel, crel, srel, coll))
        print(f"seq (f): {cfg.name} float32 batch-1 prefill of "
              f"{SEQ_PREFILL_S} tokens into T = {t} rows, (1, 1) mesh vs no "
              f"mesh: logits rel {rel:.2e}, K/V rel {crel:.2e}, Mamba2 "
              f"states rel {srel:.2e}; peak GiB above the weights "
              f"{m_b:.2f} vs {m_a:.2f}; s {s_b:.3f} vs {s_a:.3f}; "
              f"collectives {json.dumps(coll)}", flush=True)
    print(f"seq (f): {time.perf_counter() - t0:.1f} s", flush=True)
    for max_len, rel, crel, srel, coll in lines:
        moved = any(k.startswith("all_to_all/prefill_") for k in coll)
        if not (rel <= SEQ_LOSS_TOL and crel <= SEQ_LOSS_TOL
                and srel <= SEQ_STATE_TOL) or moved != (max_len is not None):
            raise AssertionError(f"seq (f): max_len {max_len}: logits rel "
                                 f"{rel}, K/V rel {crel}, states rel {srel}, "
                                 f"collectives {coll}")
    del params
    check_freed("seq (f)")


def seq_train_adafactor() -> None:
    """Phase 20 (d, e): granite-3-2b at full width, depth
    SEQ_TRAIN_LAYERS, float32, ``optimizer="adafactor"``, three steps of
    4 x 512: no mesh, and ZeRO-1 with ``seq_parallel=True`` on a (1, 1)
    mesh — Megatron-SP on a one-rank "model" group (its all-gathers and
    reduce-scatters along S in place of the TP all-reduces, each a copy)
    and Adafactor's split statistics (the sums over the ZeRO-1 dim
    all-reduced over a one-rank "data" group): losses within
    SEQ_LOSS_TOL, the SP and Adafactor collectives counted, no TP
    all-reduce of the activations.  (e): the mesh run's state after its
    first step saved whole, ``restore_for_mesh``'d and fed as it is, two
    more steps within SEQ_RESUME_TOL of the uninterrupted ones."""
    import torch
    from repro_torch import optim
    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as sh
    from repro_torch.runtime import driver, steps
    mesh = _mesh()
    t0 = time.perf_counter()
    base = get_arch(TRAIN_ARCH).replace(num_layers=SEQ_TRAIN_LAYERS,
                                        optimizer="adafactor",
                                        dtype="float32")
    batches = _train_batches(base, MODEL_TRAIN_STEPS)
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_seq_") as tmp:
        for on in (False, True):
            cfg = base.replace(seq_parallel=on)
            params = to_float32(init_weights(cfg))
            opt = optim.make_optimizer(cfg, warmup=1)
            state = opt.init(params)
            kw = dict(zero1=True, optimizer=opt) if on else {}
            if on:
                params, state = steps.shard_train_state(cfg, params, state,
                                                        mesh, **kw)
            fn = steps.make_train_step(cfg, opt, mesh=mesh if on else None,
                                       zero1=on)
            losses, ms = [], []
            sh.reset_collective_counts()
            for i, b in enumerate(batches):
                torch.cuda.synchronize()
                ts = time.perf_counter()
                params, state, met = fn(params, state, b)
                losses.append(met["loss"].item())
                ms.append((time.perf_counter() - ts) * 1e3)
                if on and i == 0:
                    driver.save_for_mesh(cfg, {"params": params,
                                               "opt": state}, tmp, 1, mesh,
                                         **kw)
            runs[on] = (losses, ms, sh.collective_counts())
            del params, state
        a, b = runs[False], runs[True]
        lrel = max(abs(x - y) / abs(y) for x, y in zip(b[0], a[0]))
        print(f"seq (d): {base.name} full width, depth {base.num_layers}, "
              f"float32, Adafactor, {len(batches)} steps, ZeRO-1 + "
              f"seq_parallel on a (1, 1) mesh (Megatron-SP on a one-rank "
              f"model group): losses {b[0]} vs no mesh {a[0]} (max rel "
              f"{lrel:.2e}); step ms {', '.join(f'{v:.1f}' for v in b[1])} "
              f"vs {', '.join(f'{v:.1f}' for v in a[1])}; collectives "
              f"{json.dumps(b[2])}", flush=True)
        need = ("all_gather/sp_tp_in", "reduce_scatter/sp_tp_out",
                "reduce_scatter/sp_embed", "all_reduce/adafactor_vr",
                "all_reduce/adafactor_vc", "all_reduce/adafactor_rms")
        if not lrel <= SEQ_LOSS_TOL or a[2] \
                or any(k not in b[2] for k in need) \
                or {"all_reduce/tp_out", "all_reduce/tp_in_grad"} & set(b[2]):
            raise AssertionError(f"seq (d): losses rel {lrel}, collectives "
                                 f"{b[2]}, no-mesh collectives {a[2]}")
        cfg = base.replace(seq_parallel=True)
        opt = optim.make_optimizer(cfg, warmup=1)
        back = driver.restore_for_mesh(cfg, tmp, mesh, optimizer=opt)
        fn = steps.make_train_step(cfg, opt, mesh=mesh, zero1=True)
        resumed = []
        params, state = back["params"], back["opt"]
        for batch in batches[1:]:
            params, state, met = fn(params, state, batch)
            resumed.append(met["loss"].item())
        del params, state, back
    rel = max(abs(x - y) / abs(y) for x, y in zip(resumed, b[0][1:]))
    print(f"seq (e): restore_for_mesh of the Adafactor ZeRO-1 step-1 "
          f"checkpoint fed as DTensors: losses {resumed} vs uninterrupted "
          f"{b[0][1:]}, max rel {rel:.2e}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    if not rel <= SEQ_RESUME_TOL:
        raise AssertionError(f"seq (e): resumed losses differ by {rel}")
    check_freed("seq (d, e)")


SEQ_MODAL_S = 1024              # (g): the batch-1 prompt's tokens
SEQ_MODAL_TRAIN_S = 512         # (g): the batch-1 train step's tokens
SEQ_MODAL_STEPS = 4             # (g): greedy decode steps


def seq_modal() -> None:
    """Phase 20 (g): the vlm and audio families at full width (depth cut
    by ``MODEL_FAMILY_CUTS``), bf16, at batch 1 with no mesh and
    sequence-sharded on a (1, 1) mesh (the image embeddings or frames a
    second sequence, the cross-attention's K/V rows gathered over the
    group, decode merging each rank's cross statistics as self-attention
    does): a prompt of SEQ_MODAL_S tokens (the vlm's 1601 image tokens,
    the audio's 4096 frames) prefilled, logits within SEQ_LOGIT_TOL;
    SEQ_MODAL_STEPS decode steps (the mesh run fed the no-mesh run's
    tokens), logits within SEQ_LOGIT_TOL and the same greedy tokens; one
    AdamW step of one SEQ_MODAL_TRAIN_S-token sequence, losses within
    SEQ_LOSS_TOL."""
    import torch
    from repro_torch import optim
    from repro_torch.configs import ShapeSpec, get_arch
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed import sharding as sh
    from repro_torch.runtime import steps
    from repro_torch.runtime.driver import to_device
    mesh = _mesh()
    for arch in MODAL_ARCHS:
        t0 = time.perf_counter()
        cfg = get_arch(arch).replace(**MODEL_FAMILY_CUTS[arch])
        params = init_weights(cfg)
        gen = torch.Generator().manual_seed(8)
        tok = torch.randint(0, cfg.vocab, (1, SEQ_MODAL_S), generator=gen)
        m = cfg.num_image_tokens if cfg.family == "vlm" else \
            cfg.num_audio_frames
        mem = (0.5 * torch.randn(1, m, cfg.d_model, generator=gen)).to(
            params["embed"]["w"].dtype)
        ins = tuple(x.cuda() for x in ((tok, mem) if cfg.family == "vlm"
                                       else (mem, tok)))
        runs = {}
        for on in (False, True):
            mm = mesh if on else None
            sh.reset_collective_counts()
            lg, cache = steps.make_prefill_step(cfg, mm)(
                params, *ins, max_len=SEQ_MODAL_S + SEQ_MODAL_STEPS)
            feed = None if not on else runs[False][1][1]
            dec = _forced_decode(steps.make_decode_step(cfg, mm), params,
                                 cache, lg, SEQ_MODAL_S, SEQ_MODAL_STEPS,
                                 feed)
            runs[on] = (lg.float(), dec, sh.collective_counts())
            del lg, cache
        src = SyntheticLM(cfg, ShapeSpec("t", SEQ_MODAL_TRAIN_S, 1,
                                         "train"), DataConfig(seed=0))
        batch = to_device(src.batch_at(0), "cuda")
        losses = {}
        for on in (False, True):
            p = _clone_tree(params)
            opt = optim.make_optimizer(cfg, warmup=1)
            st = opt.init(p)
            out = steps.make_train_step(cfg, opt, mesh=mesh if on
                                        else None)(p, st, batch)
            losses[on] = out[2]["loss"].item()
            del p, st, opt, out
        a, b = runs[False], runs[True]
        rel = _rel_max(b[0], a[0])
        drel = max(_rel_max(x, y) for x, y in zip(b[1][0], a[1][0]))
        lrel = abs(losses[True] - losses[False]) / abs(losses[False])
        print(f"seq (g): {cfg.name} ({cfg.family}) bf16 full width, depth "
              f"{cfg.num_layers}, batch-1 prompt of {SEQ_MODAL_S} tokens "
              f"and {m} memory rows on {CARD}: (1, 1) mesh vs no mesh: "
              f"prefill logits rel {rel:.2e}; {SEQ_MODAL_STEPS} decode "
              f"steps logits rel {drel:.2e}, greedy tokens {b[1][2]} vs "
              f"{a[1][2]}; one AdamW step of {SEQ_MODAL_TRAIN_S} tokens "
              f"loss {losses[True]} vs {losses[False]} (rel {lrel:.2e}); "
              f"mesh collectives {json.dumps(b[2])}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if not (rel <= SEQ_LOGIT_TOL and drel <= SEQ_LOGIT_TOL
                and b[1][2] == a[1][2] and lrel <= SEQ_LOSS_TOL
                and not a[2] and "all_gather/attn_stats" in b[2]):
            raise AssertionError(f"seq (g) {arch}: logits rel {rel}, "
                                 f"decode rel {drel}, tokens {b[1][2]} vs "
                                 f"{a[1][2]}, loss rel {lrel}, collectives "
                                 f"{b[2]} / {a[2]}")
        del params, runs
        check_freed(f"seq (g) {arch}")


def _clone_tree(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.clone(), tree)


#: the SP case: each family's depth cut at full width (zamba2-1.2b one
#: group of 5 Mamba2 blocks and its shared block; olmoe-1b-7b given one
#: leading dense layer, as kimi-k2 has, so that a block runs SP), and
#: granite-3-2b at batch 1 sequence-sharded with SP on the same step
SP_CASES = ((HYBRID_ARCH, dict(num_layers=6), False),
            (MOE_ARCH, dict(num_layers=4, first_k_dense=1), False),
            (TRAIN_ARCH, dict(num_layers=SEQ_TRAIN_LAYERS), True))
SP_STEPS = 2
SP_SEQ_S = 2048                 # granite's batch-1 sequence


def seq_sp_families() -> None:
    """Phase 20 (h), the SP case: each ``SP_CASES`` config with
    ``seq_parallel=True`` on a (1, 1) mesh (Megatron-SP on a one-rank
    "model" group) against no SP and no mesh, SP_STEPS AdamW steps of
    the same batches: losses within SEQ_LOSS_TOL, and the SP
    collectives counted where the reference runs ``transformer.block``
    (the all-gathers and reduce-scatters along S; ``sp_whole`` where the
    residual leaves a shared or dense block for a Mamba2 group or an MoE
    block)."""
    import torch
    from repro_torch import optim
    from repro_torch.configs import ShapeSpec, get_arch
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed import sharding as sh
    from repro_torch.runtime import steps
    from repro_torch.runtime.driver import to_device
    mesh = _mesh()
    for arch, cut, batch1 in SP_CASES:
        t0 = time.perf_counter()
        base = get_arch(arch).replace(**cut)
        if batch1:
            src = SyntheticLM(base, ShapeSpec("t", SP_SEQ_S, 1, "train"),
                              DataConfig(seed=0))
            batches = [to_device(src.batch_at(i), "cuda")
                       for i in range(SP_STEPS)]
        else:
            batches = _train_batches(base, SP_STEPS)
        runs = {}
        for on in (False, True):
            cfg = base.replace(seq_parallel=on)
            params = init_weights(cfg)
            opt = optim.make_optimizer(cfg, warmup=1)
            state = opt.init(params)
            fn = steps.make_train_step(cfg, opt, mesh=mesh if on else None)
            sh.reset_collective_counts()
            losses, ms = [], []
            for b in batches:
                torch.cuda.synchronize()
                ts = time.perf_counter()
                params, state, met = fn(params, state, b)
                losses.append(met["loss"].item())
                ms.append((time.perf_counter() - ts) * 1e3)
            runs[on] = (losses, ms, sh.collective_counts())
            del params, state, opt, fn
        a, b = runs[False], runs[True]
        lrel = max(abs(x - y) / abs(y) for x, y in zip(b[0], a[0]))
        sp = {k: v[0] for k, v in b[2].items() if "/sp_" in k}
        print(f"seq (h): {base.name} ({base.family}) full width, depth "
              f"{base.num_layers}{', batch 1 x ' + str(SP_SEQ_S) if batch1 else ''}, "
              f"seq_parallel on a (1, 1) mesh vs no SP on {CARD}: losses "
              f"{b[0]} vs {a[0]} (max rel {lrel:.2e}, bit-equal "
              f"{b[0] == a[0]}); step ms {_ms_list(b[1])} vs "
              f"{_ms_list(a[1])}; SP collectives {json.dumps(sp)}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        need = {"all_gather/sp_tp_in", "reduce_scatter/sp_tp_out",
                "reduce_scatter/sp_tp_in_grad", "all_gather/sp_tp_out_grad"}
        if base.family != "dense":
            need.add("all_gather/sp_whole")
        if batch1:
            need.add("all_gather/k_rows")
        if not lrel <= SEQ_LOSS_TOL or a[2] or not need <= set(b[2]):
            raise AssertionError(f"seq (h) {arch}: losses rel {lrel}, "
                                 f"collectives {sorted(b[2])} lack "
                                 f"{need - set(b[2])} (no SP {a[2]})")
        check_freed(f"seq (h) {arch}")


# ---------------------------------------------------------------------------
# Phase 22: MoE over the DP axis on a (1, 1) mesh
# ---------------------------------------------------------------------------

MOE_DP_LAYERS = 8          # olmoe-1b-7b's depth for the AdamW steps
MOE_DP_STEPS = 2
MOE_DP_FORMS = ("global", "shard_map")


def moe_dp_phase() -> None:
    """Phase 22 (module docstring): the split MoE train step and
    slot-sharded MoE serving on a (1, 1) mesh, in both of the
    reference's forms, against no mesh."""
    import numpy as np
    import torch
    from repro_torch import optim
    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as sh
    from repro_torch.engine import DecomposeEngine, EngineConfig
    from repro_torch.kernels import ops
    from repro_torch.runtime import steps
    from repro_torch.serving import Engine
    mesh = _mesh()
    tcfg = get_arch(MOE_ARCH).replace(num_layers=MOE_DP_LAYERS)
    batches = _train_batches(tcfg, MOE_DP_STEPS)

    def train(cfg, on: bool):
        params = init_weights(cfg)
        opt = optim.make_optimizer(cfg, warmup=1)
        state = opt.init(params)
        step = steps.make_train_step(cfg, opt, mesh=mesh if on else None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        sh.reset_collective_counts()
        losses, ms = [], []
        for batch in batches:
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            losses.append(m["loss"].item())
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out = (losses, ms, peak, ops.launch_counts(),
               sh.collective_counts())
        del params, state, step, opt
        torch.cuda.empty_cache()
        return out

    base = train(tcfg, False)
    for form in MOE_DP_FORMS:
        cfg = tcfg.replace(moe_shard_map=form == "shard_map")
        run = train(cfg, True)
        stats = ("all_gather/moe_counts", "all_reduce/moe_route",
                 "all_reduce/moe_route_grad") if form == "global" else (
                     "all_reduce/aux", "all_reduce/aux_grad")
        print(f"moe_dp (a) {form}: {cfg.name} depth {cfg.num_layers}, "
              f"{MOE_DP_STEPS} AdamW steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
              f"with the batch split over a (1, 1) mesh: losses {run[0]} "
              f"vs no mesh {base[0]}, bit-equal {run[0] == base[0]}; step "
              f"ms {_ms_list(run[1])} vs {_ms_list(base[1])}; peak GiB "
              f"{run[2]:.2f} vs no mesh {base[2]:.2f}; collectives "
              f"{json.dumps(run[4])}", flush=True)
        if run[0] != base[0] or any(run[3].values()) \
                or any(base[3].values()) or base[4] \
                or not all(run[4].get(k, (0,))[0] for k in stats):
            raise AssertionError(f"moe_dp (a) {form}: losses {run[0]} != "
                                 f"{base[0]}, or port kernels launched, or "
                                 f"the collectives {run[4]} lack {stats}")

    cfg = get_arch(MOE_ARCH)
    params = init_weights(cfg)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, n, dtype=np.int32)
               for n in SERVE_LENS]

    def engine(c, on: bool, block: int):
        ecfg = EngineConfig(mesh=mesh if on else None)
        return lambda: Engine(c, params, slots=4, max_len=1024,
                              decompose_engine=DecomposeEngine(ecfg),
                              device="cuda", decode_block=block)
    eng, want, launches, peak0 = serve_once(engine(cfg, False, 1), prompts,
                                            32, title="moe_dp (b)")
    st0 = eng.stats
    del eng
    for form in MOE_DP_FORMS:
        c = cfg.replace(moe_shard_map=form == "shard_map")
        for block in (1, FUSED_BLOCK):
            sh.reset_collective_counts()
            eng, toks, launches, peak = serve_once(
                engine(c, True, block), prompts, 32,
                title=f"moe_dp (b) {form}")
            st = eng.stats
            counts = sh.collective_counts()
            sharded = eng.shard.sharded
            del eng
            print(f"moe_dp (b) {form}, decode_block={block}: slot-sharded "
                  f"{sharded}, tokens equal to no mesh {toks == want}; "
                  f"decode_tok/s {st.decode_tok_s:.2f} vs no mesh "
                  f"{st0.decode_tok_s:.2f}; peak_mem_gib {peak:.2f} vs "
                  f"{peak0:.2f}; collectives {json.dumps(counts)}",
                  flush=True)
            if toks != want or not sharded or any(launches.values()):
                raise AssertionError(f"moe_dp (b) {form} block {block}: "
                                     f"tokens differ from no mesh's, the "
                                     f"slots are not sharded, or port "
                                     f"kernels launched {launches}")
    del params


# ---------------------------------------------------------------------------
# Phase 23: the activation-decomposition forward on a mesh
# ---------------------------------------------------------------------------

def dist_rest_activation(cfg, params) -> None:
    """Phase 23: phase 6's decomposed forward (full llama2-7b, [1, 4096],
    10 decomposed layers at rank 20, bf16) through
    ``make_decomposed_forward_step(..., mesh=)`` on a (1, 1) mesh, with
    ``seq_parallel`` off and on (a one-rank "model" group: every
    collective a copy), against no mesh: the logits bit-equal, the kernel
    launches equal (phase 6's counts), the kernel route against the plain
    one within phase 6's bf16 bar on each mesh run, and under SP one
    ``sp_whole`` gather and one ``sp_split`` around each decomposed
    block.  Prints each run's ms beside the card."""
    import torch
    from unittest import mock
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import tp as TP
    from repro_torch.kernels import ops
    from repro_torch.runtime.steps import make_decomposed_forward_step
    policy, engines = act_engines(cfg)
    n_dec = len(policy.decomposed_layers())
    tokens = act_tokens(cfg, 0)
    mesh = _mesh()
    runs = {"no mesh": (cfg, None), "(1, 1)": (cfg, mesh),
            "(1, 1) SP": (cfg.replace(seq_parallel=True), mesh)}
    splits = [0]
    real_split = TP.sp_split

    def split(x, sp):
        splits[0] += bool(sp)
        return real_split(x, sp)
    out, ms = {}, {}
    for tag, (c, m) in runs.items():
        fwd = make_decomposed_forward_step(c, engines["cuda"], m)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        sh.reset_collective_counts()
        splits[0] = 0
        with mock.patch.object(TP, "sp_split", split):
            logits = fwd(params, tokens)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        coll = {k: v[0] for k, v in sh.collective_counts().items()}
        ms[tag], every = median_ms(lambda: fwd(params, tokens))
        gap = None
        if m is not None:
            ref = make_decomposed_forward_step(c, engines["reference"], m)(
                params, tokens).float()
            gap = ((logits.float() - ref).norm() / ref.norm()).item()
            del ref
        out[tag] = logits
        print(f"dist_rest: {tag}: launches " + json.dumps(
            {k: v for k, v in launches.items() if v}) + f", kernel vs "
            f"plain route logits rel L2 {gap}, sp_whole gathers "
            f"{coll.get('all_gather/sp_whole', 0)}, sp_split calls "
            f"{splits[0]}, collectives {json.dumps(coll)}; forward ms "
            f"(median of 3) {ms[tag]:.2f} {every} on {CARD}", flush=True)
        if launches != ACT_LAUNCHES:
            raise AssertionError(f"{tag}: launches {launches} != "
                                 f"{ACT_LAUNCHES}")
        if not bool(torch.isfinite(logits.float()).all()):
            raise AssertionError(f"{tag}: non-finite logits")
        if gap is not None and not gap <= ACT_LOGITS_TOL:
            raise AssertionError(f"{tag}: kernel and plain routes differ "
                                 f"by {gap} (tol {ACT_LOGITS_TOL})")
        sp = c.seq_parallel
        if (coll.get("all_gather/sp_whole", 0), splits[0]) != (
                (n_dec, n_dec) if sp else (0, 0)):
            raise AssertionError(f"{tag}: sp_whole {coll} / sp_split "
                                 f"{splits[0]} around {n_dec} blocks")
    base = out.pop("no mesh")
    equal = {tag: torch.equal(lg, base) for tag, lg in out.items()}
    print(f"dist_rest: logits bit-equal to no mesh's: {json.dumps(equal)}",
          flush=True)
    if not all(equal.values()):
        raise AssertionError(f"mesh logits differ from no mesh's: {equal}")


def phase_train(profile: bool = False) -> tuple:
    """Phase 17: (a), (b), (c); returns (b)'s kernel launch counts and
    (a)'s figures.  ``profile``: also profile one kernel-route step of
    (b)."""
    granite = train_granite()
    check_freed(TRAIN_ARCH)
    counts = train_mamba2(profile)
    check_freed(MAMBA_ARCH)
    train_restart()
    check_freed("train")
    return counts, granite


FIG2_SHAPES = ((4096, 468), (4096, 4096))   # the paper's and the path's
FIG2_RANKS = (1, 10, 20, 50)
FIG2_DECAY = 0.07        # the Fig. 2 benchmark's spectrum, exp(-0.07 i)
FIG2_ROUTE_TOL = 1e-4    # singular values, kernel vs reference route
FIG2_ORACLE_GAP = 0.02   # Lanczos's error over the oracle's, at most
FIG2_SCAN = 20           # iterations past the rank the 2 % scan may take
FIG2_RUNS = 5            # timed runs per contender (median)
STATE_TOL = 0.01         # dry-run state bytes vs the card's


def fig2_matrix(s: int, h: int, seed: int = 0):
    """The Fig. 2 benchmark's activation on the card: orthonormal U [S, H]
    and V [H, H] (QR on the card of numpy ``RandomState(seed)`` normals)
    around the spectrum exp(-FIG2_DECAY i), float32."""
    import numpy as np
    import torch
    g = np.random.RandomState(seed)
    u = torch.linalg.qr(torch.from_numpy(
        g.standard_normal((s, h)).astype(np.float32)).cuda())[0]
    v = torch.linalg.qr(torch.from_numpy(
        g.standard_normal((h, h)).astype(np.float32)).cuda())[0]
    sv = torch.exp(-FIG2_DECAY * torch.arange(h, device="cuda",
                                              dtype=torch.float32))
    return ((u * sv) @ v.T).contiguous()


def fig2_card() -> None:
    """Phase 21 (a): Fig. 2's contenders on the card at each shape and
    rank: the scalar ``lanczos_svd`` (iters min(r + 6, H)) through the
    re-orth kernels (B = 1) and through ``backend="reference"``,
    ``qr_iteration_svd`` (8 iterations) and ``randomized_svd``, each
    one's error beside the oracle's and its median time; the kernel
    route's singular values within FIG2_ROUTE_TOL of the reference
    route's; the fewest iterations (r + 6, r + 8, ...) at which the
    kernel route's error is within FIG2_ORACLE_GAP of the oracle's, found
    within FIG2_SCAN iterations past the rank, and its time; the re-orth
    launches exactly those the iterations imply (k left and k − 1 right
    steps a run of k)."""
    import torch
    from repro_torch.core import lanczos as lz, svd_alt as alt
    from repro_torch.engine.engine import default_z0
    from repro_torch.kernels import ops
    hooks = {r: ops.make_batched_hooks(backend=r)
             for r in ("cuda", "reference")}
    want = {"reorth_left_batched": 0, "reorth_right_batched": 0}

    def lanczos(route, a, r, k, z0):
        if route == "cuda":
            want["reorth_left_batched"] += k
            want["reorth_right_batched"] += k - 1
        return lz.lanczos_svd(a, r, k, z0=z0, hooks=hooks[route])

    ops.reset_launch_counts()
    for s, h in FIG2_SHAPES:
        a = fig2_matrix(s, h)
        z0 = torch.from_numpy(default_z0(h)).cuda()
        err = lambda out: float(alt.reconstruction_error(a, *out))  # noqa
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        uo, so, vo = torch.linalg.svd(a, full_matrices=False)
        ev[1].record()
        torch.cuda.synchronize()
        o_ms = ev[0].elapsed_time(ev[1])
        for r in FIG2_RANKS:
            k = min(r + 6, h)
            e_o = err((uo[:, :r], so[:r], vo[:r]))
            gen = lambda seed: torch.Generator(  # noqa: E731
                device="cuda").manual_seed(seed)
            runs = {
                "lanczos_kernel": lambda: lanczos("cuda", a, r, k, z0),
                "lanczos_reference": lambda: lanczos("reference", a, r, k,
                                                     z0),
                "qr_iteration": lambda: alt.qr_iteration_svd(
                    a, r, 8, generator=gen(1)),
                "randomized": lambda: alt.randomized_svd(
                    a, r, generator=gen(2))}
            outs, line = {}, []
            for name, fn in runs.items():
                outs[name] = fn()
                ms, _ = median_ms(fn, FIG2_RUNS)
                e = err(outs[name])
                line.append(f"{name} {e:.5f} ({e / e_o - 1:+.4f}) "
                            f"{ms:.3f} ms")
            s_k, s_r = outs["lanczos_kernel"][1], outs["lanczos_reference"][1]
            gap = float((s_k - s_r).abs().max() / s_r.abs().max())
            hit = None
            for kk in range(k, min(r + FIG2_SCAN, h) + 1, 2):
                if err(lanczos("cuda", a, r, kk, z0)) <= \
                        (1 + FIG2_ORACLE_GAP) * e_o:
                    hit = kk
                    break
            hit_ms = median_ms(lambda: lanczos("cuda", a, r, hit, z0),
                               FIG2_RUNS)[0] if hit else float("nan")
            print(f"fig2: [{s}, {h}] rank {r} iters {k}: oracle {e_o:.5f} "
                  f"(full SVD {o_ms:.1f} ms, 1 run); " + "; ".join(line)
                  + f"; kernel vs reference route s {gap:.2e}; within "
                  f"{FIG2_ORACLE_GAP:.0%} of the oracle at iters {hit} "
                  f"({hit_ms:.3f} ms)", flush=True)
            if not gap <= FIG2_ROUTE_TOL:
                raise AssertionError(f"fig2: [{s}, {h}] rank {r}: kernel "
                                     f"route's singular values {gap:.2e} "
                                     f"from the reference route's")
            if hit is None:
                raise AssertionError(
                    f"fig2: [{s}, {h}] rank {r}: Lanczos not within "
                    f"{FIG2_ORACLE_GAP:.0%} of the oracle's error by "
                    f"{min(r + FIG2_SCAN, h)} iterations")
        del a, uo, so, vo
    got = {n: ops.launch_counts()[n] for n in want}
    print(f"fig2: re-orth launches {got} (the iterations imply {want})",
          flush=True)
    if got != want:
        raise AssertionError(f"fig2: re-orth launches {got} != {want}")


def dryrun_vs_card(granite: dict) -> None:
    """Phase 21 (b): ``launch.dryrun``'s record of phase 17 (a)'s
    configuration (granite-3-2b, 4 x 512, remat "full", AdamW) on a
    (1, 1) mesh without ZeRO-1 (as phase 17 runs it, the DP step at
    world 1), shape-only on the host, against phase 17 (a)'s run on
    the card: the parameter and AdamW state bytes within STATE_TOL (both
    exact counts), the predicted peak beside the measured (the gap is
    printed, not gated) and the roofline terms beside the measured step
    (model FLOPs over step time x the BF16 peak)."""
    from repro_torch import optim
    from repro_torch.configs import ShapeSpec, get_arch
    from repro_torch.launch import dryrun
    cfg = get_arch(TRAIN_ARCH)
    t0 = time.perf_counter()
    rec = dryrun.run_cell(
        cfg, ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train"),
        mesh_shape=((1, 1), ("data", "model")), zero1=False,
        optimizer=optim.make_optimizer(cfg, warmup=1))
    m = rec["memory"]
    state = m["param_bytes"] + m["opt_state_bytes"]
    gap = state / granite["state_bytes"] - 1
    print(f"dryrun: {cfg.name} 4 x 512 on (1, 1), shape-only on the host in "
          f"{time.perf_counter() - t0:.1f} s: state {state / 2 ** 30:.3f} "
          f"GiB predicted vs {granite['state_bytes'] / 2 ** 30:.3f} GiB "
          f"allocated on the card ({gap:+.4%}); peak "
          f"{m['peak_bytes'] / 2 ** 30:.2f} GiB predicted vs "
          f"{granite['peak_bytes'] / 2 ** 30:.2f} GiB measured "
          f"({m['peak_bytes'] / granite['peak_bytes'] - 1:+.2%}); "
          f"{rec['flops_per_device']:.4e} FLOPs "
          f"({rec['flops_by_dtype']}), {rec['hbm_bytes_per_device']:.4e} "
          f"bytes of eager traffic, {rec['host_reads']} host reads "
          f"answered", flush=True)
    t = rec["roofline"]
    peak = rates().PEAK_FLOPS_BF16
    mfu = rec["model_flops_global"] / (granite["step_ms"] / 1e3 * peak)
    print(f"roofline: {cfg.name} train 4 x 512: compute_s "
          f"{t['compute_s']:.4f} memory_s {t['memory_s']:.4f} collective_s "
          f"{t['collective_s']:.4f} (analytic, H100 SXM datasheet rates); "
          f"measured step {granite['step_ms']:.1f} ms; model FLOPs "
          f"{rec['model_flops_global']:.4e} / (step x "
          f"{peak / 1e12:.0f} TFLOP/s) = {mfu:.4f}", flush=True)
    if "refused" in rec or not abs(gap) <= STATE_TOL:
        raise AssertionError(f"dryrun: state bytes {state} vs "
                             f"{granite['state_bytes']} on the card "
                             f"({rec.get('refused', f'{gap:+.4%}')})")


def phase_tools(granite=None) -> None:
    """Phase 21: (a) Fig. 2 on the card, (b) the dry-run against phase
    17 (a) (run here when phase 17 did not run)."""
    fig2_card()
    if granite is None:
        granite = train_granite()
        check_freed(TRAIN_ARCH)
    dryrun_vs_card(granite)


PHASES = ("kernels", "serve", "conformance", "activation", "paged",
          "async", "sampler", "obs", "mamba2", "hybrid", "moe", "fig12",
          "variants", "modal", "train", "mesh", "model", "seq", "tools",
          "moe_dp", "dist_rest")


def check_freed(what: str, limit_gib: float = 0.5) -> None:
    """Once the phases of a model are over and its weights dropped, the
    device holds less than ``limit_gib`` (every engine of the model
    freed without a garbage-collection pass)."""
    import torch
    held = torch.cuda.memory_allocated() / 2 ** 30
    print(f"freed: {what} dropped, {held:.3f} GiB still allocated",
          flush=True)
    if held >= limit_gib:
        raise AssertionError(f"{what}: {held:.2f} GiB still allocated "
                             f"after its weights and engines were dropped")
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="profile the serving run, one decomposed "
                         "forward, the shared-prefix paged run, the "
                         "Mamba2, hybrid and MoE serving runs and one "
                         "mamba2-780m train step, and print each one's "
                         "device busy share and kernel time table")
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run (a partial run, "
                         f"for development; prints no result): {PHASES}")
    args = ap.parse_args()

    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail("src/repro_torch is not beside this script")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device (torch.cuda.is_available() is False)")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    print(smi[0], flush=True)
    global CARD
    CARD = smi[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # the tuner's cache lives in a temporary file for this run only
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_tune_")
    os.environ["REPRO_TUNE_CACHE"] = os.path.join(tmp.name, "cache.json")
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.obs import phase_scope
    t0 = time.perf_counter()
    # the sources without a current library: the compile watch must count
    # exactly these nvcc builds (phase 16)
    nvcc_built = sum(not build._target(s).exists()
                     for s in build.CSRC.glob("*.cu"))
    with phase_scope("build"):
        libs = build.build_all(verbose=True)
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f}s",
          flush=True)

    only = set(args.only.split(",")) if args.only else set(PHASES)
    unknown = only - set(PHASES)
    if unknown:
        return fail(f"unknown phases {sorted(unknown)}; have {PHASES}")

    @contextlib.contextmanager
    def phase(name):
        t = time.perf_counter()
        yield
        print(f"phase {name}: {time.perf_counter() - t:.1f} s", flush=True)

    cfg = get_arch("llama2-7b")
    rows = serve_launches = slot_tokens = long_tokens = None
    if "kernels" in only:
        with phase("kernels"):
            rows = phase_kernels(cfg)
    if only & {"serve", "conformance", "activation", "paged", "async",
               "sampler", "obs", "mesh", "model", "seq", "dist_rest"}:
        params = init_weights(cfg)
        if "serve" in only:
            with phase("serve"):
                serve_launches, slot_tokens, long_tokens = serve_llama(
                    cfg, params, args.profile)
            torch.cuda.empty_cache()
        if "conformance" in only:
            with phase("conformance"):
                conformance(cfg)
                conformance_mamba2()
        if "activation" in only:
            with phase("activation"):
                act = activation_llama(cfg, params, args.profile)
            torch.cuda.empty_cache()
        if "paged" in only:
            with phase("paged"):
                if slot_tokens is not None:
                    paged_same_traffic(cfg, params, slot_tokens, long_tokens,
                                       args.profile)
                paged = paged_prefix_llama(cfg, params, args.profile)
        if "async" in only:
            with phase("async"):
                phase_async(cfg, params, slot_tokens)
        if "sampler" in only:
            with phase("sampler"):
                sampler_llama(cfg, params)
        if "obs" in only:
            with phase("obs"):
                phase_obs(cfg, params, slot_tokens, nvcc_built)
        if "mesh" in only:
            with phase("mesh (a, b)"):
                mesh_serving(cfg, params)
        if "model" in only:
            with phase("model (a)"):
                model_axis_serving(cfg, params)
        if "seq" in only:
            with phase("seq (b')"):
                seq_dkv_prefill(cfg, params)
            with phase("seq (b)"):
                seq_dkv_decode(cfg, params)
        if "dist_rest" in only:
            from repro_torch.launch.mesh import shutdown_distributed
            try:
                with phase("dist_rest"):
                    dist_rest_activation(cfg, params)
            finally:
                shutdown_distributed()
        # a dropped engine frees its cache and weights at once (its family
        # holds it weakly), so no garbage collection runs between phases
        del params
        check_freed("llama2-7b")
    for name, arch, serve in (("mamba2", MAMBA_ARCH, serve_mamba2),
                              ("hybrid", HYBRID_ARCH, serve_hybrid),
                              ("moe", MOE_ARCH, serve_moe)):
        if name in only:
            with phase(name):
                m_cfg = get_arch(arch)
                m_params = init_weights(m_cfg)
                got = serve(m_cfg, m_params, args.profile)
                if name == "mamba2":
                    mamba = got
                del m_params
                check_freed(arch)
    if "fig12" in only:
        with phase("fig12"):
            fig = phase_fig12()
    for name, archs, serve in (("variants", VARIANT_ARCHS, serve_variant),
                               ("modal", MODAL_ARCHS, serve_modal)):
        if name not in only:
            continue
        with phase(name):
            for arch in archs:
                t = time.perf_counter()
                v_cfg = get_arch(arch)
                v_params = init_weights(v_cfg)
                print(f"init: {nonzero_biases(v_params)} bias, norm-bias "
                      f"and gate tensors drawn N(0, {BIAS_STD}^2)",
                      flush=True)
                serve(v_cfg, v_params, args.profile)
                if arch == "starcoder2-7b":
                    activation_variant(v_cfg, v_params)
                del v_params
                check_freed(arch)
                print(f"{name}: {arch} {time.perf_counter() - t:.1f} s",
                      flush=True)
    granite = None
    if "train" in only:
        with phase("train"):
            train, granite = phase_train(args.profile)
    if "mesh" in only:
        with phase("mesh (c)"):
            mesh_training()
            check_freed("mesh")
    if "model" in only:
        from repro_torch.launch.mesh import shutdown_distributed
        try:            # a failure still raises, with the group torn down
            with phase("model (b, c)"):
                model_axis_training()
                check_freed("model")
            with phase("model (d)"):
                model_axis_families()
            with phase("model (e)"):
                model_axis_training(MAMBA_ARCH, ("e", "e"))
                check_freed("model (e)")
        finally:
            shutdown_distributed()
    if "seq" in only:
        from repro_torch.launch.mesh import shutdown_distributed
        try:
            with phase("seq (a)"):
                seq_long_decode()
            with phase("seq (c)"):
                seq_mamba2()
            with phase("seq (d, e)"):
                seq_train_adafactor()
            with phase("seq (f)"):
                seq_prefill_memory()
            with phase("seq (g)"):
                seq_modal()
            with phase("seq (h)"):
                seq_sp_families()
        finally:
            shutdown_distributed()
    if "tools" in only:
        with phase("tools"):
            phase_tools(granite)
    if "moe_dp" in only:
        from repro_torch.launch.mesh import shutdown_distributed
        try:
            with phase("moe_dp"):
                moe_dp_phase()
                check_freed("moe_dp")
        finally:
            shutdown_distributed()
    if only != set(PHASES):
        print(f"only: phases {sorted(only)} passed (no result line: a "
              f"partial run)", flush=True)
        return 0
    # each kernel's launches from the run of the path that uses it: the
    # serving run for the batched re-orth pair and dkv, the activation
    # forward for the rest (its re-orth launches are all at B = 1), the
    # shared-prefix run for the paged dkv kernel, Mamba2 serving for the
    # SSD kernel, the Fig. 12 A/Bs for the matvec pair
    launches = dict(serve_launches, lowrank_matmul=act["lowrank_matmul"],
                    outlier_stats=act["outlier_stats"],
                    reorth_right=act["reorth_right_batched"],
                    reorth_left=act["reorth_left_batched"],
                    dkv_attention_stats_paged=paged[
                        "dkv_attention_stats_paged"],
                    ssd_chunk_intra=mamba["ssd_chunk_intra"],
                    ssd_chunk_intra_bwd=train["ssd_chunk_intra_bwd"],
                    **{k: fig[k] for k in MATVEC_LINES})
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    seen, kernels = set(), []
    for rec in rows:                     # main-path shapes: first of a name
        if rec["name"] in seen:
            continue
        seen.add(rec["name"])
        rec["launches"] = launches[rec["name"]]
        kernels.append({k: rec[k] for k in keys})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
