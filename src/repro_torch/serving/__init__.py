"""Serving engine: slot-based continuous batching.

Counterpart of the slot mode of ``repro.serving.Engine``: ``slots``
concurrent sequences share one cache; a finished sequence frees its slot
at once; queued requests prefill into free slots.  Admission is per
slot (``admission="per_slot"``, the default): only the newly admitted
requests are prefilled (prompt length rounded up to the scheduler bucket,
batch to a power of two) and their fresh cache rows are spliced into the
live cache — live slots are never re-prefilled.  ``admission="gang"``
keeps the legacy policy for A/B runs: one whole-slot-batch prefill per
admission, into an all-free engine except for the dense family.
Everything family-specific (cache layout, prefill, splice, decode,
fused blocks, tail folds, the scheduler's admission cost) lives behind
the ``ServingFamily`` of ``serving.families``: ``dense``, ``moe``,
``ssm`` (Mamba2 state slots), ``hybrid`` (Zamba2), ``vlm``, ``audio``
or ``transformer-dkv`` (dense configs only; selected when the resolved
decomposed-KV rank is > 0, with its tail length and factorization).

Admission dispatches each prefill as a ticket and completes it with a
splice and the first-token sample (``serving.families.PrefillTicket``).
A sync engine completes every ticket where it dispatched it.
``prefill_async=True`` (DESIGN.md §12) runs the prefills on one side
stream of the card (``platform.prefill_stream``; on the host a ticket is
ready at dispatch) and completes them in one of two orders:
``ready_order="deterministic"`` at their dispatch round, which replays
the sync schedule through the ticket machinery (tokens equal the sync
engine's), or ``"ready"``: tickets wait in a pool, reserving their
slots, while decode goes on, and each is spliced at the first step
boundary where its event has completed (with nothing live to decode,
the pool's head is completed at once).  ``cancel_pending`` unwinds the
pool.  Async admission with ``admission="gang"`` is refused.

``paged=True`` (decomposed KV only) swaps the slab for the page pools
of ``serving.paged``: prefix U rows and dense tails in refcounted pages
behind per-slot block tables, and with ``EngineConfig.kv_prefix_cache``
> 0 a prefix cache whose hits admit with a tail-only suffix prefill (no
prefix forward, no Lanczos).  Before each admission the family reserves
pages (``reserve``); a batch the pools cannot take yet is requeued in
arrival order and counted as a stall, and with nothing live to free
pages that is a ``RuntimeError``.  A finished slot's pages are released
at once (``free_slot``).

A request stops the moment it emits ``eos_id`` (its own, else the
engine's) or one of its ``stop_tokens``, or when it spends its token
budget or the cache; ``EngineStats`` counts the two kinds of finish.
Sampling runs on the device (see below).

``decode_block=1`` decodes one token per live slot per step, with one
host readback per step.  ``decode_block > 1`` runs up to that many steps
as ONE fixed-length loop (``models.api.run_decode_block``), replayed as a
captured CUDA graph on the card (``serving.graphs``), with one readback
per block.  Tokens equal the single-step engine's by construction: the
host caps each block at the next budget end, tail fold and admission
round (``_block_len``), and the block halts on device after the first
step in which a slot samples a stop token, so folds, admissions and
finishes happen between blocks at the rounds the single-step engine runs
them.  ``"auto"`` resolves the block through ``repro_torch.tune``.

Sampling is greedy by default; ``sampler=categorical_sampler(T)`` draws
from softmax(logits / T) with keys ``fold_in(fold_in(prng_key(
sample_seed), stream), round)`` (``repro_torch.sampling``): stream 0
for decode, stream 1 for the first tokens sampled at admission, both
indexed by the engine's round counter, so single-step and fused engines
draw the same tokens for any block sizes (a fused block's round is part
of its graph's feed).

``obs=Observability(...)`` (``repro_torch.obs``) mounts the engine's
stats and graph counters on its registry and, with ``trace=True``,
records request-lifecycle spans, as the reference's engine does.  It is
host-side only: tokens, launches and the host's reads of the device are
the same with it on or off, and spans end only at readbacks the engine
already does (a span that ends elsewhere covers host enqueue time).

Mesh-parallel serving (DP over slots).  With a mesh on the decompose
engine's config (``EngineConfig.mesh``, axes ("data", "model") or
("pod", "data", "model"); ``launch.mesh``) the engine runs SPMD, one
process per device: every rank runs the same host logic on the same
requests (scheduler, admission, folds, stops: their state is global and
identical on every rank), while each rank holds only its block of the
slots (``models.api.SlotShard``: slots / dp rows of every per-slot
cache leaf, or every slot where dp does not divide the slot count, as
the rules' fallback says).  An admission's prefill runs on every rank
(its decomposition DP-sharded by the decompose engine) and each rank
splices only the slots it holds; cache geometry (time and rank axes)
changes on every rank alike, so a rank's slots see the arithmetic of
the single-device engine.  Each decode step, or fused block, runs on the
rank's slots, and the sampled tokens are all-gathered over the DP group
before the one host readback (after a graph's replay, never inside
it), so every rank's host sees every slot's token.  A keyed sampler
draws a slot's row by its global index (``row0``).  Collectives must be
issued in the same order on every rank, so what could differ is agreed:
``decode_block="auto"`` resolves on DP rank 0 and is broadcast; an
async ``"ready"`` pool splices a ticket only when it is ready on every
rank (an all-reduce MIN of the done flags).  A fused block halts on a
stop token only on the rank that holds the slot, so the block takes the
fewest steps any rank took (they travel with the gathered tokens) and a
rank that ran on undoes its extra steps (``ServingFamily.
undo_overrun``: nothing for a K/V cache, whose rows past a slot's
position are rewritten alike before they are read; the dense tail rows
for decomposed KV); a family whose state advances in place (Mamba2,
hybrid) runs one-step blocks instead while a live slot has stop tokens
on a sharded mesh of more than one rank.  The MoE family's expert
capacity couples the slots of a decode batch: its decode steps run
under ``distributed.tokens.use``, so the ranks' blocks route as the
whole batch does on one device (``MoEServing``).

Tensor parallelism (a "model" axis larger than 1).  Every family
(dense, decomposed-KV slab and paged, moe, ssm, hybrid, vlm and audio;
sync and async, fused blocks) keeps each rank's ``params_sharding``
blocks (``sharding.shard_params``) and ``cache_pspec``'s blocks of the
caches (kv heads over "model", else head_dim; decomposed KV: U and the
page pools whole, the factors' kv width sharded; Mamba2: the conv
window's channel block and the ssm state's heads; the vlm and audio
cross K/V as the self K/V), and every model call of a step runs under
``distributed.tp.use``: the rank's heads and columns, the row-parallel
all-reduces, the logits all-gathered over "model" before sampling, so
every model rank draws the same token.

``decompose_kv_rank``/``dkv_tail``/``dkv_exact`` override the decompose
engine's ``kv_rank``/``kv_tail``/``kv_exact`` with the reference's
precedence: an explicit knob wins (``decompose_kv_rank=0`` disables
decomposed KV), None inherits the engine config's; without a decompose
engine the defaults are rank 0 and tail 16.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..distributed import sharding as sh
from ..distributed import tp as TP
from ..engine import DecomposeEngine, EngineConfig
from ..kernels import build
from ..models.api import SlotShard, shard_params
from ..obs import (NULL_SPAN, LatencySeries, MetricsRegistry, Observability,
                   phase_scope, stats_snapshot)
from ..platform import host_to_device, prefill_stream, resolve_device
from ..sampling import (categorical_sampler, fold_in, greedy_sampler,
                        prng_key, takes_key)
from .families import (PrefillTicket, ServingFamily, family_class,
                       family_names)
from .graphs import BlockGraphs

__all__ = ["ADMISSIONS", "READY_ORDERS", "Engine", "EngineStats",
           "PrefillTicket", "Request", "Scheduler", "ServingFamily",
           "categorical_sampler", "family_names", "greedy_sampler"]

ADMISSIONS = ("per_slot", "gang")
READY_ORDERS = ("ready", "deterministic")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray               # [S] int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None     # stop token (None = engine default)
    stop_tokens: Tuple[int, ...] = ()   # extra stop tokens
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0            # perf_counter stamps (0.0 = not yet)
    t_dispatch: float = 0.0          # admission started
    t_first: float = 0.0             # first token out
    t_last: float = 0.0
    t_done: float = 0.0
    seq: int = -1                    # arrival stamp (Scheduler.submit)


class EngineStats:
    """Serving counters and latencies (host clock, seconds), mounted on a
    ``repro_torch.obs`` :class:`MetricsRegistry` under the reference's
    names (``serving_<name>``, ``serving_wall_seconds``,
    ``serving_ttft_seconds``, …), as ``repro.serving.EngineStats`` is.

    Counters read and write as plain numbers (``stats.prefills += 1``).
    The latency members (``ttft_s``/``ttft_queue_s``/``ttft_compute_s``/
    ``itl_s``) ``append``/``extend`` and iterate like lists, but are
    O(1)-memory streaming histograms with a capped recent-sample
    reservoir (``obs.registry.RESERVOIR_CAP``): ``len()`` is the total
    observation count, so ``len(itl_s) == tokens_out`` holds, and
    iteration yields the recent window only.  ``mean_*`` come from the
    exact streaming sum and count, p50/p95/p99 from ``.quantile(q)``.

    ``prefix_hits``/``prefix_misses`` count admitted requests by prefix
    lookup outcome, ``stalls`` admissions deferred on page capacity
    (paged serving).  ``decode_steps`` counts decode rounds and
    ``blocks`` decode launches (equal unless fused blocks batch rounds);
    ``stopped_eos``/``stopped_budget`` count finishes on a stop token
    and on the budget or the cache end.  Each TTFT splits into its queue
    wait (submit → dispatch, ``ttft_queue_s``) and its prefill
    (dispatch → first token, ``ttft_compute_s``);
    ``prefill_inflight_peak`` is the most tickets an async ``"ready"``
    engine held in flight at once.

    The port also keeps two host-clock sums outside the registry (so its
    metric set stays the reference's): ``prefill_s`` sums admissions
    (forward prefill, KV factorization, splice and the first-token
    readback) and ``decode_s`` decode rounds (tail folds included).  Both
    end in a host readback of sampled tokens, so on the card they cover
    the device work they launched."""

    _COUNTERS = (
        ("prefills", "admitted requests (one per request)"),
        ("prefill_batches", "admission batches (prefill launches)"),
        ("decode_steps", "decode rounds (one token per live slot)"),
        ("blocks", "decode launches (== steps unless the fused loop "
                   "batches rounds per dispatch)"),
        ("tokens_out", "decode tokens emitted"),
        ("tail_folds", "per-slot compress_tail events"),
        ("stopped_eos", "requests finished on a stop token"),
        ("stopped_budget", "requests finished on max_new_tokens/max_len"),
        ("prefix_hits", "admissions served from the prefix cache"),
        ("prefix_misses", "prefix lookups that fell through to prefill"),
        ("stalls", "admissions deferred on page capacity"),
        ("wall_s", "wall seconds accrued per step()"),
    )
    _GAUGES = (
        ("prefill_inflight_peak",
         "max concurrently in-flight prefill tickets (async mode)"),
    )
    _HISTS = (
        ("ttft_s", "ttft_seconds", "submit to first token"),
        ("ttft_queue_s", "ttft_queue_seconds",
         "queue wait: submit to prefill dispatch"),
        ("ttft_compute_s", "ttft_compute_seconds",
         "prefill compute: dispatch to first token"),
        ("itl_s", "itl_seconds", "inter-token latency"),
    )

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._m = {}
        for name, help_ in self._COUNTERS:
            metric = "serving_wall_seconds" if name == "wall_s" \
                else f"serving_{name}"
            self._m[name] = self.registry.counter(metric, help_)
        for name, help_ in self._GAUGES:
            self._m[name] = self.registry.gauge(f"serving_{name}", help_)
        for name, metric, help_ in self._HISTS:
            self._m[name] = LatencySeries(
                self.registry.histogram(f"serving_{metric}", help_))
        self.prefill_s = 0.0
        self.decode_s = 0.0

    def __repr__(self) -> str:
        return (f"EngineStats(prefills={self.prefills}, "
                f"tokens_out={self.tokens_out}, "
                f"decode_steps={self.decode_steps})")

    @property
    def mean_ttft_s(self) -> float:
        return self.ttft_s.mean

    @property
    def mean_ttft_queue_s(self) -> float:
        return self.ttft_queue_s.mean

    @property
    def mean_ttft_compute_s(self) -> float:
        return self.ttft_compute_s.mean

    @property
    def mean_itl_s(self) -> float:
        return self.itl_s.mean

    @property
    def decode_tok_s(self) -> float:
        return self.tokens_out / self.decode_s if self.decode_s else 0.0

    def snapshot(self, wall_s: Optional[float] = None) -> dict:
        """The uniform ``repro.obs/v1`` metrics snapshot
        (``obs.stats_snapshot``)."""
        return stats_snapshot(self, wall_s=wall_s)


def _stat_counter(name: str) -> property:
    return property(lambda self: self._m[name].value,
                    lambda self, v: self._m[name].set(v))


for _name, _ in EngineStats._COUNTERS + EngineStats._GAUGES:
    setattr(EngineStats, _name, _stat_counter(_name))
for _name, _metric, _ in EngineStats._HISTS:
    setattr(EngineStats, _name,
            property(lambda self, _n=_name: self._m[_n]))
del _name, _metric


class Scheduler:
    """FIFO queue with prefill-cost bucketing: ``next_batch`` serves the
    head of the queue plus later requests of the same bucket of
    ``cost(request)`` (the family's admission cost; the prompt length by
    default), at most ``max_admit`` of them (0 = the free slots), keeping
    a free slot for every older request of another bucket (head-bucket
    starvation guard).  Every submission gets an arrival stamp ``seq``;
    :meth:`requeue` merges a deferred batch back on it, so a deferral
    never jumps requests that arrived between the batch's members."""

    def __init__(self, bucket: int = 16, max_admit: int = 0,
                 cost: Optional[Callable[[Request], int]] = None):
        self.bucket = max(1, bucket)
        self.max_admit = max_admit
        self.cost = cost if cost is not None else (lambda r: len(r.prompt))
        self._q: List[Request] = []
        self._seq = 0

    def submit(self, req: Request) -> None:
        if req.seq < 0:
            req.seq = self._seq
            self._seq += 1
        self._q.append(req)

    def requeue(self, batch: List[Request]) -> None:
        """Return a deferred batch to the queue in ARRIVAL order."""
        self._q = sorted(self._q + list(batch), key=lambda r: r.seq)

    def __len__(self) -> int:
        return len(self._q)

    @property
    def pending(self) -> List[Request]:
        return list(self._q)

    def bucket_of(self, plen: int) -> int:
        return -(-max(int(plen), 1) // self.bucket) * self.bucket

    def next_batch(self, free_slots: int) -> List[Request]:
        if not self._q or free_slots < 1:
            return []
        cap = free_slots if self.max_admit < 1 \
            else min(free_slots, self.max_admit)
        want = self.bucket_of(self.cost(self._q[0]))
        take: List[Request] = []
        keep: List[Request] = []
        skipped = set()
        for r in self._q:
            bk = self.bucket_of(self.cost(r))
            if bk == want and len(take) + len(skipped) < cap:
                take.append(r)
            else:
                keep.append(r)
                if bk != want:
                    skipped.add(bk)
        self._q = keep
        return take


class Engine:
    """Continuous-batching engine over the config's family (dense, MoE,
    Mamba2, hybrid, VLM or audio), with the decomposed KV cache when the
    resolved rank (``decompose_kv_rank``, else the decompose engine's
    ``kv_rank``) is > 0 (dense family only), on page pools when
    ``paged``.  ``eos_id`` is the stop token of requests that name none;
    ``decode_block`` (default: the engine config's) is the fused block
    length, an int or ``"auto"``; ``prefill_async`` (default: the engine
    config's) and ``ready_order`` select async admission; ``sampler``
    (default greedy) and ``sample_seed`` pick the tokens.  ``obs`` (an
    ``obs.Observability``; default: a private registry, tracing off)
    holds the engine's stats and graph counters and, with tracing on,
    its spans: per request a ``request`` span holding ``queue``,
    ``prefill`` and ``decode`` on track ``req/<uid>``, the step loop's
    ``step``/``admit``/``decode-step``/``decode-block``/``fold``/
    ``splice``/``drain-pool`` on ``engine``, and async tickets on
    ``tickets``.  Observability is host-side only: tokens and the host's
    reads of the device are the same with it on or off."""

    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 256,
                 sampler: Optional[Callable] = None,
                 decompose_kv_rank: Optional[int] = None,
                 dkv_tail: Optional[int] = None,
                 decompose_engine: Optional[DecomposeEngine] = None,
                 dkv_exact: Optional[bool] = None,
                 device=None, paged: bool = False,
                 eos_id: Optional[int] = None, admission: str = "per_slot",
                 decode_block: Optional[Union[int, str]] = None,
                 prefill_async: Optional[bool] = None,
                 ready_order: str = "ready", sample_seed: int = 0,
                 obs: Optional[Observability] = None):
        if admission not in ADMISSIONS:
            raise ValueError(f"admission must be one of {ADMISSIONS}, got "
                             f"{admission!r}")
        if ready_order not in READY_ORDERS:
            raise ValueError(f"ready_order must be one of {READY_ORDERS}, "
                             f"got {ready_order!r}")
        if paged and admission == "gang":
            raise ValueError("paged serving admits per slot")
        self.device = resolve_device(device)
        self.obs = obs if obs is not None else Observability()
        self.trace = self.obs.tracer
        self.cfg, self.params = cfg, params
        self.slots, self.max_len = slots, max_len
        self.admission = admission
        self.eos_id = eos_id
        self.sampler = sampler or greedy_sampler
        self._key = prng_key(sample_seed)
        # an explicit knob wins (rank 0 disables decomposed KV); None
        # inherits the decompose engine's config
        if decompose_engine is not None:
            self.dengine = decompose_engine
            if decompose_kv_rank is None:
                decompose_kv_rank = decompose_engine.config.kv_rank
            if dkv_tail is None:
                dkv_tail = decompose_engine.config.kv_tail
        else:
            decompose_kv_rank = decompose_kv_rank or 0
            dkv_tail = 16 if dkv_tail is None else dkv_tail
            self.dengine = DecomposeEngine(EngineConfig(
                kv_rank=decompose_kv_rank, kv_tail=dkv_tail))
        ecfg = self.dengine.config
        self.mesh = ecfg.mesh
        self.dkv_rank = int(decompose_kv_rank)
        if self.mesh is not None:
            sh.require_groups(self.mesh, "serving")
        # the DP group, which agrees host choices between ranks
        self._dp = sh.dp_group(self.mesh) if self.mesh is not None else None
        # the mesh whose "model" axis the model runs on: each rank keeps
        # its params_sharding blocks
        self.tp_mesh = ecfg.tp_mesh
        if self.tp_mesh is not None:
            self.params = shard_params(cfg, params, self.mesh)
        self.dkv_tail = int(dkv_tail)
        self.dkv_exact = ecfg.kv_exact if dkv_exact is None \
            else bool(dkv_exact)
        # per-slot host state: next write position, low-rank prefix length,
        # effective factor rank (decomposed KV only)
        self.pos = np.zeros((slots,), np.int32)
        self.frozen_len = np.zeros((slots,), np.int32)
        self.rank_eff = np.zeros((slots,), np.int32)
        self.live: List[Optional[Request]] = [None] * slots
        self.pager = None            # serving.paged.PagedDKV when paged
        if prefill_async is None:
            prefill_async = ecfg.prefill_async
        self.prefill_async = bool(prefill_async)
        self.ready_order = ready_order
        if self.prefill_async and admission == "gang":
            raise ValueError("async prefill admits per slot (gang replaces "
                             "the whole cache: there is nothing to overlap)")
        # the side stream the async prefills run on (None: the current
        # stream, where sync engines and the host run them)
        self.prefill_stream = None
        if self.prefill_async and self.device.type == "cuda":
            self.prefill_stream = _prefill_stream(self.device)
        self._pool: List[PrefillTicket] = []       # in-flight admissions
        self._reserved = np.zeros(slots, bool)     # dispatched, not spliced
        self.admit_log: List[int] = []             # uids in dispatch order
        cls = family_class(self)
        # the slots this rank holds (all of them without a mesh)
        self.shard = SlotShard(slots, self.mesh)
        self.decode_sampler = _rows_from(self.sampler, self.shard.first)
        with TP.use(self.tp_mesh):
            self.family = cls(self, paged=paged)
            self.cache = self.family.alloc()
        self.sched = Scheduler(bucket=ecfg.sched_bucket,
                               max_admit=ecfg.sched_max_admit,
                               cost=self.family.prefill_cost)
        self.admit_every = max(1, ecfg.sched_admit_every)
        blk = ecfg.decode_block if decode_block is None else decode_block
        if blk == "auto":
            from .. import tune
            blk = tune.tuned_decode_block(
                (slots, self.family.tune_horizon(), cfg.kv_width),
                device=self.device)
            if self._dp is not None:         # DP rank 0's resolution
                blk = sh.broadcast_int(blk, self._dp, self.device,
                                       "decode_block")
        self.decode_block = max(1, int(blk))
        cap = self.family.block_cap()
        if cap is not None:
            self.decode_block = min(self.decode_block, cap)
        # the fused blocks' CUDA graphs: owned here, freed with the engine
        self.graphs = BlockGraphs(self.device, self.obs.registry)
        self.stats = EngineStats(registry=self.obs.registry)
        # open request-lifecycle spans: uid -> {"request"/"queue"/
        # "prefill"/"decode": Span} (only while tracing)
        self._req_spans: dict = {}
        # completed decode rounds (a fused block advances it by its
        # steps): admission due-ness reads it
        self._round = 0

    # -- public API ------------------------------------------------------
    @property
    def queue(self) -> List[Request]:
        return self.sched._q

    def submit(self, req: Request) -> None:
        if len(req.prompt) >= self.max_len:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens leaves no decode room "
                f"in a max_len={self.max_len} cache")
        if not req.t_submit:
            req.t_submit = time.perf_counter()
        if self.trace.enabled:
            track = f"req/{req.uid}"
            self._req_spans[req.uid] = {
                "request": self.trace.begin(
                    "request", track,
                    {"uid": req.uid, "prompt_tokens": len(req.prompt)}),
                "queue": self.trace.begin("queue", track),
            }
        self.sched.submit(req)

    def step(self) -> List[Request]:
        """Admit if due, then decode: one token per live slot, or a fused
        block of up to ``decode_block`` tokens.  Returns the requests that
        finished in this step."""
        t0 = time.perf_counter()
        step_span = self.trace.begin("step", "engine",
                                     {"round": self._round})
        finished: List[Request] = []
        try:
            with TP.use(self.tp_mesh):
                self._step(finished)
            return finished
        finally:
            step_span.end(finished=len(finished))
            self.stats.wall_s += time.perf_counter() - t0

    def _step(self, finished: List[Request]) -> None:
        if self._pool:
            # splice the tickets whose prefills have finished; with
            # nothing live to decode, complete the pool's head at once
            finished.extend(self._drain_pool(block=not self._decoding()))
        if self._round % self.admit_every == 0 or not self._occupied():
            # a "ready" engine only dispatches here: the span then
            # covers the host's enqueue alone
            with self.trace.span("admit", "engine"):
                finished.extend(self._admit())
        if self._decoding():
            finished.extend(self._decode_rounds())
        else:
            self._round += 1     # an idle step still advances the clock

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Step until no slot is live or reserved and the queue is
        empty."""
        finished: List[Request] = []
        for _ in range(max_steps):
            finished.extend(self.step())
            if not self._occupied() and not len(self.sched):
                break
        return finished

    # -- internals -------------------------------------------------------
    def _decoding(self) -> bool:
        """Any slot live (a reserved slot does not decode)."""
        return any(r is not None for r in self.live)

    def _occupied(self) -> bool:
        """Any slot live or reserved by an in-flight ticket."""
        return self._decoding() or bool(self._reserved.any()) \
            or bool(self._pool)

    def _stream_key(self, stream: int) -> int:
        """The key of a sample stream (0 decode, 1 admission)."""
        return fold_in(self._key, stream)

    def _sample_host(self, logits: torch.Tensor,
                     stream: int = 0) -> np.ndarray:
        """Sample on the device, read the tokens back (the one sync).  A
        keyed sampler draws with ``fold_in(stream key, round)``.  Stream 0
        samples decode logits, the rows of this rank's slots, whose
        tokens are gathered over the DP group first; stream 1 samples an
        admission's logits, which every rank holds whole."""
        sampler = self.decode_sampler if stream == 0 else self.sampler
        if takes_key(sampler):
            key = fold_in(self._stream_key(stream), self._round)
            toks = sampler(logits, 1, key)
        else:
            toks = sampler(logits, 1)
        if stream == 0:
            toks = self.shard.gather(toks)
        # the step's one readback: the sampled tokens
        return toks.cpu().numpy()  # dcomlint: disable=J2

    def _stops(self, req: Request) -> frozenset:
        eos = req.eos_id if req.eos_id is not None else self.eos_id
        toks = set(req.stop_tokens)
        if eos is not None:
            toks.add(eos)
        return frozenset(toks)

    def _finish(self, slot: int, req: Request, now: float, *,
                eos: bool) -> None:
        """Free a slot the moment its request stops (token or budget)."""
        req.done = True
        req.t_done = now
        self.live[slot] = None
        self.family.free_slot(slot)
        if eos:
            self.stats.stopped_eos += 1
        else:
            self.stats.stopped_budget += 1
        spans = self._req_spans.pop(req.uid, None)
        if spans:
            # Span.end is idempotent: queue/prefill already ended at their
            # own boundaries; this closes whatever is still open
            for name in ("queue", "prefill", "decode"):
                if name in spans:
                    spans[name].end()
            spans["request"].end(tokens=len(req.out_tokens), eos=eos)

    def _check_stop(self, slot: int, req: Request, now: float) -> bool:
        """Stop-token, then budget / cache-end check after a token."""
        if req.out_tokens and req.out_tokens[-1] in self._stops(req):
            self._finish(slot, req, now, eos=True)
            return True
        if (len(req.out_tokens) >= req.max_new_tokens
                or self.pos[slot] >= self.max_len - 1):
            self._finish(slot, req, now, eos=False)
            return True
        return False

    def _toks_np(self, batch: List[Request], rows: int, plen: int,
                 rows_of: Optional[List[int]] = None) -> np.ndarray:
        """Prompts LEFT-padded with token 0 to ``plen`` (as the JAX
        engine pads them), request j in row ``rows_of[j]`` (default j),
        every other row all padding."""
        toks = np.zeros((rows, plen), np.int32)
        for j, req in enumerate(batch):
            row = j if rows_of is None else rows_of[j]
            toks[row, plen - len(req.prompt):] = req.prompt
        return toks

    def _toks(self, batch: List[Request], rows: int, plen: int,
              rows_of: Optional[List[int]] = None) -> torch.Tensor:
        """:meth:`_toks_np` as a token tensor on the device."""
        return host_to_device(self._toks_np(batch, rows, plen, rows_of),
                              self.device)

    def _admit(self) -> List[Request]:
        """Drain the queue into the free slots, one prefill launch per
        length bucket (paged: one per prefix-hit group plus one for the
        misses; gang: one whole-slot-batch launch per admission).  A batch
        the family cannot take yet is requeued and admission stops (a
        stall); with nothing live or in flight that can never unblock, so
        it raises.  Async ``"ready"`` engines only dispatch here."""
        finished: List[Request] = []
        blocked = False
        while True:
            free = [i for i, r in enumerate(self.live)
                    if r is None and not self._reserved[i]]
            if not free or not len(self.sched):
                break
            has_live = self._decoding()
            if self.admission == "gang" and has_live \
                    and not self.family.gang_live_splice:
                break                # the legacy gang waits for all slots
            batch = self.sched.next_batch(len(free))
            if not batch:
                break
            maxp = max(len(r.prompt) for r in batch)
            plen = self.sched.bucket_of(maxp)
            if plen >= self.max_len:     # bucket past the cache: exact length
                plen = maxp
            ctx = self.family.reserve(batch, plen)
            if ctx is None:
                self.sched.requeue(batch)
                self.stats.stalls += 1
                blocked = True
                break
            finished.extend(self._admit_batch(batch, free[:len(batch)],
                                              plen, has_live, ctx))
            if self.admission == "gang":
                break                # one gang per admission
        if blocked and not self._occupied():
            raise RuntimeError(self.family.capacity_msg(self.sched._q[0]))
        return finished

    def _admit_batch(self, batch: List[Request], slots_idx: List[int],
                     plen: int, has_live: bool, ctx) -> List[Request]:
        """One admission batch: stamp dispatch, launch the prefill (its
        tickets), then complete them here (sync and deterministic) or
        leave them in the pool (``"ready"``)."""
        t0 = time.perf_counter()
        for req in batch:
            req.t_dispatch = t0
            spans = self._req_spans.get(req.uid)
            if spans:
                spans["queue"].end()
                spans["prefill"] = self.trace.begin(
                    "prefill", f"req/{req.uid}", {"plen": plen})
        self.admit_log.extend(r.uid for r in batch)
        self.stats.prefills += len(batch)
        if self.admission == "gang":
            with phase_scope("prefill"):
                logits = self.family.gang(batch, slots_idx, plen, has_live)
                nxt = self._sample_host(logits, 1)[slots_idx]
            self.stats.prefill_batches += 1
            self.stats.prefill_s += time.perf_counter() - t0
            return self._activate(batch, slots_idx, plen, nxt,
                                  self.family.frozen_after_prefill(
                                      len(batch), plen))
        self._reserved[slots_idx] = True
        with phase_scope("prefill"):
            tickets = self.family.dispatch(batch, slots_idx, plen, ctx)
        self.stats.prefill_s += time.perf_counter() - t0
        if self.trace.enabled:
            # dispatch to completion (its splice and first-token readback)
            for t in tickets:
                t.span = self.trace.begin(
                    "ticket", "tickets",
                    {"requests": len(t.requests), "plen": t.plen,
                     "uids": [r.uid for r in t.requests]})
        if self.prefill_async and self.ready_order == "ready":
            self._pool.extend(tickets)
            self.stats.prefill_inflight_peak = max(
                self.stats.prefill_inflight_peak, len(self._pool))
            return []
        finished: List[Request] = []
        for t in tickets:
            finished.extend(self._finish_ticket(t))
        return finished

    def _finish_ticket(self, t: PrefillTicket) -> List[Request]:
        t0 = time.perf_counter()
        with self.trace.span("splice", "engine",
                             {"requests": len(t.requests)}), \
                phase_scope("splice"):
            nxt, fls = t.complete()
        self.stats.prefill_s += time.perf_counter() - t0
        if t.span is not None:
            t.span.end()
        return self._activate(t.requests, t.slots, t.plen, nxt, fls)

    def _drain_pool(self, *, block: bool) -> List[Request]:
        """Splice the pool's tickets whose prefills have finished, in
        dispatch order, never waiting on one (``ready()`` is an event
        query); with ``block`` the head is completed even if not ready
        (its ``complete`` then waits on the device, as a sync engine
        would)."""
        finished: List[Request] = []
        rest: List[PrefillTicket] = []
        with self.trace.span("drain-pool", "engine",
                             {"pool": len(self._pool)}) as dspan:
            ready = [(block and i == 0) or t.ready()
                     for i, t in enumerate(self._pool)]
            if self._dp is not None:
                # a ticket completes on every rank or on none: its
                # splice may gather, and collectives must pair up
                ready = sh.all_true(ready, self._dp, self.device, "ready")
            for t, ok in zip(self._pool, ready):
                if ok:
                    finished.extend(self._finish_ticket(t))
                else:
                    rest.append(t)
            dspan.annotate(spliced=len(self._pool) - len(rest))
        self._pool = rest
        return finished

    def cancel_pending(self, requeue: bool = True) -> int:
        """Cancel every in-flight ticket: its slots are freed, paged
        tickets release their pages and prefix refs (each exactly once),
        and its requests go back to the queue in arrival order
        (``requeue=False`` drops them).  Dispatch-side counts are taken
        back, so a re-admitted request is not counted twice.  The device
        work is not interrupted; its results are never spliced.  Returns
        the number of cancelled requests."""
        n = 0
        for t in self._pool:
            t.cancel()
            if t.span is not None:
                t.span.end(cancelled=True)
            self._reserved[t.slots] = False
            self.stats.prefills -= len(t.requests)
            for req in t.requests:
                req.t_dispatch = 0.0
                spans = self._req_spans.get(req.uid)
                if spans:
                    spans.pop("prefill", NULL_SPAN).end(cancelled=True)
                    if requeue:      # back in the queue: reopen its wait
                        spans["queue"] = self.trace.begin(
                            "queue", f"req/{req.uid}", {"requeued": True})
                    else:
                        spans["request"].end(dropped=True)
                        del self._req_spans[req.uid]
                n += 1
                for k in range(len(self.admit_log) - 1, -1, -1):
                    if self.admit_log[k] == req.uid:
                        del self.admit_log[k]
                        break
            if requeue:
                self.sched.requeue(t.requests)
        self._pool = []
        return n

    def _activate(self, batch: List[Request], slots_idx: List[int],
                  plen: int, nxt: np.ndarray,
                  fls: np.ndarray) -> List[Request]:
        """Occupy the slots of one completed ticket, stamp first tokens
        and the TTFT split, and apply the first-token stop check.
        Returns the requests that finished on their first token."""
        now = time.perf_counter()
        finished: List[Request] = []
        for j, (slot, req) in enumerate(zip(slots_idx, batch)):
            self._reserved[slot] = False
            self.live[slot] = req
            self.pos[slot] = plen
            self.frozen_len[slot] = fls[j]
            req.out_tokens.append(int(nxt[j]))
            req.t_first = req.t_last = now
            spans = self._req_spans.get(req.uid)
            if spans:
                spans["prefill"].end(slot=slot)
                spans["decode"] = self.trace.begin("decode",
                                                   f"req/{req.uid}")
            self.stats.ttft_s.append(now - req.t_submit)
            self.stats.ttft_queue_s.append(req.t_dispatch - req.t_submit)
            self.stats.ttft_compute_s.append(now - req.t_dispatch)
            if self._check_stop(slot, req, now):
                finished.append(req)
        return finished

    def _last_tokens(self) -> np.ndarray:
        tok = np.zeros((self.slots,), np.int32)
        for i, req in enumerate(self.live):
            if req is not None and req.out_tokens:
                tok[i] = req.out_tokens[-1]
        return tok

    def _decode_rounds(self) -> List[Request]:
        """One decode launch: the single-step round (``decode_block`` 1)
        or a fused block.  Fold checks run first, at the boundary, with
        the same cadence either way; ``decode_s`` covers both."""
        t0 = time.perf_counter()
        self.family.maybe_fold()
        if self.decode_block <= 1:
            done = self._decode_round()
        else:
            done = self._decode_block_round()
        self.stats.decode_s += time.perf_counter() - t0
        return done

    def _decode_round(self) -> List[Request]:
        tok = torch.from_numpy(self.shard.take(self._last_tokens())).long() \
            .to(self.device)
        with self.trace.span("decode-step", "engine"), \
                phase_scope("decode"):
            nxt = self._sample_host(self.family.decode(tok))
        now = time.perf_counter()
        self.stats.decode_steps += 1
        self.stats.blocks += 1
        self._round += 1
        done: List[Request] = []
        for i, req in enumerate(self.live):
            if req is None:
                continue
            self.pos[i] += 1
            req.out_tokens.append(int(nxt[i]))
            self.stats.tokens_out += 1
            self.stats.itl_s.append(now - req.t_last)
            req.t_last = now
            if self._check_stop(i, req, now):
                done.append(req)
        return done

    # -- fused block decode ------------------------------------------------
    def _block_len(self) -> int:
        """Steps the next fused block may run before a host event is due
        (every horizon follows from engine state; stop tokens, the one
        event that does not, halt the block on the device):

        * budget: no live slot decodes past ``max_new_tokens`` or the
          cache end;
        * fold: the family's ``fold_horizon()`` (steps until some tail
          fills), None for families whose state never grows;
        * admission: with ``admit_every > 1`` and a queue, the next due
          round (with ``admit_every == 1`` a deferred request waits for
          a slot to free or a fold, both block boundaries already);
        * stops on a sharded mesh, for a family whose state advances in
          place (Mamba2, hybrid): one step when a live slot has stop
          tokens and the slots are split over more than one rank (a rank
          sees only its own slots' stops and would run past the others'
          halt, which such state cannot undo).
        """
        blk = self.decode_block
        if self.shard.sharded and self.shard.dp > 1 \
                and not self.family.undoes_overrun and any(
                    r is not None and self._stops(r) for r in self.live):
            return 1
        for i, req in enumerate(self.live):
            if req is None:
                continue
            blk = min(blk, req.max_new_tokens - len(req.out_tokens),
                      (self.max_len - 1) - int(self.pos[i]))
        fh = self.family.fold_horizon()
        if fh is not None:
            blk = min(blk, fh)
        if len(self.sched) and self.admit_every > 1:
            due = (self._round // self.admit_every + 1) * self.admit_every
            blk = min(blk, due - self._round)
        return max(1, blk)

    def _stop_table(self) -> np.ndarray:
        """int32 [slots, W] stop tokens of each slot, −1-padded (a dead
        slot's row matches no token); W is the widest live stop set."""
        sets = [sorted(self._stops(r)) if r is not None else []
                for r in self.live]
        w = max([len(x) for x in sets] + [1])
        tbl = np.full((self.slots, w), -1, np.int32)
        for i, x in enumerate(sets):
            tbl[i, :len(x)] = x
        return tbl

    def _decode_block_round(self) -> List[Request]:
        blk = self._block_len()
        t0 = time.perf_counter()
        # the span wraps the runner's call, never the captured body (a
        # graph replays no Python); it ends at the block's one readback
        bspan = self.trace.begin("decode-block", "engine",
                                 {"max_steps": blk})
        with phase_scope("decode"):
            toks, steps = self.family.decode_block(
                self._last_tokens(), blk, self._stop_table())
        bspan.end(steps=steps)
        now = time.perf_counter()
        # one wall time per launch, attributed wall/steps to each token
        per_tok = (now - t0) / max(steps, 1)
        self.stats.decode_steps += steps
        self.stats.blocks += 1
        self._round += steps
        done: List[Request] = []
        for i, req in enumerate(self.live):
            if req is None:
                continue
            req.out_tokens.extend(int(t) for t in toks[:, i])
            self.pos[i] += steps
            self.stats.tokens_out += steps
            self.stats.itl_s.extend([per_tok] * steps)
            req.t_last = now
            # a stop can only sit on the block's last step (the block
            # halts there), so this check sees what the single-step
            # engine's per-round check would have
            if self._check_stop(i, req, now):
                done.append(req)
        return done


def _rows_from(sampler: Callable, row0: int) -> Callable:
    """``sampler`` drawing its rows as rows ``row0``, ``row0 + 1``, … of
    the whole slot batch (a keyed sampler's ``row0``): a rank's decode
    logits are the rows of its slots.  Unkeyed samplers, and row 0, are
    returned as they are."""
    if not row0 or not takes_key(sampler):
        return sampler

    def sample(logits, k, key):
        return sampler(logits, k, key, row0=row0)
    sample.takes_key = True
    return sample


def _prefill_stream(device: torch.device) -> "torch.cuda.Stream":
    """The prefill stream of ``device``, checked against the kernels'
    ticket counters: a launch on it must not share an owner's counters
    with a launch on the current stream (``kernels.build.tickets``)."""
    side = prefill_stream(device.index if device.index is not None
                          else torch.cuda.current_device())
    with torch.cuda.stream(side):
        mine = build.tickets(device, 1, "prefill-stream-check")
    theirs = build.tickets(device, 1, "prefill-stream-check")
    if mine.data_ptr() == theirs.data_ptr():
        raise RuntimeError("kernel ticket counters are shared across "
                           "streams: an async prefill would race decode")
    return side
