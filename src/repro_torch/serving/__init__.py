"""Serving engine: slot-based continuous batching (sync admission).

Counterpart of the slot mode of ``repro.serving.Engine``: ``slots``
concurrent sequences share one cache; a finished sequence frees its slot
at once; queued requests prefill into free slots.  Admission is per
slot: only the newly admitted requests are prefilled (prompt length
rounded up to the scheduler bucket, batch to a power of two) and their
fresh cache rows are spliced into the live cache — live slots are never
re-prefilled.  Everything family-specific (cache layout, prefill, splice,
decode, tail folds) lives behind the ``ServingFamily`` of
``serving.families``: ``dense``, ``ssm`` (Mamba2 state slots) or
``transformer-dkv`` (selected when the decompose engine's
``EngineConfig.kv_rank`` is > 0; its ``kv_tail`` and ``kv_exact`` set
the tail length and the factorization).

``paged=True`` (decomposed KV only) swaps the slab for the page pools
of ``serving.paged``: prefix U rows and dense tails in refcounted pages
behind per-slot block tables, and with ``EngineConfig.kv_prefix_cache``
> 0 a prefix cache whose hits admit with a tail-only suffix prefill (no
prefix forward, no Lanczos).  Before each admission the family reserves
pages (``reserve``); a batch the pools cannot take yet is requeued in
arrival order and counted as a stall, and with nothing live to free
pages that is a ``RuntimeError``.  A finished slot's pages are released
at once (``free_slot``).

Decode runs one token per live slot per step (``decode_block=1``).
Sampling is greedy, on the device, with one host readback per step —
the engine's only synchronization.  A request finishes on its token
budget or at the end of the cache (stop tokens are not ported yet).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..engine import DecomposeEngine
from ..platform import resolve_device
from .families import ServingFamily, family_names, serving_family

__all__ = ["Engine", "EngineStats", "Request", "Scheduler", "ServingFamily",
           "family_names", "greedy_sampler"]


def greedy_sampler(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the vocab axis → int32 [B]."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray               # [S] int32
    max_new_tokens: int = 16
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0            # perf_counter stamps (0.0 = not yet)
    t_dispatch: float = 0.0          # admission started
    t_first: float = 0.0             # first token out
    t_last: float = 0.0
    seq: int = -1                    # arrival stamp (Scheduler.submit)


@dataclasses.dataclass
class EngineStats:
    """Serving counters and latencies (host clock, seconds).

    ``prefill_s`` sums admissions (forward prefill, KV factorization,
    splice and the first-token readback); ``decode_s`` sums decode rounds
    (tail folds included).  Both end in a host readback of sampled
    tokens, so on the card they cover the device work they launched.
    ``prefix_hits``/``prefix_misses`` count admitted requests by prefix
    lookup outcome, ``stalls`` admissions deferred on page capacity
    (paged serving)."""
    prefills: int = 0
    prefill_batches: int = 0
    decode_steps: int = 0
    tokens_out: int = 0
    tail_folds: int = 0
    prefix_hits: int = 0
    prefix_misses: int = 0
    stalls: int = 0
    wall_s: float = 0.0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    itl_s: List[float] = dataclasses.field(default_factory=list)

    @property
    def mean_ttft_s(self) -> float:
        return float(np.mean(self.ttft_s)) if self.ttft_s else 0.0

    @property
    def mean_itl_s(self) -> float:
        return float(np.mean(self.itl_s)) if self.itl_s else 0.0

    @property
    def decode_tok_s(self) -> float:
        return self.tokens_out / self.decode_s if self.decode_s else 0.0


class Scheduler:
    """FIFO queue with prefill-length bucketing: ``next_batch`` serves the
    head of the queue plus later requests of the same bucket, keeping a
    free slot for every older request of another bucket (head-bucket
    starvation guard).  Every submission gets an arrival stamp ``seq``;
    :meth:`requeue` merges a deferred batch back on it, so a deferral
    never jumps requests that arrived between the batch's members."""

    def __init__(self, bucket: int = 16):
        self.bucket = max(1, bucket)
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

    def bucket_of(self, plen: int) -> int:
        return -(-max(int(plen), 1) // self.bucket) * self.bucket

    def next_batch(self, free_slots: int) -> List[Request]:
        if not self._q or free_slots < 1:
            return []
        want = self.bucket_of(len(self._q[0].prompt))
        take: List[Request] = []
        keep: List[Request] = []
        skipped = set()
        for r in self._q:
            bk = self.bucket_of(len(r.prompt))
            if bk == want and len(take) + len(skipped) < free_slots:
                take.append(r)
            else:
                keep.append(r)
                if bk != want:
                    skipped.add(bk)
        self._q = keep
        return take


class Engine:
    """Continuous-batching engine over the config's family (dense
    transformer or Mamba2), with the decomposed KV cache when
    ``decompose_engine.config.kv_rank`` > 0 (dense family only), on page
    pools when ``paged``."""

    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 256,
                 decompose_engine: Optional[DecomposeEngine] = None,
                 device=None, paged: bool = False):
        self.device = resolve_device(device)
        self.cfg, self.params = cfg, params
        self.slots, self.max_len = slots, max_len
        self.dengine = decompose_engine or DecomposeEngine()
        ecfg = self.dengine.config
        self.dkv_rank = ecfg.kv_rank
        self.dkv_tail = ecfg.kv_tail
        self.dkv_exact = ecfg.kv_exact
        # per-slot host state: next write position, low-rank prefix length,
        # effective factor rank (decomposed KV only)
        self.pos = np.zeros((slots,), np.int32)
        self.frozen_len = np.zeros((slots,), np.int32)
        self.rank_eff = np.zeros((slots,), np.int32)
        self.live: List[Optional[Request]] = [None] * slots
        self.pager = None            # serving.paged.PagedDKV when paged
        self.family = serving_family(self, paged=paged)
        self.cache = self.family.alloc()
        self.sched = Scheduler(bucket=ecfg.sched_bucket)
        self.admit_every = max(1, ecfg.sched_admit_every)
        self.stats = EngineStats()
        self._round = 0

    # -- public API ------------------------------------------------------
    def submit(self, req: Request) -> None:
        if len(req.prompt) >= self.max_len:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens leaves no decode room "
                f"in a max_len={self.max_len} cache")
        if not req.t_submit:
            req.t_submit = time.perf_counter()
        self.sched.submit(req)

    def step(self) -> List[Request]:
        """Admit if due, then decode one token per live slot.  Returns the
        requests that finished in this step."""
        t0 = time.perf_counter()
        finished: List[Request] = []
        if self._round % self.admit_every == 0 or not self._occupied():
            finished.extend(self._admit())
        if self._occupied():
            finished.extend(self._decode_round())
        else:
            self._round += 1         # an idle step still advances the clock
        self.stats.wall_s += time.perf_counter() - t0
        return finished

    def run(self, max_steps: int = 10_000) -> List[Request]:
        finished: List[Request] = []
        for _ in range(max_steps):
            finished.extend(self.step())
            if not self._occupied() and not len(self.sched):
                break
        return finished

    # -- internals -------------------------------------------------------
    def _occupied(self) -> bool:
        return any(r is not None for r in self.live)

    def _sample_host(self, logits: torch.Tensor) -> np.ndarray:
        """Sample on the device, read the tokens back (the one sync)."""
        return greedy_sampler(logits).cpu().numpy()

    def _check_stop(self, slot: int, req: Request) -> bool:
        """Free the slot once the request spent its budget or the cache."""
        if (len(req.out_tokens) >= req.max_new_tokens
                or self.pos[slot] >= self.max_len - 1):
            req.done = True
            self.live[slot] = None
            self.family.free_slot(slot)
            return True
        return False

    def _toks_np(self, batch: List[Request], rows: int,
                 plen: int) -> np.ndarray:
        """Prompts LEFT-padded with token 0 to ``plen`` (as the JAX
        engine pads them), one row per request, extra rows all padding."""
        toks = np.zeros((rows, plen), np.int32)
        for j, req in enumerate(batch):
            toks[j, plen - len(req.prompt):] = req.prompt
        return toks

    def _toks(self, batch: List[Request], rows: int,
              plen: int) -> torch.Tensor:
        """:meth:`_toks_np` as a token tensor on the device."""
        return torch.from_numpy(self._toks_np(batch, rows, plen)).long().to(
            self.device)

    def _admit(self) -> List[Request]:
        """Drain the queue into the free slots, one prefill launch per
        length bucket (paged: one per prefix-hit group plus one for the
        misses).  A batch the family cannot take yet is requeued and
        admission stops (a stall); with nothing live that can never
        unblock, so it raises."""
        finished: List[Request] = []
        blocked = False
        while True:
            free = [i for i, r in enumerate(self.live) if r is None]
            if not free or not len(self.sched):
                break
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
            slots_idx = free[:len(batch)]
            t0 = time.perf_counter()
            for req in batch:
                req.t_dispatch = t0
            self.stats.prefills += len(batch)
            for idx, (nxt, fls) in self.family.admit(batch, slots_idx, plen,
                                                     ctx):
                now = time.perf_counter()
                self.stats.prefill_s += now - t0
                self.stats.prefill_batches += 1
                t0 = now
                for j, k in enumerate(idx):
                    slot, req = slots_idx[k], batch[k]
                    self.live[slot] = req
                    self.pos[slot] = plen
                    self.frozen_len[slot] = fls[j]
                    req.out_tokens.append(int(nxt[j]))
                    req.t_first = req.t_last = now
                    self.stats.ttft_s.append(now - req.t_submit)
                    if self._check_stop(slot, req):
                        finished.append(req)
        if blocked and not self._occupied():
            raise RuntimeError(self.family.capacity_msg(self.sched._q[0]))
        return finished

    def _last_tokens(self) -> np.ndarray:
        tok = np.zeros((self.slots,), np.int32)
        for i, req in enumerate(self.live):
            if req is not None and req.out_tokens:
                tok[i] = req.out_tokens[-1]
        return tok

    def _decode_round(self) -> List[Request]:
        t0 = time.perf_counter()
        self.family.maybe_fold()
        tok = torch.from_numpy(self._last_tokens()).long().to(self.device)
        nxt = self._sample_host(self.family.decode(tok))
        now = time.perf_counter()
        self.stats.decode_s += now - t0
        self.stats.decode_steps += 1
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
            if self._check_stop(i, req):
                done.append(req)
        return done
