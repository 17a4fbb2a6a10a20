"""ServingFamily — the per-family strategy behind ``serving.Engine``.

Counterpart of ``repro.serving.families`` for the slot path with sync
admission.  Registered families:

* ``dense`` — plain dense-KV transformer serving (the base class);
* ``ssm`` — Mamba2: the cache is an O(1) state slot per sequence (conv
  window + SSM state, no time axis); prefill runs the chunked scan with
  the kernel set of the engine's resolved backend; no folds and
  no pager (``pos`` still advances for the budget);
* ``moe`` — mixture of experts on the dense-KV slab (the router's state
  is recomputed every step, so nothing beyond K/V is spliced);
* ``hybrid`` — Zamba2: grouped Mamba2 state slots plus the shared
  block's K/V, whose slot axes differ by leaf; prefill runs the SSD with
  the engine's kernel set, as ``ssm`` does;
* ``vlm`` / ``audio`` — dense-KV serving whose prefill takes extra
  modality inputs (``ModelFns.prefill_inputs``: image embeddings, encoder
  frames; zeros, as the reference's engine feeds them) and whose
  admission cost adds the image tokens or frames to the prompt;
* ``transformer-dkv`` — the decomposed-KV path, selected whenever the
  engine's decomposed-KV rank (``Engine.dkv_rank``) is > 0: prefill factorizes K/V
  through the engine's DecomposeEngine, decode attends through the
  factors, and each slot's dense tail folds back (``compress_tail`` with
  a per-slot mask) when THAT slot's tail fills.  ``paged=True`` swaps
  the slab for ``serving.paged``'s page pools and prefix cache
  (``eng.pager``): admission splits into prefix HITS (tail-only suffix
  prefill over shared pages) and MISSES (the slab path's prefill, then
  the pages), decode reads U through the block tables inside the paged
  dkv kernel, and folds copy-on-write into fresh pages.  Dense family
  only: any other family with a rank raises.

Admission is split as in the reference: ``dispatch`` launches one
admission batch's prefill and returns its ``PrefillTicket``s, and each
ticket's ``complete`` splices the fresh rows (``models.api.splice_cache``
in place, for every family's cache layout) and samples the first token
(on the engine's admission stream, 1);
``cancel`` unwinds a ticket that never completes.  With an async engine
on the card the prefill runs on the engine's prefill stream and the
ticket's probe is an event recorded after it (``_on_side``/``_join``);
sync engines and the host complete where they dispatch.  ``gang`` is the
legacy whole-slot-batch admission (dense alone may gang into a live
cache, ``gang_live_splice``).  ``decode_block`` runs up to n decode
steps as one fixed-length loop through ``serving.graphs`` (a replayed
CUDA graph on the card); ``prefill_cost``, ``tune_horizon``, ``block_cap`` and
``fold_horizon`` feed the scheduler, the ``decode_block="auto"`` tuner
and the engine's block horizon.  All mutable serving state
(``cache``, ``pos``, ``frozen_len``, ``rank_eff``, ``live``, ``pager``)
stays on the Engine; a family holds only the static buffers its fused
blocks' graphs read (``_static``).  On a mesh the device-side state
is the rank's (``eng.shard``: its slots' rows of every per-slot array)
while the host state stays global; a family hands its kernels the
held slots' rows (``eng.shard.take``), splices only held slots, and
applies geometry changes (the dkv slab's time and rank axes) on every
rank alike.  A family reaches its
engine through a ``weakref.proxy``: the engine owns the family, so a
dropped engine frees its cache and weights at once, without waiting for
the cyclic garbage collector (the reference keeps the cycle).
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..distributed import tokens as TOK
from ..models import decomposed_kv as DK
from ..models import api
from ..models.api import model_fns, run_decode_block
from ..obs import phase_scope
from ..platform import host_to_device
from .graphs import pin, unpack
from .paged import PagedDKV

Admitted = Tuple[np.ndarray, np.ndarray]       # (first tokens, frozen lens)


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


#: the fused block's slab U buffers round their row axis up to this, so a
#: fold (which moves ``t_need``) rarely changes the captured shapes
ROW_PAD = 128


def _shapes(tree) -> tuple:
    """(key, shape, address) of every tensor of a cache tree: what a
    captured graph reads."""
    out = []
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            out.extend((k,) + t for t in _shapes(v))
        else:
            out.append((k, tuple(v.shape), v.data_ptr()))
    return tuple(out)


@dataclasses.dataclass
class PrefillTicket:
    """One in-flight admission launch (counterpart of the reference's).

    Made at dispatch: the prefill has been launched, the target slots are
    reserved and (paged) the pages allocated and the prefix-hit refs
    held, so nothing decode does meanwhile can invalidate it.  ``probe``
    is the ``torch.cuda.Event`` recorded after the prefill on the
    engine's prefill stream, or None where the prefill ran on the
    current stream (sync engines, the host), which makes the ticket
    ready at dispatch.  ``complete()`` → (first tokens, frozen lengths)
    splices and samples, the one point that waits on the device;
    ``cancel()`` releases pages and refs without waiting on it.  ``span``
    is the ticket's ``obs.Span`` on the ``tickets`` track (tracing on),
    from dispatch to the end of ``complete()``."""
    requests: List[Any]
    slots: List[int]
    plen: int
    probe: Any
    complete: Callable[[], Admitted]
    cancel: Callable[[], None]
    t_dispatch: float = 0.0
    span: Any = None

    def ready(self) -> bool:
        return api.tree_ready(self.probe)


def _noop() -> None:
    pass


def _sample_feed(eng) -> Dict[str, np.ndarray]:
    """The keyed draw's part of a fused block's feed: the decode stream's
    key (its 32 bits as an int32) and the block's first round."""
    return {"key": np.array(eng._stream_key(0), np.uint32).view(np.int32),
            "round0": np.int32(eng._round)}


def _live(eng) -> np.ndarray:
    """int32 [held slots]: 1 where a slot holds a request (a fused
    block's ``slot_live``; a reserved slot is not live until its ticket
    completes)."""
    return np.array([r is not None for r in eng.shard.take(eng.live)],
                    np.int32)


def _on_side(eng, fn):
    """Run the prefill ``fn()`` where the engine's admissions run: on its
    prefill stream when it has one (async on the card; the stream first
    waits for the current stream, whose pending writes the prefill may
    read), else inline.  Returns (``fn()``'s result, the event recorded
    after it on the prefill stream, or None)."""
    side = eng.prefill_stream
    if side is None:
        return fn(), None
    side.wait_stream(torch.cuda.current_stream(eng.device))
    with torch.cuda.stream(side):
        out = fn()
    ev = torch.cuda.Event()
    ev.record(side)
    return out, ev


def _join(eng, ev, tree) -> None:
    """Order the current stream after a ticket's prefill (``ev``) before
    it reads ``tree``, the prefill's outputs, and mark their memory as in
    use on the current stream: they were allocated on the prefill
    stream, and the caching allocator would otherwise hand it to the
    next prefill while a splice still reads it."""
    if ev is None:
        return
    cur = torch.cuda.current_stream(eng.device)
    cur.wait_event(ev)
    for leaf in api.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            leaf.record_stream(cur)


_REGISTRY: Dict[str, type] = {}


def register_family(*names):
    def deco(cls):
        for n in names:
            if n in _REGISTRY:
                raise ValueError(f"serving family {n!r} already registered")
            _REGISTRY[n] = cls
        return cls
    return deco


def family_names() -> List[str]:
    return sorted(_REGISTRY)


def family_class(eng) -> type:
    """A decomposed-KV rank > 0 selects transformer-dkv, otherwise the
    model config's family key."""
    key = "transformer-dkv" if eng.dkv_rank else eng.cfg.family
    cls = _REGISTRY.get(key)
    if cls is None:
        raise ValueError(f"no ServingFamily registered for {key!r} "
                         f"(have {family_names()})")
    return cls


class ServingFamily:
    """The base class IS the generic slab path, through the family's
    ``models.api.model_fns``: a cache whose every leaf has its slot axis
    at 1 (dense: K/V [L, slots, max_len, kvh, d]), prefill + splice
    admission, one-token decode, no folds."""
    paged_capable = False
    #: gang admission may splice into a cache with live slots (dense
    #: alone); every other family gangs only on an all-free engine
    gang_live_splice = False
    #: a fused block that ran past the global halt on this rank (its
    #: slots sampled no stop token where another rank's did) can be put
    #: back (:meth:`undo_overrun`); False: the engine runs one-step
    #: blocks on a sharded mesh whenever a live slot has stop tokens
    undoes_overrun = True

    def __init__(self, eng, paged: bool = False):
        if paged and not self.paged_capable:
            raise ValueError("paged serving runs on the decomposed KV "
                             "cache (a decomposed-KV rank > 0)")
        self.eng = weakref.proxy(eng)     # no engine <-> family cycle
        self.fns = model_fns(eng.cfg)
        # the cache buffers the fused block's graphs read (graphs.pin)
        self._static: Dict[str, Any] = {}

    def alloc(self):
        eng = self.eng
        return self.fns.init_cache(eng.cfg, eng.shard.n, eng.max_len,
                                   device=eng.device)

    def free_slot(self, slot: int) -> None:
        """Release per-slot resources (paged block tables) on finish."""

    def frozen_after_prefill(self, n: int, plen: int) -> np.ndarray:
        """Per-slot ``frozen_len`` right after a prefill of ``plen``."""
        return np.zeros(n, np.int32)

    # -- scheduling ------------------------------------------------------
    def prefill_cost(self, req) -> int:
        """Admission cost the scheduler buckets on (the prompt length)."""
        return len(req.prompt)

    def tune_horizon(self) -> int:
        """Decode horizon of the ``decode_block="auto"`` cost model."""
        return self.eng.max_len

    def block_cap(self) -> Optional[int]:
        """Upper bound on the fused block length (None = uncapped)."""
        return None

    def fold_horizon(self) -> Optional[int]:
        """Steps until some live slot must fold (None = never folds)."""
        return None

    def reserve(self, batch: List[Any], plen: int):
        """Capacity check before admission: an opaque non-None context
        for :meth:`dispatch`, or None to defer the batch (the engine
        requeues it and counts a stall)."""
        return True

    def capacity_msg(self, head) -> str:
        """Diagnostic for a deferral that can never unblock."""
        return (f"request uid={head.uid} (prompt {len(head.prompt)} "
                f"tokens) is blocked on serving capacity with no "
                f"in-flight work to free resources")

    def _batch_rows(self, n: int) -> int:
        """Admission batches pad to a power of two (bounded shape set)."""
        return min(_pow2(n), max(self.eng.slots, 1))

    def _ticket(self, batch: List[Any], slots_idx: List[int], plen: int,
                probe, complete, cancel=_noop) -> PrefillTicket:
        self.eng.stats.prefill_batches += 1
        return PrefillTicket(list(batch), list(slots_idx), plen, probe,
                             complete, cancel, time.perf_counter())

    def dispatch(self, batch: List[Any], slots_idx: List[int], plen: int,
                 ctx=None) -> List[PrefillTicket]:
        """Launch the prefill of one admission batch (``ctx`` from
        :meth:`reserve`; rows padded to a power of two) and return its
        tickets.  A ticket's ``complete`` splices the fresh rows into the
        live cache in place and samples the first tokens."""
        eng = self.eng
        rows = self._batch_rows(len(batch))
        (logits, fresh), ev = _on_side(
            eng, lambda: self._prefill(eng._toks(batch, rows, plen)))
        n = len(batch)

        def complete() -> Admitted:
            _join(eng, ev, (logits, fresh))
            loc, src = eng.shard.pairs(slots_idx)
            if loc:
                api.splice_cache(eng.cfg, eng.cache, fresh, loc, src)
            return eng._sample_host(logits, 1)[:n], np.zeros(n, np.int32)

        return [self._ticket(batch, slots_idx, plen, ev, complete)]

    def _prefill(self, toks: torch.Tensor):
        """(last logits, fresh cache of ``toks``' rows); the family's
        extra prefill inputs (``prefill_inputs``) are zeros."""
        eng = self.eng

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=toks.device)
        return self.fns.prefill(
            eng.params, eng.cfg,
            *self.fns.prefill_inputs(eng.cfg, toks, zeros), eng.max_len)

    def gang(self, batch: List[Any], slots_idx: List[int], plen: int,
             has_live: bool) -> torch.Tensor:
        """Legacy admission: prefill the WHOLE slot batch (request j in
        row ``slots_idx[j]``, idle and live rows as padding), splice the
        admitted rows into a live cache where the family may
        (``gang_live_splice``), else replace the cache (every slot is
        free then).  Returns the logits of every row."""
        eng = self.eng
        logits, cache = self._prefill(eng._toks(batch, eng.slots, plen,
                                                slots_idx))
        if has_live:
            loc, src = eng.shard.pairs(slots_idx)
            if loc:
                api.splice_cache(eng.cfg, eng.cache, cache, loc,
                                 [slots_idx[j] for j in src])
        else:
            eng.cache = eng.shard.take_cache(eng.cfg, cache)
        return logits

    def decode(self, tok: torch.Tensor) -> torch.Tensor:
        """One decode step of the held slots (``tok`` their tokens) →
        their logits."""
        eng = self.eng
        pos = torch.from_numpy(eng.shard.take(eng.pos)).long() \
            .to(eng.device)
        logits, eng.cache = self.fns.decode_step(eng.params, eng.cfg, tok,
                                                 eng.cache, pos)
        return logits

    def _capturable(self) -> bool:
        """Whether the fused block replays a CUDA graph (the card)."""
        return self.eng.device.type == "cuda"

    def decode_block(self, tok: np.ndarray, n: int, stops: np.ndarray
                     ) -> Tuple[np.ndarray, int]:
        """Up to ``n`` sampled decode steps of every slot in one launch
        (``api.run_decode_block`` with the engine's sampler, halted by
        ``stops`` int32 [slots, W]): returns (tokens [steps, slots],
        steps) on the host."""
        eng = self.eng
        sd = eng.shard
        pin(eng.cache, self._static)
        cache, fns, params, cfg = eng.cache, self.fns, eng.params, eng.cfg
        sampler = eng.decode_sampler

        def body(tok, pos, stops, live, key, round0, n_steps):
            def step(t, c, ps, act):
                return fns.decode_step(params, cfg, t, c, ps, act)
            buf, steps, _, _ = run_decode_block(
                step, n, tok.long(), cache, pos.long(), n_steps, stops,
                slot_live=live.bool(), sampler=sampler, key=key,
                round0=round0)
            return buf, steps

        key = (type(self).__name__, n, sd.n, stops.shape[1],
               _shapes(cache))
        feed = {"tok": sd.take(tok), "pos": sd.take(eng.pos),
                "stops": sd.take(stops), "live": _live(eng),
                **_sample_feed(eng), "n_steps": np.int32(n)}
        return self._run_block(key, body, feed, self._capturable())

    def _run_block(self, key, body, feed, capture: bool):
        """A fused block through the engine's graphs, its tokens gathered
        over the DP group (on a slot-sharded mesh) before the readback,
        and this rank's steps past the block's end undone → (tokens
        [steps, slots], steps)."""
        eng = self.eng
        sd = eng.shard
        out = eng.graphs.run(key, body, feed, capture=capture,
                             gather=sd.gather if sd.sharded else None)
        toks, steps, ran = unpack(out, eng.slots, sd.dp if sd.sharded else 1)
        mine = ran[sd.first // sd.n if sd.sharded else 0]
        if mine > steps:
            self.undo_overrun(steps, mine)
        return toks, steps

    def undo_overrun(self, steps: int, ran: int) -> None:
        """This rank's block ran ``ran`` steps where the block took
        ``steps``: put its held live slots back as after ``steps``.  A
        K/V cache needs nothing: the rows past a slot's position are
        masked until the next block writes them again, with the same
        values."""

    def maybe_fold(self) -> None:
        """Tail-fold check at a decode boundary (no-op without a tail)."""


@register_family("dense")
class DenseKVServing(ServingFamily):
    """Plain dense-KV transformer serving: the base path, plus the one
    legacy privilege — gang admission may splice into a live cache."""
    gang_live_splice = True


@register_family("ssm")
class Mamba2Serving(ServingFamily):
    """Mamba2/SSM serving: the "cache" is O(1) per slot — conv window
    [L, slots, w−1, ch] + SSM state [L, slots, nh, hd, ds] — a STATE SLOT
    with no time axis.  ``pos`` still advances (budget bookkeeping) but
    never indexes device state; there is nothing to fold; admission
    splices whole state rows.  Prefill runs the chunked scan through the
    decompose engine's kernel set (its resolved backend: ``"cuda"``, the
    SSD kernel on the card; ``"reference"``, its plain version)."""

    #: the state slots advance in place: steps past a block's end
    #: cannot be undone
    undoes_overrun = False

    def __init__(self, eng, paged: bool = False):
        super().__init__(eng, paged=paged)
        self.kernels = eng.dengine.kernels

    def _prefill(self, toks: torch.Tensor):
        eng = self.eng
        return self.fns.prefill(eng.params, eng.cfg, toks, eng.max_len,
                                kernels=self.kernels)


@register_family("moe")
class MoEServing(ServingFamily):
    """Mixture-of-experts serving on the dense-KV slab ([L, slots,
    max_len, kvh, d] K/V, as dense).  The FFN routes top-k per token with
    a capacity buffer; routing is recomputed every step from the hidden
    states, so admission, fused blocks and async prefill all take the
    base path.  Neither paged nor ganged into a live cache.

    Capacity (``ceil(tokens · top_k · cf / E)``) makes drops depend on
    the batch: the whole slot batch routes at decode, dead rows
    included, so tokens equal another engine's only where the batches
    are the same (fused vs single-step, async-deterministic vs sync; the
    fused block keeps dead rows as single steps have them) or where
    capacity never binds (the reference's conformance pins cf 8).  On a
    mesh each rank decodes its block of the slots, as every family does,
    under ``distributed.tokens.use``: the ranks' blocks are the
    contiguous blocks of the slot batch, so the MoE blocks' global form
    routes the whole batch as one device does (a prefill routes its
    whole admission batch on every rank).  With ``cfg.moe_shard_map``
    each rank's slots route alone (the reference's per-shard form)."""

    def decode(self, tok: torch.Tensor) -> torch.Tensor:
        with self._split():
            return super().decode(tok)

    def decode_block(self, tok: np.ndarray, n: int, stops: np.ndarray
                     ) -> Tuple[np.ndarray, int]:
        with self._split():
            return super().decode_block(tok, n, stops)

    def _split(self):
        """The decode's token split: the DP group of a slot-sharded mesh."""
        sd = self.eng.shard
        return TOK.use(self.eng.mesh if sd.sharded else None)


@register_family("hybrid")
class HybridServing(Mamba2Serving):
    """Zamba2 serving: grouped Mamba2 state slots ([g, mpg, slots, …])
    plus the shared block's K/V ([g, slots, max_len, kvh, d]) and the
    tail's state slots, one tree of mixed leaves spliced along each
    leaf's probed slot axis (``api.cache_batch_axes``).  Prefill runs
    the SSD through the engine's kernel set (32 ``ssd_chunk_intra``
    launches a prefill at full width), decode none."""


@register_family("vlm")
class VLMServing(ServingFamily):
    """Vision-language serving on the dense-KV slab: prefill also takes
    the image embeddings (zeros: the frontend is a stub) and writes the
    static cross K/V [groups, slots, n_img, kvh, d]; every admission
    pays ``num_image_tokens`` of extra attention work, so the scheduler
    buckets on tokens + image tokens.  The self K/V's slot axis is 2
    ([groups, spg, slots, T, kvh, d]); splices find it through
    ``api.cache_batch_axes``."""

    def prefill_cost(self, req) -> int:
        return len(req.prompt) + self.eng.cfg.num_image_tokens


@register_family("audio")
class AudioServing(ServingFamily):
    """Encoder-decoder serving: prefill encodes ``num_audio_frames``
    frames (zeros: the frontend is a stub) before the decoder reads a
    token, and writes the static cross K/V; admission cost is tokens +
    frames."""

    def prefill_cost(self, req) -> int:
        return len(req.prompt) + self.eng.cfg.num_audio_frames


@register_family("transformer-dkv")
class TransformerDKVServing(ServingFamily):
    """The paper's low-rank decomposed-KV serving path (dense family),
    on the slab or (``paged=True``) on page pools with a prefix cache."""
    paged_capable = True

    def __init__(self, eng, paged: bool = False):
        # as the reference asserts: a guard, not a dispatch
        if eng.cfg.family != "dense":  # dcomlint: disable=F1
            raise AssertionError(f"decomposed KV: dense family only, not "
                                 f"{eng.cfg.family!r} ({eng.cfg.name}); "
                                 f"set decompose_kv_rank=0")
        super().__init__(eng, paged=paged)
        if paged:
            ec = eng.dengine.config
            eng.pager = PagedDKV(
                eng.cfg, slots=eng.slots, max_len=eng.max_len,
                rank=eng.dkv_rank, tail=eng.dkv_tail, page=ec.kv_page,
                pool_pages=ec.kv_pool_pages,
                prefix_capacity=ec.kv_prefix_cache, device=eng.device,
                shard=eng.shard)

    def alloc(self):
        return None                  # built at the first prefill

    def free_slot(self, slot: int) -> None:
        if self.eng.pager is not None:
            self.eng.pager.free_slot(slot)

    def frozen_after_prefill(self, n: int, plen: int) -> np.ndarray:
        return np.full(n, plen, np.int32)

    # -- scheduling ------------------------------------------------------
    def tune_horizon(self) -> int:
        return self.eng.dkv_tail

    def block_cap(self) -> Optional[int]:
        return self.eng.dkv_tail     # the fold cadence bounds every block

    def fold_horizon(self) -> Optional[int]:
        eng = self.eng
        occ = max(int(eng.pos[i] - eng.frozen_len[i])
                  for i, r in enumerate(eng.live) if r is not None)
        return eng.dkv_tail - occ

    def _route(self) -> str:
        return "kernel" if self.eng.dengine.resolved_backend == "cuda" \
            else "plain"

    def _prefill(self, toks: torch.Tensor):
        eng = self.eng
        return DK.prefill_dkv(eng.params, eng.cfg, toks, eng.dkv_rank,
                              tail=eng.dkv_tail, exact=eng.dkv_exact,
                              engine=eng.dengine)

    # -- admission -------------------------------------------------------
    def reserve(self, batch: List[Any], plen: int):
        eng = self.eng
        if eng.pager is None:
            return True
        # prefix lookups FIRST (page refs taken per hit), so the
        # reservation below only counts the MISSES' pages and its
        # evictions can never invalidate this batch's hits
        looks = self._lookup_prefixes(batch, plen)
        n_miss = sum(1 for g in looks if g is None)
        if not self._reserve_pages(n_miss, len(batch), plen):
            # the pools can't take this batch yet: release the hit refs
            # taken above (they were installed nowhere) and let the
            # engine requeue + stall
            for got in looks:
                if got is not None:
                    eng.pager.alloc.release(got[2])
            return None
        return looks

    def capacity_msg(self, head) -> str:
        pg = self.eng.pager
        return (f"request uid={head.uid} (prompt {len(head.prompt)} tokens)"
                f" is blocked on page capacity with no in-flight work to "
                f"free pages — raise kv_pool_pages (pool: "
                f"{pg.num_pages} U pages / "
                f"{pg.num_tail_pages} tail pages) or lower the "
                f"prompt length / admission batch")

    def _lookup_prefixes(self, batch: List[Any], plen: int) -> list:
        """Prefix-cache lookups for one admission batch.  Each hit's
        shared page refs are taken IMMEDIATELY, before any reservation
        eviction or same-batch miss insertion can release them.  Lookups
        run unrecorded: hits and misses are counted at admission, once
        per admitted request, so deferrals do not inflate them."""
        eng = self.eng
        pg = eng.pager
        out: list = []
        for req in batch:
            got = None
            if pg.prefix is not None:
                found = pg.prefix.lookup(eng._toks_np([req], 1, plen)[0],
                                         eng.dkv_tail,
                                         plen - len(req.prompt),
                                         record=False)
                if found is not None:
                    ent, match_len = found
                    share = ent.pages[:match_len // pg.page]
                    pg.alloc.ref(share)
                    got = (ent, match_len, share)
            out.append(got)
        return out

    def _reserve_pages(self, n_miss: int, n_req: int, plen: int) -> bool:
        """Can the pools take this batch (``n_miss`` full prefills plus a
        tail per request)?  Evicts prefix-cache entries LRU-first if that
        frees enough — hits are unaffected, they already hold refs."""
        pg = self.eng.pager
        need_u = n_miss * pg.pages_for(plen)
        need_t = n_req * pg.ntp
        while pg.alloc.free_pages < need_u and pg.prefix is not None \
                and len(pg.prefix):
            pg.prefix._evict()
        return pg.alloc.free_pages >= need_u \
            and pg.talloc.free_pages >= need_t

    def dispatch(self, batch: List[Any], slots_idx: List[int], plen: int,
                 ctx=None) -> List[PrefillTicket]:
        if self.eng.pager is not None:
            return self._dispatch_paged(batch, slots_idx, plen, ctx)
        eng = self.eng
        rows = self._batch_rows(len(batch))
        (logits, fresh), ev = _on_side(
            eng, lambda: self._prefill(eng._toks(batch, rows, plen)))
        n = len(batch)

        def complete() -> Admitted:
            _join(eng, ev, (logits, fresh))
            if eng.cache is None:
                eng.cache = DK.init_cache(
                    eng.cfg, eng.shard.n, fresh["k_u"].shape[2],
                    fresh["k_u"].shape[-1], tail=eng.dkv_tail,
                    device=eng.device)
            # every rank pads its cache to the fresh geometry; the rows
            # land on the rank that holds their slot
            loc, src = eng.shard.pairs(slots_idx)
            eng.cache = DK.splice_dkv(eng.cache, fresh, loc, src)
            eng.rank_eff[slots_idx] = fresh["k_u"].shape[-1]
            return eng._sample_host(logits, 1)[:n], \
                np.full(n, plen, np.int32)

        return [self._ticket(batch, slots_idx, plen, ev, complete)]

    def _dispatch_paged(self, batch: List[Any], slots_idx: List[int],
                        plen: int, looks) -> List[PrefillTicket]:
        """Paged admission: the prefix lookups of :meth:`reserve` (hit
        page refs already taken) split the batch into HITS (tail-only
        suffix prefill over refcounted shared pages — no prefix forward,
        no Lanczos), one ticket per (match length, entry rank), and
        MISSES (the slab path's prefill at the same pow2 batch padding,
        so the factors are the slab engine's), one ticket.  Pages are
        allocated here, at dispatch; the prefills only compute, and the
        pools, factors and block tables are written at completion
        (DESIGN.md §12: until then a reserved slot's block-table row is
        empty, so decode's dead-row writes land in the sink page)."""
        eng = self.eng
        pg = eng.pager
        n = len(batch)
        padded = eng._toks_np(batch, n, plen)
        hits: dict = {}            # (L, r_eff) -> [(j, entry, share), ...]
        misses: List[int] = []
        for j in range(n):
            got = looks[j] if isinstance(looks, list) else None
            if got is not None:
                ent, match_len, share = got
                hits.setdefault((match_len, ent.r_eff),
                                []).append((j, ent, share))
            else:
                misses.append(j)
        if pg.prefix is not None:
            nh = n - len(misses)
            eng.stats.prefix_hits += nh
            eng.stats.prefix_misses += len(misses)
            pg.prefix.hits += nh
            pg.prefix.misses += len(misses)
        # hits first: they only consume tail pages, and their factor
        # pages already carry this batch's refs
        tickets = [self._dispatch_hits(batch, slots_idx, plen, padded,
                                       match_len, r_ent, group)
                   for (match_len, r_ent), group in sorted(
                       hits.items(), key=lambda kv: kv[0])]
        if misses:
            tickets.append(self._dispatch_misses(batch, slots_idx, plen,
                                                 padded, misses))
        return tickets

    def _dispatch_hits(self, batch: List[Any], slots_idx: List[int],
                       plen: int, padded: np.ndarray, match_len: int,
                       r_ent: int, group: list) -> PrefillTicket:
        eng = self.eng
        pg = eng.pager
        m = len(group)
        dev = eng.device
        stoks = np.stack([padded[j][match_len:] for j, _, _ in group])
        shares = [list(share) for _, _, share in group]
        bt_t = []
        for _ in group:
            tpages = pg.talloc.alloc(pg.ntp)
            assert tpages is not None, "tail pages after _reserve_pages"
            bt_t.append(tpages)
        slots_l = [slots_idx[j] for j, _, _ in group]
        k_vt = torch.stack([ent.k_vt for _, ent, _ in group], dim=1)
        v_vt = torch.stack([ent.v_vt for _, ent, _ in group], dim=1)
        # the gather reads the pools: on the current stream, in order
        # with the writes before it; the suffix pass reads only its copy
        prefix = pg.hit_prefix(pg.bt_tensor(shares), k_vt, v_vt,
                               match_len, r_ent)
        if eng.prefill_stream is not None:
            for leaf in api.tree_leaves(prefix):
                leaf.record_stream(eng.prefill_stream)
        (logits, tails), ev = _on_side(eng, lambda: DK.prefill_suffix_dkv(
            eng.params, eng.cfg, host_to_device(stoks, dev),
            prefix, host_to_device(np.full(m, match_len), dev),
            host_to_device(np.full(m, plen - match_len), dev),
            pg.ntp * pg.page))

        def complete() -> Admitted:
            _join(eng, ev, (logits, tails))
            pg.write_hits(slots_l, k_vt, v_vt, tails, pg.bt_tensor(bt_t))
            # the shared-prefix refs taken at lookup transfer to the
            # slots; free_slot releases each exactly once
            for gi, slot in enumerate(slots_l):
                pg.bt_u[slot], pg.bt_t[slot] = shares[gi], bt_t[gi]
                eng.rank_eff[slot] = r_ent
            pg.slab_t = max(pg.slab_t, match_len)
            pg.slab_r = max(pg.slab_r, r_ent)
            return (eng._sample_host(logits, 1)[:m],
                    np.full(m, match_len, np.int32))

        def cancel() -> None:
            # nothing is installed yet: the lookup's shared refs and the
            # fresh tail pages go back directly, each exactly once
            for gi in range(m):
                pg.alloc.release(shares[gi])
                pg.talloc.release(bt_t[gi])

        return self._ticket([batch[j] for j, _, _ in group], slots_l, plen,
                            ev, complete, cancel)

    def _dispatch_misses(self, batch: List[Any], slots_idx: List[int],
                         plen: int, padded: np.ndarray,
                         misses: List[int]) -> PrefillTicket:
        eng = self.eng
        pg = eng.pager
        nb = self._batch_rows(len(misses))
        mtoks = np.zeros((nb, plen), np.int32)
        for mi, j in enumerate(misses):
            mtoks[mi] = padded[j]
        (logits, fresh), ev = _on_side(eng, lambda: self._prefill(
            host_to_device(mtoks, eng.device)))
        npg = pg.pages_for(plen)
        bt_u, bt_t = [], []
        for _ in misses:
            pages = pg.alloc.alloc(npg)
            tpages = pg.talloc.alloc(pg.ntp)
            assert pages is not None and tpages is not None, \
                "page reservation failed after _reserve_pages"
            bt_u.append(pages)
            bt_t.append(tpages)
        slots_l = [slots_idx[j] for j in misses]
        nm = len(misses)

        def complete() -> Admitted:
            _join(eng, ev, (logits, fresh))
            r_eff = fresh["k_u"].shape[-1]
            pg.write_fresh(fresh, pg.bt_tensor(bt_u), pg.bt_tensor(bt_t),
                           slots_l, list(range(nm)))
            for mi, slot in enumerate(slots_l):
                pg.bt_u[slot], pg.bt_t[slot] = bt_u[mi], bt_t[mi]
                eng.rank_eff[slot] = r_eff
            pg.slab_t = max(pg.slab_t, plen)
            pg.slab_r = max(pg.slab_r, r_eff)
            if pg.prefix is not None:
                for mi, j in enumerate(misses):
                    pg.prefix.insert(padded[j].copy(), bt_u[mi],
                                     fresh["k_vt"][:, mi].clone(),
                                     fresh["v_vt"][:, mi].clone(), r_eff,
                                     n_pad=plen - len(batch[j].prompt))
            return (eng._sample_host(logits, 1)[:nm],
                    np.full(nm, plen, np.int32))

        def cancel() -> None:
            for mi in range(nm):
                pg.alloc.release(bt_u[mi])
                pg.talloc.release(bt_t[mi])

        return self._ticket([batch[j] for j in misses], slots_l, plen, ev,
                            complete, cancel)

    def gang(self, batch: List[Any], slots_idx: List[int], plen: int,
             has_live: bool) -> torch.Tensor:
        """Legacy admission on an all-free engine (``gang_live_splice``
        is False): prefill every slot row, the fresh cache replaces the
        old one."""
        eng = self.eng
        logits, cache = self._prefill(eng._toks(batch, eng.slots, plen,
                                                slots_idx))
        eng.cache = eng.shard.take_cache(eng.cfg, cache, axis=1)
        eng.rank_eff[slots_idx] = eng.cache["k_u"].shape[-1]
        return logits

    # -- decode ----------------------------------------------------------
    def decode(self, tok: torch.Tensor) -> torch.Tensor:
        eng = self.eng
        sd = eng.shard
        pos = torch.from_numpy(sd.take(eng.pos)).to(eng.device)
        frozen = torch.from_numpy(sd.take(eng.frozen_len)).to(eng.device)
        pg = eng.pager
        if pg is not None:
            logits, pg.cache = DK.decode_step_dkv_paged(
                eng.params, eng.cfg, tok, pg.cache, pos, frozen,
                pg.bt_tensor(sd.take(pg.bt_u)),
                pg.bt_tensor(sd.take(pg.bt_t), pg.ntp),
                pg.slab_t, pg.slab_r, eng.dkv_tail, attention=self._route())
            return logits
        logits, eng.cache = DK.decode_step_dkv(eng.params, eng.cfg, tok,
                                               eng.cache, pos, frozen,
                                               attention=self._route())
        return logits

    def _capturable(self) -> bool:
        # the plain statistics read t_valid on the host (the route check
        # runs its blocks eagerly, by design)
        return super()._capturable() and self._route() == "kernel"

    def decode_block(self, tok: np.ndarray, n: int, stops: np.ndarray
                     ) -> Tuple[np.ndarray, int]:
        eng = self.eng
        if eng.pager is not None:
            return self._decode_block_paged(tok, n, stops)
        c = eng.cache
        nl, b, t, r = c["k_u"].shape
        st = self._static
        if "k_u" not in st or st["k_u"].shape[2] < t \
                or st["k_u"].shape[3] != r:
            # the U buffers grow or change rank: new buffers, and the
            # graphs that read the old go.  Rows: t plus one tail (a fold
            # adds at most a tail's rows to t), rounded up to ROW_PAD
            tp = -(-(t + eng.dkv_tail) // ROW_PAD) * ROW_PAD
            st.clear()
            for key in ("k_u", "v_u"):
                st[key] = torch.zeros(nl, b, tp, r, device=eng.device,
                                      dtype=c[key].dtype)
            st["views"], st["pinned"] = {}, {}
            eng.graphs.clear()
        for key in ("k_u", "v_u"):
            # the exact slab stays a view of the padded buffer: folds and
            # splices work on it; the graph reads the whole buffer, and
            # rows at or past a live slot's frozen_len are never read
            if c[key] is not st["views"].get(key):
                view = st[key][:, :, :t]
                view.copy_(c[key])
                c[key] = st["views"][key] = view
        pin(c, st["pinned"], skip=("k_u", "v_u"))
        cache = {"k_u": st["k_u"], "v_u": st["v_u"], "k_vt": c["k_vt"],
                 "v_vt": c["v_vt"], "tail": c["tail"]}
        params, cfg, route = eng.params, eng.cfg, self._route()
        sampler = eng.decode_sampler
        sd = eng.shard

        def body(tok, pos, frozen, stops, live, key, round0, n_steps):
            buf, steps, _, _ = DK.decode_block_dkv(
                params, cfg, tok.long(), cache, pos, frozen, n_steps, stops,
                max_block=n, attention=route, slot_live=live.bool(),
                sampler=sampler, key=key, round0=round0)
            return buf, steps

        key = ("slab", route, n, sd.n, stops.shape[1], _shapes(cache))
        feed = {"tok": sd.take(tok), "pos": sd.take(eng.pos),
                "frozen": sd.take(eng.frozen_len), "stops": sd.take(stops),
                "live": _live(eng), **_sample_feed(eng),
                "n_steps": np.int32(n)}
        return self._run_block(key, body, feed, self._capturable())

    def _decode_block_paged(self, tok: np.ndarray, n: int,
                            stops: np.ndarray) -> Tuple[np.ndarray, int]:
        """Paged fused block: the pools are written in place; the slot
        factors, which a fold rebinds, are pinned; the block tables pad
        to ``pages_for(max_len)`` columns, so their width never changes a
        graph's key (the paged kernel reads rows below ``frozen_len``)."""
        eng = self.eng
        pg = eng.pager
        pin(pg.cache, self._static)
        cache = pg.cache
        params, cfg, route = eng.params, eng.cfg, self._route()
        t_need, r_need, tl = pg.slab_t, pg.slab_r, eng.dkv_tail
        sampler = eng.decode_sampler
        sd = eng.shard

        def body(tok, pos, frozen, stops, live, bt_u, bt_t, key, round0,
                 n_steps):
            buf, steps, _, _ = DK.decode_block_dkv_paged(
                params, cfg, tok.long(), cache, pos, frozen, bt_u, bt_t,
                n_steps, stops, t_need, r_need, tl, max_block=n,
                attention=route, slot_live=live.bool(), sampler=sampler,
                key=key, round0=round0)
            return buf, steps

        key = ("paged", route, n, sd.n, stops.shape[1], r_need,
               _shapes(cache))
        feed = {"tok": sd.take(tok), "pos": sd.take(eng.pos),
                "frozen": sd.take(eng.frozen_len), "stops": sd.take(stops),
                "live": _live(eng),
                "bt_u": pg.bt_array(sd.take(pg.bt_u),
                                    pg.pages_for(eng.max_len)),
                "bt_t": pg.bt_array(sd.take(pg.bt_t), pg.ntp),
                **_sample_feed(eng), "n_steps": np.int32(n)}
        return self._run_block(key, body, feed, self._capturable())

    def undo_overrun(self, steps: int, ran: int) -> None:
        """Zero the tail rows this rank's live slots wrote past the
        block's end: a fold folds the whole tail, whose rows past a
        slot's occupancy are zero in an engine that stopped there."""
        eng = self.eng
        sd, pg = eng.shard, eng.pager
        for j in range(sd.n):
            g = sd.first + j
            if eng.live[g] is None:
                continue
            occ = int(eng.pos[g] - eng.frozen_len[g])
            rows = range(occ + steps, min(occ + ran, eng.dkv_tail))
            if not len(rows):
                continue
            if pg is None:
                for t in eng.cache["tail"].values():
                    t[:, j, rows.start:rows.stop] = 0
                continue
            for r in rows:
                page = pg.bt_t[g][r // pg.page]
                for t in pg.cache["tail"].values():
                    t[:, page, r % pg.page] = 0

    # -- folds -----------------------------------------------------------
    def maybe_fold(self) -> None:
        """Fold every live slot whose tail is full, and co-fold live slots
        at least half full so staggered slots re-synchronize their fold
        cadence (a co-folded slot's unused tail rows fold as zeros)."""
        eng = self.eng
        live_m = np.array([r is not None for r in eng.live])
        occ = eng.pos - eng.frozen_len
        must = live_m & (occ >= eng.dkv_tail)
        if must.any():
            fold = must | (live_m & (occ >= max(1, eng.dkv_tail // 2)))
            # the span ends with the fold's own host reads (its QR/SVD):
            # it covers the device work up to them, and enqueue after
            with eng.trace.span("fold", "engine",
                                {"slots": int(fold.sum())}), \
                    phase_scope("fold"):
                if eng.pager is not None:
                    self._fold_slots_paged(live_m, must, fold)
                else:
                    self._fold_slots(live_m, fold)

    def _fold_slots(self, live_m: np.ndarray, fold: np.ndarray) -> None:
        eng = self.eng
        r_in = int(eng.cache["k_u"].shape[-1])
        t_frozen = int(eng.cache["k_u"].shape[2])
        new_frozen = np.where(fold, eng.pos, eng.frozen_len).astype(np.int32)
        dev, sd = eng.device, eng.shard
        # every rank folds (its slots' rows): the slab's geometry moves
        # alike on every rank
        eng.cache = DK.compress_tail(
            eng.cache, eng.cfg, eng.dkv_rank,
            frozen_len=torch.from_numpy(sd.take(eng.frozen_len)).to(dev),
            fold=torch.from_numpy(sd.take(fold)).to(dev),
            new_frozen=torch.from_numpy(sd.take(new_frozen)).to(dev))
        eng.frozen_len = new_frozen
        eng.rank_eff = np.where(
            fold, DK.fold_rank(eng.dkv_rank, r_in, t_frozen, eng.dkv_tail),
            eng.rank_eff).astype(np.int32)
        eng.stats.tail_folds += int(fold.sum())
        # keep only the rows and factor columns live slots reference
        t_need = int(eng.frozen_len[live_m].max())
        r_need = int(eng.rank_eff[live_m].max())
        for key in ("k_u", "v_u"):
            eng.cache[key] = eng.cache[key][:, :, :t_need,
                                            :r_need].contiguous()
        for key in ("k_vt", "v_vt"):
            eng.cache[key] = eng.cache[key][:, :, :r_need].contiguous()

    def _fold_slots_paged(self, live_m: np.ndarray, must: np.ndarray,
                          fold: np.ndarray) -> np.ndarray:
        """Paged tail fold: retruncated prefixes land in FRESH pages
        (copy-on-write — shared and prefix-cache pages are never
        rewritten); the folded slots' old page refs are released after
        the scatter.  Falls back to must-only folds when the pool can't
        take the co-folds, then evicts prefix entries."""
        eng = self.eng
        pg = eng.pager

        def grab(mask):
            idxs = [int(i) for i in np.where(mask)[0]]
            need = {i: pg.pages_for(int(eng.pos[i])) for i in idxs}
            if sum(need.values()) > pg.alloc.free_pages:
                return None
            return {i: pg.alloc.alloc(n) for i, n in need.items()}

        newp = grab(fold)
        if newp is None:
            fold = must
            newp = grab(fold)
        while newp is None and pg.prefix is not None and len(pg.prefix):
            pg.prefix._evict()
            newp = grab(fold)
        if newp is None:
            raise RuntimeError(
                "paged KV pool exhausted during a tail fold — raise "
                "kv_pool_pages (or lower slots/max_len)")
        npn = max(len(v) for v in newp.values())
        new_frozen = np.where(fold, eng.pos,
                              eng.frozen_len).astype(np.int32)
        dev, sd = eng.device, eng.shard
        # the fresh pages of a folded slot are written on the rank that
        # holds it, and read only there (serving.paged)
        pg.cache = DK.compress_tail_paged(
            pg.cache, eng.cfg, eng.dkv_rank,
            frozen_len=torch.from_numpy(sd.take(eng.frozen_len)).to(dev),
            fold=torch.from_numpy(sd.take(fold)).to(dev),
            new_frozen=torch.from_numpy(sd.take(new_frozen)).to(dev),
            bt_u=pg.bt_tensor(sd.take(pg.bt_u)),
            bt_u_new=pg.bt_tensor(sd.take([newp.get(i, [])
                                           for i in range(eng.slots)]), npn),
            bt_t=pg.bt_tensor(sd.take(pg.bt_t), pg.ntp), t_need=pg.slab_t,
            r_need=pg.slab_r, tail_len=eng.dkv_tail)
        r_fold = DK.fold_rank(eng.dkv_rank, pg.slab_r, pg.slab_t,
                              eng.dkv_tail)
        for i, pages in newp.items():
            pg.alloc.release(pg.bt_u[i])
            pg.bt_u[i] = pages
            eng.rank_eff[i] = r_fold
        eng.frozen_len = new_frozen
        eng.stats.tail_folds += int(fold.sum())
        pg.slab_t = int(eng.frozen_len[live_m].max())
        pg.slab_r = int(eng.rank_eff[live_m].max())
        return fold
