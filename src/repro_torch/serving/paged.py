"""Paged decomposed-KV cache: page allocator, prefix cache, paged state.

Counterpart of ``repro.serving.paged`` (its host logic, copied: that
module imports JAX).  On top of ``models.decomposed_kv``'s page pools:

* :class:`PageAllocator` — refcounted free-list over page ids.  Id 0 is
  reserved as the WRITE SINK (block-table padding and non-folding slots'
  fold-scatter targets); real pages are 1..num_pages-1.
* :class:`PrefixCache` — hash-keyed store of frozen decomposed prefixes
  at page granularity.  One insertion registers every page-aligned
  boundary of the prompt as a match point; lookup returns the LONGEST
  cached prefix of a new padded prompt whose remaining suffix fits in
  the dense tail.  Entries hold page refs, so a slot's lifecycle (folds
  free its old pages) never invalidates cached pages — folds
  copy-on-write into fresh pages.
* :class:`PagedDKV` — per-engine paged state: pools, block tables, the
  two allocators, the HOST MIRROR of the slot engine's slab geometry
  (``slab_t``/``slab_r``) that makes paged arithmetic the slab engine's,
  and the two admission writes (a fresh prefill's pages; a prefix hit's
  tail-only suffix prefill).

On a mesh (``serving.Engine``'s slot-sharded mode) the pools are
REPLICATED, as the rules keep them (``cache_pspec``: any slot may read
any shared page), and each rank holds only its slots' factor rows
(``k_vt``/``v_vt``).  Every rank runs the same host page logic, so the
allocators, block tables and prefix cache are the same on every rank,
and the admission writes (a fresh prefill's U pages, a hit's tail
pages, the zeroing of a slot's tail pages) are made by every rank from
the admission's replicated factors, so those pages hold the same values
everywhere.  The decode-time writes are not all-gathered: a slot's tail
row written at decode and the fresh U pages written by its fold land
only on the rank that holds the slot, and are read only there.  A page
is read through the block table of the slot that holds it; the prefix
cache holds only admission pages; folds copy-on-write into fresh pages
and never rewrite a shared one; and a page freed and reused is written
again (by an admission on every rank, or by the fold or decode of its
new slot's rank) before any of its rows is read.  So no rank reads a
page row another rank wrote alone, and after the queue drains every
page is back in the pool on every rank.

A prefix-cache hit admits with TAIL-ONLY work: the matched pages are
shared by reference (refcount bump), the per-slot Vᵀ factors are copied
from the entry, and only the suffix tokens run a forward pass
(``prefill_suffix_dkv``) — no prefix forward, no Lanczos.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import decomposed_kv as DK

SINK = 0                             # reserved write-sink page id


class PageAllocator:
    """Refcounted free-list allocator over page ids ``1..num_pages-1``.

    ``alloc`` returns None when the pool can't satisfy the request (the
    caller defers admission); ``release`` decrements and returns a page
    to the free list at refcount zero; releasing an unallocated page
    raises (double-free guard).
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"a page pool of {num_pages} pages has no "
                             f"real page beside the sink (need >= 2)")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._ref: Dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_refs(self) -> Dict[int, int]:
        return dict(self._ref)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def ref(self, pages: List[int]) -> None:
        for p in pages:
            if p not in self._ref:
                raise ValueError(f"ref of unallocated page {p}")
            self._ref[p] += 1

    def release(self, pages: List[int]) -> None:
        for p in pages:
            rc = self._ref.get(p)
            if rc is None:
                raise ValueError(f"double free of page {p}")
            if rc == 1:
                del self._ref[p]
                self._free.append(p)
            else:
                self._ref[p] = rc - 1


@dataclasses.dataclass
class PrefixEntry:
    tokens: np.ndarray               # the full padded prompt (int32)
    pages: List[int]                 # FULL pages: rows 0..len(pages)·page
    k_vt: torch.Tensor               # [nl, r_eff, kvw]
    v_vt: torch.Tensor
    r_eff: int
    n_pad: int = 0                   # left-pad rows (bucket rounding)


class PrefixCache:
    """LRU cache of frozen decomposed prefixes, matched at page-aligned
    boundaries of the PADDED prompt (the engine left-pads prompts to the
    scheduler bucket, and the cached factors were computed over exactly
    those rows), so prompts share a prefix when their padded forms do."""

    def __init__(self, capacity: int, page: int, alloc: PageAllocator):
        self.capacity = max(1, capacity)
        self.page = page
        self.alloc = alloc
        self._entries: "OrderedDict[bytes, PrefixEntry]" = OrderedDict()
        self._by_prefix: Dict[Tuple[int, bytes], PrefixEntry] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _digest(tokens: np.ndarray) -> bytes:
        return hashlib.sha1(np.ascontiguousarray(
            tokens.astype(np.int32)).tobytes()).digest()

    def _boundaries(self, n_tokens: int, n_pad: int = 0):
        """Page-aligned match lengths: every full page, suffix non-empty,
        and past the left-pad region — a boundary lying entirely inside
        the bucket padding would "match" unrelated prompts that merely
        share a pad count (the entry's basis was fit to ITS real rows)."""
        top = (n_tokens - 1) // self.page * self.page
        lo = n_pad // self.page * self.page + self.page
        return range(lo, top + 1, self.page)

    def lookup(self, padded: np.ndarray, max_suffix: int, n_pad: int = 0,
               record: bool = True) -> Optional[Tuple[PrefixEntry, int]]:
        """Longest cached prefix of ``padded`` whose suffix fits in
        ``max_suffix`` tail rows and which covers at least one of the
        query's REAL tokens (``n_pad`` = its left-pad row count).
        ``record=False`` skips the hit/miss counters (the LRU touch still
        happens): the engine probes at every admission attempt and counts
        once per ADMITTED request."""
        n = len(padded)
        for ln in reversed(self._boundaries(n, n_pad)):
            if n - ln > max_suffix:
                break                # shorter matches only lengthen it
            ent = self._by_prefix.get((ln, self._digest(padded[:ln])))
            if ent is not None and np.array_equal(ent.tokens[:ln],
                                                  padded[:ln]):
                self._entries.move_to_end(self._digest(ent.tokens))
                if record:
                    self.hits += 1
                return ent, ln
        if record:
            self.misses += 1
        return None

    def insert(self, padded: np.ndarray, pages: List[int], k_vt, v_vt,
               r_eff: int, n_pad: int = 0) -> None:
        """Register a freshly decomposed prompt.  Takes its own page refs
        on the full pages it covers; evicts LRU entries past capacity."""
        key = self._digest(padded)
        if key in self._entries:
            self._entries.move_to_end(key)
            return
        bounds = list(self._boundaries(len(padded), n_pad))
        if not bounds:
            return                   # no boundary past padding + 1 page
        ent = PrefixEntry(tokens=np.array(padded, np.int32),
                          pages=list(pages[:bounds[-1] // self.page]),
                          k_vt=k_vt, v_vt=v_vt, r_eff=r_eff, n_pad=n_pad)
        self.alloc.ref(ent.pages)
        self._entries[key] = ent
        for ln in bounds:
            self._by_prefix[(ln, self._digest(padded[:ln]))] = ent
        while len(self._entries) > self.capacity:
            self._evict()

    def _evict(self) -> None:
        key, ent = self._entries.popitem(last=False)
        for ln in self._boundaries(len(ent.tokens), ent.n_pad):
            k = (ln, self._digest(ent.tokens[:ln]))
            if self._by_prefix.get(k) is ent:
                del self._by_prefix[k]
        self.alloc.release(ent.pages)
        self.evictions += 1
        # re-expose boundaries the evicted entry SHADOWED: an older live
        # entry sharing a prefix re-registers, so its pages don't sit
        # pinned-but-unreachable behind deleted keys
        for other in self._entries.values():
            for ln in self._boundaries(len(other.tokens), other.n_pad):
                k = (ln, self._digest(other.tokens[:ln]))
                self._by_prefix.setdefault(k, other)

    def drop_all(self) -> None:
        while self._entries:
            self._evict()


class PagedDKV:
    """Pools + block tables + allocators + slab-geometry mirror for one
    serving engine.  Bookkeeping is host-side python/numpy; the device
    work is in ``models.decomposed_kv`` and the two admission writes
    below."""

    def __init__(self, cfg, *, slots: int, max_len: int, rank: int,
                 tail: int, page: int, pool_pages: int = 0,
                 prefix_capacity: int = 0, device=None, shard=None):
        from ..models.api import SlotShard
        self.cfg, self.device = cfg, device
        # the slots whose factor rows this rank holds (every one without
        # a mesh)
        self.shard = shard if shard is not None else SlotShard(slots)
        self.page = max(1, page)
        self.rank = min(rank, cfg.kv_width)
        self.tail = tail
        self.ntp = -(-tail // self.page)          # tail pages per slot
        per_slot = 2 * (-(-max_len // self.page))
        self.num_pages = pool_pages or slots * per_slot + 1
        self.num_tail_pages = slots * self.ntp + 1
        self.alloc = PageAllocator(self.num_pages)
        self.talloc = PageAllocator(self.num_tail_pages)
        self.cache = DK.init_paged_cache(cfg, self.shard.n, self.num_pages,
                                         self.page, self.rank,
                                         self.num_tail_pages, device=device)
        self.bt_u: List[List[int]] = [[] for _ in range(slots)]
        self.bt_t: List[List[int]] = [[] for _ in range(slots)]
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(prefix_capacity, self.page, self.alloc)
            if prefix_capacity else None)
        # host mirror of the slot engine's slab geometry — decode and
        # folds slice to exactly these dims, so the math is the slab's
        self.slab_t = 0
        self.slab_r = 0

    # -- block-table helpers ---------------------------------------------
    def pages_for(self, n_rows: int) -> int:
        return -(-max(0, n_rows) // self.page)

    def bt_array(self, lists: List[List[int]], width: int = 0) -> np.ndarray:
        width = width or max([len(p) for p in lists] + [1])
        a = np.full((len(lists), width), SINK, np.int32)
        for i, ps in enumerate(lists):
            a[i, :len(ps)] = ps
        return a

    def bt_tensor(self, lists: List[List[int]],
                  width: int = 0) -> torch.Tensor:
        """:meth:`bt_array` as an int32 tensor on the pools' device."""
        return torch.from_numpy(self.bt_array(lists, width)).to(self.device)

    def free_slot(self, slot: int) -> None:
        if self.bt_u[slot]:
            self.alloc.release(self.bt_u[slot])
            self.bt_u[slot] = []
        if self.bt_t[slot]:
            self.talloc.release(self.bt_t[slot])
            self.bt_t[slot] = []

    @property
    def pool_bytes(self) -> int:
        c = self.cache
        leaves = [c[k] for k in ("k_u_pages", "v_u_pages", "k_vt", "v_vt")]
        leaves += list(c["tail"].values())
        return sum(x.numel() * x.element_size() for x in leaves)

    # -- admission writes ------------------------------------------------
    def _set_factors(self, idx, k_vt, v_vt) -> None:
        """Slot rows ``idx`` of the Vᵀ factors ← k_vt/v_vt [nl, m, r, kvw]
        (rank zero-padded to the pool width); only the held slots' rows
        are written."""
        loc, src = self.shard.pairs(idx)
        if not loc:
            return
        loc_t = torch.as_tensor(loc, device=self.device).long()
        src_t = torch.as_tensor(src, device=self.device).long()
        for key, vt in (("k_vt", k_vt), ("v_vt", v_vt)):
            buf = self.cache[key]
            buf[:, loc_t] = DK._pad_axis(vt[:, src_t], 2,
                                         buf.shape[2]).to(buf.dtype)

    def write_fresh(self, fresh, bt_u, bt_t, idx, src) -> None:
        """A fresh prefill into the pools: U rows of batch rows ``src``
        into pages ``bt_u`` [m, n], Vᵀ into slot rows ``idx``, and the
        slots' tail pages ``bt_t`` [m, ntp] ZEROED (pages are recycled
        across requests; a fresh slot's tail must read zero)."""
        c = self.cache
        src_t = torch.as_tensor(src, device=self.device).long()
        for key in ("k_u", "v_u"):
            DK.write_prefix_pages(c[key + "_pages"], fresh[key], bt_u, src)
        self._set_factors(idx, fresh["k_vt"][:, src_t],
                          fresh["v_vt"][:, src_t])
        for pool in c["tail"].values():
            pool[:, bt_t.long()] = 0

    def hit_prefix(self, ent_bt, k_vt, v_vt, match_len: int,
                   r_ent: int):
        """The cached factors of a prefix-cache hit: the entries' pages
        ``ent_bt`` [m, match_len/page] gathered into slab rows, and their
        Vᵀ, cut to the entries' rank — the ``prefix`` of
        ``DK.prefill_suffix_dkv``."""
        c = self.cache
        return {
            "k_u": DK.gather_pages(c["k_u_pages"], ent_bt,
                                   match_len)[..., :r_ent],
            "v_u": DK.gather_pages(c["v_u_pages"], ent_bt,
                                   match_len)[..., :r_ent],
            "k_vt": k_vt[:, :, :r_ent], "v_vt": v_vt[:, :, :r_ent],
        }

    def write_hits(self, idx, k_vt, v_vt, tails, bt_t) -> None:
        """The write half of a hit: Vᵀ into slot rows ``idx`` and the
        suffix K/V ``tails`` into the tail pages ``bt_t`` [m, ntp]."""
        self._set_factors(idx, k_vt, v_vt)
        for key in ("k", "v"):
            DK.scatter_pages(self.cache["tail"][key + "_pages"], tails[key],
                             bt_t)
