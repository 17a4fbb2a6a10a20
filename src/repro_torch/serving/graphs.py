"""CUDA-graph runner of the fused decode block.

Counterpart of the reference's lru of jitted decode-block functions
(``repro.serving.families._jitted_decode_block``).  A fused block is one
fixed-length loop of decode steps (``models.api.run_decode_block``);
eagerly it costs the same host dispatch as that many single steps.  On
the card :class:`BlockGraphs` captures each block once as a CUDA graph
and replays it, so a block of n steps costs one launch from the host:

* **Keys.**  A graph is keyed on everything its kernels read the address
  or the shape of: the family and its route, ``n`` (the block's steps),
  the slot count, the stop-table width and the shapes and addresses of
  the cache buffers the family hands in.  An engine holds a small LRU of
  graphs that share one memory pool; the engine owns them, so ``del
  eng`` frees them.
* **Static inputs.**  Everything that changes from block to block (the
  last tokens, ``pos``, ``frozen_len``, the stop table, block tables, the
  sample key and the block's first round, which a keyed sampler folds
  on the device, and the step count) lives in one int32 device buffer
  per graph, filled by one host-to-device copy before each replay.  The
  outputs — the packed ``[steps, buf]`` — are read back by one copy
  after it: the only sync.
* **Warm-up.**  Before the first capture into an empty runner (a new
  engine, or new cache buffers after :meth:`BlockGraphs.clear`) the
  block's function runs once eagerly on the capture stream (one side
  stream per device, ``platform.capture_stream``) with the step count
  at 0, so it changes no state, as PyTorch's capture recipe asks:
  library handles, the kernels' attributes and their ticket counters
  (``kernels.build.tickets``) are set up there, never under capture.
  Blocks of other lengths run the same steps on the same buffers and
  need no warm-up of their own.  Each graph keeps every ticket buffer
  alive.
* **Launch counts.**  A wrapper counts when Python calls it, and a replay
  calls no Python.  The capture's increments are taken back (nothing ran)
  and its per-kernel delta is added on every replay; the warm-up's
  launches did run and stay counted, and are kept apart in
  :attr:`BlockGraphs.warmup_launches`.
* **Collectives.**  Under tensor parallelism a block holds the model
  axis's all-reduces; they are captured with it, counted at capture,
  taken back and counted again per replay, as the launches are
  (``distributed.sharding.take_collective_delta``).  A capture that
  fails while it issues collectives raises, naming the cause; it never
  falls back to eager blocks.
* **Counters.**  ``captures``, ``replays`` and ``eager`` are counters of
  the engine's metrics registry (``serving_graph_captures``,
  ``serving_graph_replays``, ``serving_graph_eager``), and each capture
  (its warm-up included) is counted with its host seconds in the compile
  watch (``obs.record_compile("cuda_graph", …)``) under the caller's
  phase.  All of it is counted outside the captured body, which runs
  Python once, at capture.
* **Eager blocks.**  On the host, or where a family's route cannot be
  captured (the plain dkv statistics read ``t_valid`` on the host), the
  same function runs eagerly on the same buffers.  With the kernel route
  on the card a failed capture or replay raises: nothing decodes eagerly
  in its place.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Dict, Hashable, List, Mapping, Tuple

import numpy as np
import torch

from ..kernels import build, ops
from ..obs import MetricsRegistry, record_compile
from ..distributed import sharding as sh
from ..platform import capture_stream

Feed = Mapping[str, np.ndarray]
Body = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


#: graphs an engine keeps (every block length up to 16, per cache shape)
CAPACITY = 16


class _Entry:
    """One captured block: its graph, static input buffer, packed output,
    launch delta, collective delta, and the ticket buffers it uses."""

    def __init__(self, graph, flat, out, delta, keep, coll=None):
        self.graph, self.flat, self.out = graph, flat, out
        self.delta, self.keep = delta, keep
        self.coll = coll or {}


def _layout(feed: Feed) -> Tuple[Tuple[str, Tuple[int, ...], int], ...]:
    """(name, shape, offset) of each input in the packed int32 buffer."""
    out, off = [], 0
    for name, val in feed.items():
        shape = tuple(np.shape(val))
        out.append((name, shape, off))
        off += int(np.prod(shape, dtype=np.int64))
    return tuple(out)


def _pack(feed: Feed) -> np.ndarray:
    return np.concatenate([np.asarray(v, np.int32).reshape(-1)
                           for v in feed.values()])


def _views(flat: torch.Tensor, layout) -> Dict[str, torch.Tensor]:
    return {name: flat[off:off + int(np.prod(shape, dtype=np.int64))]
            .view(shape) for name, shape, off in layout}


def pin(tree: dict, static: dict, skip=()) -> None:
    """Keep each tensor leaf of the cache ``tree`` (nested dicts, keys in
    ``skip`` left out) in the buffer ``static`` holds for it, which the
    graphs read: a leaf that is another tensor (a fold or a gang
    admission rebound it) is copied in, and the tree points at the buffer
    again.  A leaf ``static`` has no buffer for yet becomes its buffer.
    In-place writes (per-slot splices, page writes) land in the buffers
    directly."""
    for k, leaf in tree.items():
        if k in skip:
            continue
        if isinstance(leaf, dict):
            pin(leaf, static.setdefault(k, {}))
            continue
        buf = static.setdefault(k, leaf)
        if leaf is not buf:
            buf.copy_(leaf)
            tree[k] = buf


class BlockGraphs:
    """The captured fused decode blocks of one engine (an LRU of at most
    :data:`CAPACITY` graphs in one memory pool), with the counts a run
    reports: ``captures``, ``replays``, ``eager`` (blocks run without a
    graph) — counters of ``registry`` (the engine's) — and ``capture_s``
    (host seconds spent in warm-up and capture)."""

    def __init__(self, device: torch.device, registry: MetricsRegistry):
        self.device = torch.device(device)
        self._lru: "OrderedDict[Hashable, _Entry]" = OrderedDict()
        self._pool = None
        self._captures = registry.counter(
            "serving_graph_captures",
            "fused decode blocks captured as CUDA graphs")
        self._replays = registry.counter("serving_graph_replays",
                                         "fused decode blocks replayed")
        self._eager = registry.counter(
            "serving_graph_eager", "fused decode blocks run without a graph")
        self.capture_s = 0.0
        self.warmup_launches: Dict[str, int] = {}

    @property
    def captures(self) -> int:
        return self._captures.value

    @property
    def replays(self) -> int:
        return self._replays.value

    @property
    def eager(self) -> int:
        return self._eager.value

    def _index(self) -> int:
        return self.device.index if self.device.index is not None \
            else torch.cuda.current_device()

    def clear(self) -> None:
        """Drop every graph (the buffers a key names were reallocated),
        and with the last graph its memory pool: the next capture takes
        a new one (a pool no graph holds any more is gone)."""
        self._lru.clear()
        self._pool = None

    def __len__(self) -> int:
        return len(self._lru)

    def run(self, key: Hashable, body: Body, feed: Feed, *,
            capture: bool, gather=None) -> np.ndarray:
        """One fused block: ``body(**inputs)`` → (buf int32 [n, B], steps
        int32 []), where ``inputs`` are ``feed``'s int32 arrays on the
        device (its ``"n_steps"`` the step count).  With ``capture`` (the card
        only) the block replays the graph of ``key``, captured at first
        use.  Returns ``[steps, *buf.flatten()]`` on the host; with
        ``gather`` (a slot-sharded engine's all-gather over its DP
        group, run after the replay, never inside a graph) the ranks'
        packed outputs one after another."""
        def readback(out: torch.Tensor) -> np.ndarray:
            if gather is not None:
                out = gather(out)
            # the block's one readback: its tokens and step count
            return out.cpu().numpy()  # dcomlint: disable=J2

        if not capture:
            flat = torch.from_numpy(_pack(feed)).to(self.device)
            buf, steps = body(**_views(flat, _layout(feed)))
            self._eager.inc()
            return readback(_packed(buf, steps))
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not "
                             f"{self.device}")
        ent = self._lru.get(key)
        if ent is None:
            ent = self._capture(body, feed)
            self._lru[key] = ent
            while len(self._lru) > CAPACITY:
                self._lru.popitem(last=False)
        else:
            self._lru.move_to_end(key)
        ent.flat.copy_(torch.from_numpy(_pack(feed)))
        ent.graph.replay()
        self._replays.inc()
        for name, d in ent.delta.items():
            ops.KERNELS[name].launches += d
        sh.add_collectives(ent.coll)
        return readback(ent.out)

    def _capture(self, body: Body, feed: Feed) -> _Entry:
        t0 = time.perf_counter()
        dev = self.device
        layout = _layout(feed)
        flat = torch.from_numpy(_pack(feed)).to(dev)
        inputs = _views(flat, layout)
        inputs["n_steps"].zero_()        # warm-up and capture: no step
        if not self._lru:
            self._warm_up(body, inputs)
        warm = ops.launch_counts()
        coll = sh.snapshot()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=capture_stream(self._index())):
                out = _packed(*body(**inputs))
        except Exception as e:
            if sh.snapshot() == coll:
                raise
            raise RuntimeError(
                f"a fused decode block that issues collectives (tensor "
                f"parallelism's all-reduces over 'model') could not be "
                f"captured as a CUDA graph on this torch ({e!r}); serve "
                f"this mesh with decode_block=1 (ROADMAP.md, distribution)"
            ) from e
        after = ops.launch_counts()
        delta = {k: after[k] - warm[k] for k in after if after[k] != warm[k]}
        for name, v in warm.items():     # the capture launched nothing
            ops.KERNELS[name].launches = v
        coll = sh.take_collective_delta(coll)
        secs = time.perf_counter() - t0
        self._captures.inc()
        self.capture_s += secs
        record_compile("cuda_graph", secs)
        return _Entry(graph, flat, out, delta, build.ticket_buffers(), coll)

    def _warm_up(self, body: Body, inputs: Dict[str, torch.Tensor]) -> None:
        """Run ``body`` once on the capture stream (its step count is 0);
        its launches are real and are added to :attr:`warmup_launches`."""
        dev = self.device
        side = capture_stream(self._index())
        side.wait_stream(torch.cuda.current_stream(dev))
        before = ops.launch_counts()
        with torch.cuda.stream(side):
            body(**inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        for name, v in ops.launch_counts().items():
            if v != before[name]:
                self.warmup_launches[name] = \
                    self.warmup_launches.get(name, 0) + v - before[name]


def _packed(buf: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """[steps, *buf.flatten()] as one int32 tensor (one readback)."""
    return torch.cat([steps.reshape(1).to(torch.int32),
                      buf.reshape(-1).to(torch.int32)])


def unpack(host: np.ndarray, slots: int, parts: int = 1
           ) -> Tuple[np.ndarray, int, List[int]]:
    """:meth:`BlockGraphs.run`'s result → (tokens [steps, slots], steps,
    each part's steps).  ``parts`` > 1: a gathered result, the packed
    outputs of ``parts`` ranks that hold ``slots // parts`` slots each,
    in slot order; the block took the fewest steps any rank took (a rank
    halts on its own slots' stop tokens), and a rank that ran on is the
    caller's to repair."""
    per = host.reshape(parts, -1)
    ran = [int(k) for k in per[:, 0]]
    steps = min(ran)
    toks = per[:, 1:].reshape(parts, -1, slots // parts)
    return toks.transpose(1, 0, 2).reshape(-1, slots)[:steps], steps, ran
