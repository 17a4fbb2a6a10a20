"""Tokenized data of the training path: the synthetic stream, memmap
shards, per-host sharding, background prefetch, deterministic resume.

The port's own numpy copy of ``repro.data``: its batches equal the
reference's bit for bit (the same ``RandomState`` draws in the same
order).  Every batch is a pure function of (seed, step, host), so the
pipeline's whole state is the step: a restart replays the stream from
the restored step, and any host can compute any shard.  Batches are
numpy arrays (int32 tokens and labels, float32 extras); the driver moves
them to the device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np

from .configs import ArchConfig, ShapeSpec


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    pad_id: int = 0


class SyntheticLM:
    """Deterministic synthetic LM stream: token t+1 follows token t
    through a fixed random permutation of the vocab, replaced by a random
    token with probability 0.1 (learnable, so a few steps lower the
    loss).  vlm batches also carry ``image_embeds`` [B, n_img, H] and
    audio batches ``frames`` [B, S, H] (N(0, 0.02²), float32)."""

    def __init__(self, cfg: ArchConfig, shape: ShapeSpec, data: DataConfig):
        self.cfg, self.shape, self.data = cfg, shape, data
        rng = np.random.RandomState(1234)
        self.perm = rng.permutation(cfg.vocab)
        if shape.global_batch % data.num_hosts:
            raise ValueError(f"global batch {shape.global_batch} does not "
                             f"split over {data.num_hosts} hosts")
        self.host_batch = shape.global_batch // data.num_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The batch of ``step`` on this host (a pure function of both)."""
        rng = np.random.RandomState(
            ((self.data.seed * 1_000_003 + step) * 4096
             + self.data.host_id) % (2 ** 32))
        b, s, v = self.host_batch, self.shape.seq_len, self.cfg.vocab
        toks = np.empty((b, s), np.int32)
        toks[:, 0] = rng.randint(0, v, b)
        noise = rng.rand(b, s) < 0.1
        rand_tok = rng.randint(0, v, (b, s))
        for t in range(1, s):
            nxt = self.perm[toks[:, t - 1]]
            toks[:, t] = np.where(noise[:, t], rand_tok[:, t], nxt)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1                  # ignore the final position
        batch = {"tokens": toks, "labels": labels}
        if self.cfg.family == "vlm":
            batch["image_embeds"] = rng.randn(
                b, self.cfg.num_image_tokens, self.cfg.d_model
            ).astype(np.float32) * 0.02
        if self.cfg.family == "audio":
            batch["frames"] = rng.randn(b, s, self.cfg.d_model) \
                .astype(np.float32) * 0.02
        return batch


class MemmapShards:
    """A pre-tokenized corpus in ``.npy`` shards (rows of tokens); host h
    takes rows h, h + H, … of each step's draw.  The rows of a step are
    computed from (seed, step), never iterated statefully."""

    def __init__(self, paths, cfg: ArchConfig, shape: ShapeSpec,
                 data: DataConfig):
        self.mm = [np.load(p, mmap_mode="r") for p in paths]
        self.rows = sum(m.shape[0] for m in self.mm)
        self.offsets = np.cumsum([0] + [m.shape[0] for m in self.mm])
        self.cfg, self.shape, self.data = cfg, shape, data
        self.host_batch = shape.global_batch // data.num_hosts

    def _row(self, i: int) -> np.ndarray:
        shard = int(np.searchsorted(self.offsets, i, "right") - 1)
        return np.asarray(self.mm[shard][i - self.offsets[shard]])

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(
            (self.data.seed * 1_000_003 + step) % (2 ** 32))
        idx = rng.randint(0, self.rows, self.shape.global_batch)
        mine = idx[self.data.host_id::self.data.num_hosts][:self.host_batch]
        toks = np.stack([self._row(i)[:self.shape.seq_len] for i in mine]) \
            .astype(np.int32)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1
        return {"tokens": toks, "labels": labels}


class Prefetcher:
    """A background thread computing the batches of steps ``start_step``,
    ``start_step + 1``, … up to ``depth`` ahead; iterating yields
    (step, batch).  ``stop`` ends the thread."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self.step
        while not self._stop.is_set():
            item = (step, self.source.batch_at(step))
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.05)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self.q.get()

    def stop(self):
        """End the thread (it leaves a blocked ``put`` within 50 ms) and
        drop the batches computed ahead."""
        self._stop.set()
        self._thread.join()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
