"""The one traffic generator: lengths, arrivals and token ids from a seed.

Every mix draws its sizes from a fixed set: a list of ``pool`` values at
the quantiles (i + ½)/pool of the mix's distribution.  The seed only
orders that set (a permutation) and draws the token ids, so every seed
asks for the same work in another order, and two seeds' runs differ by
order alone.  Distributions (a mix file's ``{"dist": ...}`` objects):

* ``{"dist": "fixed", "value": n}``;
* ``{"dist": "uniform", "lo": a, "hi": b}`` — integers in [a, b];
* ``{"dist": "lognormal", "median": m, "sigma": s, "lo": a, "hi": b}`` —
  exp(ln m + s·z) rounded, clipped to [a, b].

A serving mix's ``in_flight`` object (``{"requests": n, "step": s}``)
makes the stream's first ``n`` requests the ones a steady engine holds
when the window opens.  They are one fixed set: the ``n`` quantiles of
the prompt and of the output distribution and the shares (k + ½)/n of
an output already served, joined into triples by a draw that no seed
changes; the seed only orders the set.  Each has its share of its
output, rounded down to a multiple of ``s``, moved into its prompt (the
served part as ids of its own) and out of its budget.  With ``s`` the
scheduler's bucket, an in-flight request's admission length plus its
budget stays within the original request's.  The stream proper follows
them.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict

import numpy as np

DEFAULT_POOL = 512


def quantiles(spec: Dict, n: int) -> np.ndarray:
    """The ``n`` values of ``spec`` at the quantiles (i + ½)/n (int64)."""
    u = (np.arange(n) + 0.5) / n
    kind = spec["dist"]
    if kind == "fixed":
        return np.full(n, int(spec["value"]), np.int64)
    if kind == "uniform":
        lo, hi = int(spec["lo"]), int(spec["hi"])
        return np.floor(lo + u * (hi - lo + 1)).astype(np.int64).clip(lo, hi)
    if kind == "lognormal":
        nd = NormalDist()
        z = np.array([nd.inv_cdf(float(x)) for x in u])
        v = np.rint(np.exp(math.log(spec["median"]) + spec["sigma"] * z))
        return v.clip(spec["lo"], spec["hi"]).astype(np.int64)
    raise ValueError(f"unknown length distribution {kind!r}")


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of a seed (0 order, 1 token ids, ...)."""
    return np.random.Generator(np.random.PCG64([int(seed) & (2**64 - 1),
                                                int(stream)]))


class Requests:
    """The seeded request stream of a serving mix: request ``i`` has a
    prompt of ``prompt_len(i)`` ids in [1, vocab) and an output budget
    ``output_len(i)``; the first ``in_flight`` of them are caught
    mid-output (module docstring).  The stream proper is unbounded: it
    cycles the permuted pools, re-permuted each cycle."""

    def __init__(self, mix: Dict, vocab: int, seed: int):
        self.mix, self.vocab, self.seed = mix, int(vocab), int(seed)
        self.pool = int(mix.get("pool", DEFAULT_POOL))
        self._pl = quantiles(mix["prompt"], self.pool)
        self._ol = quantiles(mix["output"], self.pool)
        fl = mix.get("in_flight", {})
        n = self.in_flight = int(fl.get("requests", 0))
        self._step = int(fl.get("step", 1))
        fixed = rng(0, 5)
        k = rng(seed, 4).permutation(n)
        self._flight_pl = quantiles(mix["prompt"], n)[k]
        self._flight_ol = quantiles(mix["output"], n)[fixed.permutation(n)][k]
        self.shares = ((np.arange(n) + 0.5) / max(n, 1))[
            fixed.permutation(n)][k]
        self._cycles: Dict[int, tuple] = {}
        self._ids = rng(seed, 1)

    def _cycle(self, c: int):
        if c not in self._cycles:
            g = rng(self.seed, 1000 + c)
            self._cycles[c] = (g.permutation(self.pool),
                               g.permutation(self.pool))
        return self._cycles[c]

    def _lens(self, i: int):
        """(prompt, output) of request ``i`` before any is served."""
        if i < self.in_flight:
            return int(self._flight_pl[i]), int(self._flight_ol[i])
        c, j = divmod(i - self.in_flight, self.pool)
        perm = self._cycle(c)
        return int(self._pl[perm[0][j]]), int(self._ol[perm[1][j]])

    def served(self, i: int) -> int:
        """The output tokens request ``i`` had been served before the
        window opened (0 past the in-flight ones)."""
        if i >= self.in_flight:
            return 0
        s = self._step
        return int(self.shares[i] * self._lens(i)[1]) // s * s

    def prompt_len(self, i: int) -> int:
        return self._lens(i)[0] + self.served(i)

    def output_len(self, i: int) -> int:
        return self._lens(i)[1] - self.served(i)

    def prompt(self, i: int) -> np.ndarray:
        """Request ``i``'s prompt ids, drawn in request order (so ask for
        them in order: the ids of request i are the i-th draw)."""
        return self._ids.integers(1, self.vocab, self.prompt_len(i),
                                  dtype=np.int64).astype(np.int32)


def forward_tokens(vocab: int, seed: int, batch: int, length: int,
                   count: int) -> np.ndarray:
    """``count`` token batches [batch, length] of ids in [1, vocab) for
    back-to-back forward calls (int64 [count, batch, length])."""
    return rng(seed, 1).integers(1, int(vocab), (count, batch, length),
                                 dtype=np.int64)
