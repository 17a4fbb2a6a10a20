"""Token samplers of the serving engine, and the keyed draw.

Counterpart of the reference's ``greedy_sampler`` / ``categorical_sampler``
(``repro.serving``).  A sampler is called ``sampler(logits, k)`` → int32
[B]; a keyed one (``takes_key = True``) is called ``sampler(logits, k,
key)``.  The engine derives every key as ``fold_in(fold_in(prng_key(seed),
stream), round)`` (stream 0 decode, stream 1 admission; ``round`` the
engine's decode-round counter), so the single-step path and a fused
block of any length draw the same tokens.

The draw is Gumbel-max over uniforms from a counter-based hash: the
uniform of (key, row, token id) is a pure function of those integers,
computed with integer ops on whatever device the logits are on.  Inside
a captured CUDA graph the round is a device tensor of the block's feed,
so every replay draws its own round's tokens (a torch ``Generator``
cannot be keyed by the round: its offset advances with every call).
The draws cannot equal JAX's (``jax.random`` is not replayable here);
what holds is the property: same seed, same tokens, for every
interleaving of block sizes.

A keyed sampler may take ``row0``, the batch row of its first logits row
(default 0): a slot-sharded serving engine's rank samples only its own
slots' rows and passes their first global index, so it draws what the
whole-batch engine draws for them.

The hash works on Python ints and on int64 tensors alike (its multipliers
are below 2³¹, so a product of a 32-bit value never leaves int64), which
lets the host and the device derive the same keys.
"""
from __future__ import annotations

from typing import Callable

import torch

MASK = 0xFFFFFFFF
_M1, _M2 = 0x7FEB352D, 0x31848BAB      # odd, below 2**31
_GOLDEN = 0x9E3779B9


def _mix(x):
    """A 32-bit avalanche (xorshift-multiply); ``x`` holds values in
    [0, 2³²) as a Python int or an int64 tensor."""
    x = x ^ (x >> 16)
    x = (x * _M1) & MASK
    x = x ^ (x >> 15)
    x = (x * _M2) & MASK
    return x ^ (x >> 16)


def prng_key(seed: int) -> int:
    """The base key of ``seed`` (a 32-bit value)."""
    return _mix((int(seed) ^ _GOLDEN) & MASK)


def fold_in(key, data):
    """A new key from ``key`` and ``data`` (ints or int64 tensors)."""
    return _mix(key ^ _mix((data + _GOLDEN) & MASK))


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """32 hash bits → float32 u in (0, 1): the top 23 bits plus one half,
    over 2²³, so u is exact and never 0 or 1 (with 24 bits the largest
    value would round to 1.0, and its Gumbel noise to +inf)."""
    return ((bits >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))


def gumbel(key, shape, device, row0: int = 0) -> torch.Tensor:
    """float32 Gumbel noise [B, V] of ``key`` (an int or an int64 tensor
    on ``device``): entry (b, v) is −log(−log(u)) with u the
    :func:`uniform` of the hash of (key, row0 + b, v).  ``row0`` places
    the rows in a larger batch (a slot-sharded engine's rank draws the
    rows of its own slots)."""
    b, v = shape
    rows = torch.arange(row0, row0 + b, device=device,
                        dtype=torch.int64)[:, None]
    cols = torch.arange(v, device=device, dtype=torch.int64)[None, :]
    return -torch.log(-torch.log(uniform(_mix(_mix(fold_in(key, rows)
                                                    ^ cols)))))


def greedy_sampler(logits: torch.Tensor, k: int = 1) -> torch.Tensor:
    """Argmax over the vocab axis → int32 [B] (``k`` is the reference's
    samples-per-row argument; serving always passes 1)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def categorical_sampler(temperature: float = 1.0) -> Callable:
    """Keyed sampling from softmax(logits / temperature): Gumbel-max with
    :func:`gumbel`'s noise, float32, on the logits' device."""
    t = max(float(temperature), 1e-6)

    def sample(logits: torch.Tensor, k: int, key,
               row0: int = 0) -> torch.Tensor:
        lg = logits.float() / t
        return torch.argmax(lg + gumbel(key, lg.shape, lg.device, row0),
                            dim=-1).to(torch.int32)
    sample.takes_key = True
    return sample


def takes_key(sampler) -> bool:
    return bool(getattr(sampler, "takes_key", False))
