"""Family-agnostic model entry points (the serving slice of them).

Counterpart of ``repro.models.api.ModelFns``/``model_fns``: the one place
that maps a config's family to its functions.  Every family's functions
share one signature:

* ``init(cfg, generator, device=None)`` → params;
* ``prefill(params, cfg, tokens, max_len=None)`` → (last logits [B, V],
  cache); the ssm family also takes ``kernels=`` (its scan's kernel set);
* ``decode_step(params, cfg, token, cache, pos, live=None)`` → (logits
  [B, V], cache), updating the cache in place (a row whose ``live`` is
  False writes nothing);
* ``init_cache(cfg, batch, max_len, device=None)`` → the zero cache of
  ``batch`` slots, every leaf with its slot axis at 1.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import mamba2, transformer


class ModelFns(NamedTuple):
    init: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def run_decode_block(step: Callable, max_block: int, tok: torch.Tensor,
                     cache, pos: torch.Tensor, n_steps, stop_table):
    """Up to ``n_steps`` (≤ ``max_block``) greedy decode steps as ONE
    fixed-length loop over device tensors, with no host read inside — the
    form a CUDA graph captures (counterpart of
    ``repro.models.api.run_decode_block``, whose ``while_loop`` exits).

    ``step(tok, cache, pos, live)`` → (logits, cache) is one decode step
    that writes nothing for a row whose ``live`` (bool [B]) is False.
    ``n_steps`` is an int or an int tensor; ``stop_table`` is int32
    [B, W], −1-padded.  Sampling is greedy, on the device.  The block
    halts after the first step in which any slot samples one of its stop
    tokens, or after ``n_steps``: every later iteration still runs, but
    with ``live`` all False and ``tok``/``pos`` frozen, so it changes no
    state.

    Returns ``(buf int32 [max_block, B], steps int32 [], done bool [B],
    cache)`` as the reference does: rows of ``buf`` at or past ``steps``
    are zero, and ``done`` is the stop mask of the last step taken.
    """
    b, dev = tok.shape[0], tok.device
    n = torch.as_tensor(n_steps, device=dev)
    buf = torch.zeros(max_block, b, dtype=torch.int32, device=dev)
    steps = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    halted = torch.zeros((), dtype=torch.bool, device=dev)
    for i in range(max_block):
        active = ~halted & (n > i)                       # bool []
        logits, cache = step(tok, cache, pos, active.expand(b))
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        buf[i] = torch.where(active, nxt, 0)
        hit = (nxt[:, None] == stop_table).any(dim=1)
        done = torch.where(active, hit, done)
        halted = halted | (active & hit.any())
        steps = steps + active.to(torch.int32)
        tok = torch.where(active, nxt.to(tok.dtype), tok)
        pos = pos + active.to(pos.dtype)
    return buf, steps, done, cache


_FAMILY = {
    "dense": ModelFns(transformer.init, transformer.prefill,
                      transformer.decode_step, transformer.init_cache),
    "ssm": ModelFns(mamba2.init, mamba2.prefill, mamba2.decode_step,
                    mamba2.init_state),
}


def model_fns(cfg) -> ModelFns:
    try:
        return _FAMILY[cfg.family]
    except KeyError:
        raise ValueError(f"family {cfg.family!r} is not ported; ported: "
                         f"{sorted(_FAMILY)}") from None
