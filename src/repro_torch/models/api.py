"""Family-agnostic model entry points (the serving slice of them).

Counterpart of ``repro.models.api.ModelFns``/``model_fns``: the one place
that maps a config's family to its functions.  Every family's functions
share one signature:

* ``init(cfg, generator, device=None)`` → params;
* ``prefill(params, cfg, tokens, max_len=None)`` → (last logits [B, V],
  cache); the ssm family also takes ``kernels=`` (its scan's kernel set);
* ``decode_step(params, cfg, token, cache, pos)`` → (logits [B, V],
  cache), updating the cache in place;
* ``init_cache(cfg, batch, max_len, device=None)`` → the zero cache of
  ``batch`` slots, every leaf with its slot axis at 1.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from . import mamba2, transformer


class ModelFns(NamedTuple):
    init: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


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
