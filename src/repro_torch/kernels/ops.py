"""Lanczos hook factory and the launch counters of every kernel.

Counterpart of ``repro.kernels.ops.make_batched_pallas_hooks``: the
returned hooks run ONE fused re-orth launch per Lanczos pass for the
whole batch.  There is no backend switch: each wrapper dispatches on the
device of its tensors (plain PyTorch on the host, the CUDA kernel on the
card).  The normalization stays in ``core.lanczos`` (the kernels' ‖z‖²
is dropped here, as in the JAX package).
"""
from __future__ import annotations

import functools
from typing import Dict

from ..core.lanczos import BatchedLanczosHooks
from . import dkv_attention as _dkv, lanczos_reorth as _lr

#: every kernel wrapper of the port, by kernel name
KERNELS = {
    "reorth_right_batched": _lr.reorth_right_batched,
    "reorth_left_batched": _lr.reorth_left_batched,
    "dkv_attention_stats": _dkv.dkv_attention_stats,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


@functools.lru_cache(maxsize=None)
def make_batched_hooks(expansion: int = 32) -> BatchedLanczosHooks:
    """Hooks whose steps are the fused re-orth kernels at ``expansion``
    warps per CTA (cached, so an engine reuses one pair)."""
    def right_step(a, u, v_buf):
        return _lr.reorth_right_batched(a, u, v_buf, expansion=expansion)[0]

    def left_step(a, v, u_buf):
        return _lr.reorth_left_batched(a, v, u_buf, expansion=expansion)[0]

    return BatchedLanczosHooks(right_step=right_step, left_step=left_step)
