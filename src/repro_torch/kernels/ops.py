"""Kernel sets of the two backends, and the launch counters of every kernel.

Counterpart of ``repro.kernels.ops`` and the JAX engine's backend
registry.  :func:`make_kernels` gives a :class:`KernelSet` — the Lanczos
hooks (ONE fused re-orth launch per Lanczos pass for the whole batch),
the Eq. 6 GEMM and the outlier statistics — for one of two backends:

* ``"cuda"`` (default): each wrapper dispatches on the device of its
  tensors — the CUDA kernel for CUDA tensors, the plain version for CPU
  tensors;
* ``"reference"``: the plain versions of every kernel, on whatever device
  the tensors are (JAX's ``"reference"`` backend).  Chosen explicitly to
  hold a run through the kernels against the same run without them;
  nothing falls back to it.

The normalization stays in ``core.lanczos`` (the kernels' ‖z‖² is
dropped here, as in the JAX package).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple

from ..core.lanczos import BatchedLanczosHooks
from . import dkv_attention as _dkv, lanczos_reorth as _lr
from . import lowrank_matmul as _lrmm, outlier_extract as _ol

BACKENDS = ("cuda", "reference")

#: every kernel wrapper of the port, by kernel name
KERNELS = {
    "reorth_right_batched": _lr.reorth_right_batched,
    "reorth_left_batched": _lr.reorth_left_batched,
    "dkv_attention_stats": _dkv.dkv_attention_stats,
    "lowrank_matmul": _lrmm.lowrank_matmul,
    "outlier_stats": _ol.outlier_stats,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


class KernelSet(NamedTuple):
    hooks: BatchedLanczosHooks
    lowrank_matmul: Callable      # (vt [..., k, H], w [H, N]) -> [..., k, N]
    outlier_stats: Callable       # (x [..., S, H], T) -> (counts, maxabs)


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")


@functools.lru_cache(maxsize=None)
def make_batched_hooks(expansion: int = 32,
                       backend: str = "cuda") -> BatchedLanczosHooks:
    """Hooks whose steps are the fused re-orth kernels at ``expansion``
    warps per CTA, or their plain versions under ``"reference"`` (cached,
    so an engine reuses one pair)."""
    _check_backend(backend)
    if backend == "reference":
        return BatchedLanczosHooks(
            right_step=lambda a, u, v: _lr.reorth_right_batched_plain(
                a, u, v)[0],
            left_step=lambda a, v, u: _lr.reorth_left_batched_plain(
                a, v, u)[0])

    def right_step(a, u, v_buf):
        return _lr.reorth_right_batched(a, u, v_buf, expansion=expansion)[0]

    def left_step(a, v, u_buf):
        return _lr.reorth_left_batched(a, v, u_buf, expansion=expansion)[0]

    return BatchedLanczosHooks(right_step=right_step, left_step=left_step)


@functools.lru_cache(maxsize=None)
def make_kernels(backend: str = "cuda", expansion: int = 32) -> KernelSet:
    """Every kernel of the activation path for ``backend``."""
    _check_backend(backend)
    hooks = make_batched_hooks(expansion, backend)
    if backend == "reference":
        return KernelSet(hooks, _lrmm.lowrank_matmul_plain,
                         _ol.outlier_stats_plain)
    return KernelSet(hooks, _lrmm.lowrank_matmul, _ol.outlier_stats)
