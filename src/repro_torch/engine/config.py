"""EngineConfig — the knobs of the decomposition pipeline the port runs.

Counterpart of ``repro.engine.config.EngineConfig`` (the paging,
fused-decode, async and mesh fields arrive with the modules that read
them):

* ``policy``      — per-layer decomposition directives
                    (``core.policy.DecompositionPolicy``, paper §6.2);
                    None means no layer policy (KV-only use, serving).
* ``backend``     — ``"cuda"`` (default): every kernel wrapper dispatches
                    on its tensors' device (the CUDA kernel on the card,
                    the plain version on the host); ``"reference"``: the
                    plain versions of every kernel on whatever device the
                    tensors are (JAX's ``"reference"`` backend), chosen
                    explicitly to hold a run through the kernels against
                    the same run without them.
* ``expansion``   — the paper's compute-expansion factor f.  In the CUDA
                    re-orth kernels it is the number of warps of the CTA
                    that splits each reduction into f partial sums plus a
                    small combine (1..32; 32 fills a 1024-thread block).
* ``attn_mode``   — ``"dense"`` | ``"preserved"`` consumption of the
                    decomposed Q/K/V inputs (paper §3.2).
* ``kv_rank`` / ``kv_tail`` / ``kv_iters_extra`` / ``kv_exact`` — the
                    decomposed-KV knobs (rank 0 disables; ``kv_exact``
                    factorizes by direct SVD).  ``serving.Engine`` reads
                    them from here and nowhere else.
* ``sched_*``     — scheduler knobs: prefill lengths round up to
                    ``sched_bucket``, admission runs every
                    ``sched_admit_every`` decode rounds.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..core.outlier import ThresholdTable
from ..core.policy import DecompositionPolicy, LayerPolicy
from ..kernels.ops import BACKENDS

ATTN_MODES = ("dense", "preserved")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    policy: Optional[DecompositionPolicy] = None
    backend: str = "cuda"
    expansion: int = 32
    attn_mode: str = "dense"
    kv_rank: int = 0
    kv_tail: int = 128
    kv_iters_extra: int = 8
    kv_exact: bool = False
    sched_bucket: int = 16
    sched_admit_every: int = 1

    def __post_init__(self):
        if not isinstance(self.expansion, int) \
                or not 1 <= self.expansion <= 32:
            raise ValueError(f"expansion must be an int in 1..32, "
                             f"got {self.expansion!r}")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {self.backend!r}")
        if self.attn_mode not in ATTN_MODES:
            raise ValueError(f"attn_mode must be one of {ATTN_MODES}, "
                             f"got {self.attn_mode!r}")

    def layer(self, idx: int) -> LayerPolicy:
        if self.policy is None:
            return LayerPolicy(decompose=False)
        return self.policy.layer(idx)

    def threshold(self, idx: int) -> float:
        if self.policy is None:
            return ThresholdTable().default
        return self.policy.thresholds.get(idx)

    def with_policy(self, policy: DecompositionPolicy) -> "EngineConfig":
        return dataclasses.replace(self, policy=policy)
