"""EngineConfig — the knobs of the decomposition pipeline the port runs.

Counterpart of ``repro.engine.config.EngineConfig`` for decomposed-KV
serving (the policy, backend, paging, fused-decode, async and mesh
fields arrive with the modules that read them):

* ``expansion``   — the paper's compute-expansion factor f.  In the CUDA
                    re-orth kernels it is the number of warps of the CTA
                    that splits each reduction into f partial sums plus a
                    small combine (1..32; 32 fills a 1024-thread block).
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


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    expansion: int = 32
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
