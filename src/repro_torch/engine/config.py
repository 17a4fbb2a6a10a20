"""EngineConfig — the knobs of the decomposition pipeline the port runs.

Counterpart of ``repro.engine.config.EngineConfig``:

* ``policy``      — per-layer decomposition directives
                    (``core.policy.DecompositionPolicy``, paper §6.2);
                    None means no layer policy (KV-only use, serving).
* ``backend``     — ``"cuda"`` (default): every kernel wrapper dispatches
                    on its tensors' device (the CUDA kernel on the card,
                    the plain version on the host); ``"reference"``: the
                    plain versions of every kernel on whatever device the
                    tensors are (JAX's ``"reference"`` backend), chosen
                    explicitly to hold a run through the kernels against
                    the same run without them; ``"auto"``: resolved once,
                    when the DecomposeEngine is built, by
                    ``repro_torch.tune.resolve_backend``.  Any name of
                    ``engine.backends.available_backends()`` is accepted.
* ``expansion``   — the paper's compute-expansion factor f (1..32): in
                    the re-orth kernels, as in the JAX package, the number
                    of blocks along the output axis, each reducing its
                    part plus a small combine; on the card one batch
                    element is a cluster of min(f, 16) CTAs.  The default
                    16 is the fastest f at B = 1 [4096, 4096] (the
                    decomposed forward) and near the best at B = 32
                    [32, 512, 4096] (PERF.md's measured curves; the best
                    there is smaller).  ``"auto"``: resolved per shape
                    bucket through
                    ``repro_torch.tune`` (the ``lanczos_reorth`` space,
                    the engine's backend pinned).
* ``attn_mode``   — ``"dense"`` | ``"preserved"`` consumption of the
                    decomposed Q/K/V inputs (paper §3.2).
* ``kv_rank`` / ``kv_tail`` / ``kv_iters_extra`` / ``kv_exact`` — the
                    decomposed-KV knobs (rank 0 disables; ``kv_exact``
                    factorizes by direct SVD).  ``serving.Engine`` reads
                    them from here and nowhere else.
* ``kv_page`` / ``kv_pool_pages`` / ``kv_prefix_cache`` — paged-cache
                    geometry (``serving.Engine(paged=True)``): rows per
                    page, total pool pages (0 = sized from slots ×
                    max_len with fold headroom), and the prefix-cache
                    entry capacity (0 = no prefix reuse).
* ``sched_*``     — scheduler knobs: prefill lengths round up to
                    ``sched_bucket``, admission runs every
                    ``sched_admit_every`` decode rounds, and one
                    admission batch takes at most ``sched_max_admit``
                    requests (0 = as many as there are free slots).
* ``decode_block`` — fused decode steps per launch (serving): 1
                    (default) decodes one token per dispatch; N > 1 runs
                    up to N steps as one fixed-length loop, replayed as a
                    captured CUDA graph on the card (token-exact: the
                    engine caps each block at the next fold, budget or
                    admission round, and a stop token halts it);
                    ``"auto"`` picks N through ``repro_torch.tune``.
* ``prefill_async`` — serving admission dispatches each prefill as a
                    ticket (on the card: on a side stream, with an event
                    as its done-probe) and splices it at a decode
                    boundary (``serving.Engine(prefill_async=,
                    ready_order=)``; the engine's argument wins).
* ``mesh``        — optional ``torch.distributed.device_mesh.DeviceMesh``
                    with axes ("data", "model") or ("pod", "data",
                    "model") (``launch.mesh``): the decomposition shards
                    its flat batch over the DP super-axis
                    (``DecomposeEngine.decompose``) and a serving engine
                    shards its slots over it (``serving.Engine``); a
                    "model" axis larger than 1 runs the model
                    tensor-parallel on it (:func:`tp_mesh`).  The
                    activation-decomposition forward runs on a mesh
                    through its step builders
                    (``runtime.steps.make_decomposed_forward_step(
                    mesh=)``, ``models.api.decomposed_fns(mesh=)``),
                    which split the batch themselves.
                    None (default) is the single-device path, unchanged;
                    a mesh changes no value and no token.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

from ..core.outlier import ThresholdTable
from ..core.policy import DecompositionPolicy, LayerPolicy
from ..kernels.lanczos_reorth import DEFAULT_EXPANSION
from .backends import available_backends

ATTN_MODES = ("dense", "preserved")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    policy: Optional[DecompositionPolicy] = None
    backend: str = "cuda"
    expansion: Union[int, str] = DEFAULT_EXPANSION   # blocks, or "auto"
    attn_mode: str = "dense"
    kv_rank: int = 0
    kv_tail: int = 128
    kv_iters_extra: int = 8
    kv_exact: bool = False
    kv_page: int = 16                   # rows per page (paged serving)
    kv_pool_pages: int = 0              # page-pool size (0 = auto-sized)
    kv_prefix_cache: int = 0            # prefix-cache entries (0 = off)
    sched_bucket: int = 16
    sched_admit_every: int = 1
    sched_max_admit: int = 0
    decode_block: Union[int, str] = 1   # fused decode steps, or "auto"
    prefill_async: bool = False         # ticketed admission (serving)
    mesh: Optional[Any] = None          # torch DeviceMesh (hashable)

    def __post_init__(self):
        if self.expansion != "auto" and (
                not isinstance(self.expansion, int)
                or isinstance(self.expansion, bool)
                or not 1 <= self.expansion <= 32):
            raise ValueError(f"expansion must be an int in 1..32 or "
                             f"'auto', got {self.expansion!r}")
        if self.decode_block != "auto" and (
                not isinstance(self.decode_block, int)
                or isinstance(self.decode_block, bool)
                or self.decode_block < 1):
            raise ValueError(f"decode_block must be a positive int or "
                             f"'auto', got {self.decode_block!r}")
        if not isinstance(self.prefill_async, bool):
            raise ValueError(f"prefill_async must be a bool, got "
                             f"{self.prefill_async!r}")
        if self.backend != "auto" \
                and self.backend not in available_backends():
            raise ValueError(f"backend must be 'auto' or one of "
                             f"{available_backends()}, got "
                             f"{self.backend!r}")
        if self.mesh is not None and "data" not in (
                getattr(self.mesh, "mesh_dim_names", None) or ()):
            raise ValueError(f"mesh must be a DeviceMesh with a 'data' "
                             f"axis (launch.mesh), got {self.mesh!r}")
        if self.attn_mode not in ATTN_MODES:
            raise ValueError(f"attn_mode must be one of {ATTN_MODES}, "
                             f"got {self.attn_mode!r}")

    @property
    def tp_mesh(self):
        """The mesh whose "model" axis the model runs on, or None."""
        return tp_mesh(self.mesh)

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


def tp_mesh(mesh):
    """``mesh`` when the model runs tensor-parallel on it (Megatron TP,
    each rank its ``params_sharding`` blocks: a "model" axis larger
    than 1), else None."""
    if mesh is None:
        return None
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    size = mesh.mesh.shape[names.index("model")] if "model" in names else 1
    return mesh if size > 1 else None
