"""DecomposeEngine — the one owner of the decomposition pipeline.

Counterpart of ``repro.engine.DecomposeEngine``.  It owns, end to end:

1. **Backend** — ``EngineConfig.backend`` picks the kernel set once, at
   construction (``engine.backends``): ``"cuda"`` dispatches each kernel
   on its tensors' device, ``"reference"`` runs every kernel's plain
   version, ``"auto"`` resolves to one of them through
   ``repro_torch.tune.resolve_backend`` (:attr:`resolved_backend`).
   With ``expansion="auto"`` the re-orth kernels' f resolves per shape
   bucket (``resolve_expansion``), and the decomposition takes the
   (cached) kernel set at that f.
2. **Batched Lanczos** — ``decompose`` runs the fused re-orth kernels,
   one launch per Lanczos pass for the whole [B, S, H] batch.  The
   kernels mask ragged shapes themselves, so nothing is padded.
3. **Multi-track outliers** — ``decompose_activation`` applies the
   per-layer policy (rank, iters, outlier fraction, threshold) before
   the base-track Lanczos and re-attaches the dense outlier track (§4).
4. **Preserved consumption** — the Eq. 6/7 projections and the factored
   attention contractions (§3.2): ``project``, ``qk_scores``, ``pv``.
5. **KV-cache factorization** — ``decompose_kv`` (serving).

Telemetry (host-side, in ``obs.GLOBAL``, names and labels as in the
reference): ``decompose_total{bucket, backend, f, path}`` counts every
batched Lanczos run (``path`` ``"sharded"`` under a mesh, else
``"local"``) and ``decompose_kv_total{mode, bucket}`` every KV-cache
factorization.

With ``EngineConfig.mesh`` set, ``decompose`` runs
:meth:`DecomposeEngine._decompose_sharded`, the counterpart of the
reference's shard_map lowering: every rank holds the whole input, the
flat batch splits into contiguous blocks over the DP super-axis when it
divides (else every rank decomposes all of it: replication, as the
reference falls back), each rank runs its block through its own kernels
with the same start vector, and one all-gather per factor rebuilds the
result on every rank.  The all-gathers run on the current stream's
order (``torch.distributed`` makes NCCL's stream wait for the current
stream and the current stream for the result), so a decomposition on an
async engine's prefill stream stays ordered on that stream.

The Lanczos start vector comes from ``z0(width)``: by default a seeded
numpy draw (:func:`default_z0`); parity tests hand in the JAX package's
``jax.random.normal(PRNGKey(0))`` value, which torch cannot replay.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core import lanczos as lz, outlier as ol
from ..core.lowrank import LowRank, add_bias_rank, from_dense_svd
from ..core.policy import LayerPolicy
from ..core.preserved import (decompose_weight, lowrank_matmul,
                              lowrank_x_lowrank_weight, preserved_pv,
                              preserved_qk_scores)
from ..obs import GLOBAL as _OBS, bucket_label
from .backends import Backend, get_backend
from .config import EngineConfig

Z0Fn = Callable[[int], np.ndarray]


@functools.lru_cache(maxsize=None)
def default_z0(width: int) -> np.ndarray:
    """The port's fixed start direction of a given width."""
    return np.random.RandomState(0).standard_normal(width).astype(np.float32)


class DecomposeEngine:
    def __init__(self, config: Optional[EngineConfig] = None,
                 z0: Optional[Z0Fn] = None):
        self.config = config or EngineConfig()
        self._z0_fn = z0 or default_z0
        self._z0: Dict[Tuple[int, str], torch.Tensor] = {}
        name = self.config.backend
        if name == "auto":
            from .. import tune
            name = tune.resolve_backend()
        self.backend: Backend = get_backend(name)
        self._auto_expansion = self.config.expansion == "auto"
        # with "auto", the set for the f-independent kernels; the Lanczos
        # hooks come from decompose() at the resolved f
        self.kernels = self.backend.make_kernels(
            EngineConfig().expansion if self._auto_expansion
            else self.config.expansion)

    # -- config passthroughs ---------------------------------------------
    def layer_policy(self, idx: int) -> LayerPolicy:
        return self.config.layer(idx)

    def threshold(self, idx: int) -> float:
        return self.config.threshold(idx)

    @property
    def attn_mode(self) -> str:
        return self.config.attn_mode

    @property
    def resolved_backend(self) -> str:
        """The registry key in use (``"auto"`` resolved)."""
        return self.backend.name

    def resolve_expansion(self, s_dim: int, h_dim: int, batch: int = 1,
                          dtype: object = "float32",
                          device: object = "cuda") -> int:
        """The f this engine runs a [batch, S, H] decomposition at on
        ``device``: the configured int, or — for ``"auto"`` — the
        ``repro_torch.tune`` answer for this shape bucket with the
        engine's backend pinned (cache hit or cost model, behind an
        in-process lru, so the per-layer path is a dict lookup)."""
        if not self._auto_expansion:
            return self.config.expansion
        from .. import tune
        return tune.tuned_expansion((int(batch), int(s_dim), int(h_dim)),
                                    dtype=str(dtype),
                                    backend=self.backend.name,
                                    device=device)

    # -- stage 1: batched Lanczos ------------------------------------------
    def start_vector(self, width: int, device: torch.device) -> torch.Tensor:
        key = (width, str(device))
        if key not in self._z0:
            z = np.asarray(self._z0_fn(width), np.float32).reshape(width)
            self._z0[key] = torch.from_numpy(z.copy()).to(device)
        return self._z0[key]

    def decompose(self, x: torch.Tensor, rank: int,
                  iters: Optional[int] = None,
                  local: bool = False) -> LowRank:
        """x [..., S, H] → LowRank by one batched Lanczos run (``local``:
        on this rank's ``x`` alone, whatever ``config.mesh`` says — a
        caller that has already distributed the batch itself)."""
        from ..distributed import sharding as sh
        batch = max(1, math.prod(int(d) for d in x.shape[:-2]))
        mesh = None if local else self.config.mesh
        f = self.resolve_expansion(x.shape[-2], x.shape[-1], batch, x.dtype,
                                   x.device)
        if mesh is not None and self._auto_expansion:
            f = sh.broadcast_int(f, sh.dp_group(mesh), x.device,
                                 "expansion")
        _OBS.counter(
            "decompose_total", "batched Lanczos decompositions",
            bucket=bucket_label(batch, *x.shape[-2:]),
            backend=self.backend.name, f=str(f),
            path="local" if mesh is None else "sharded").inc()
        z0 = self.start_vector(x.shape[-1], x.device)
        hooks = self.backend.make_kernels(f).hooks
        if mesh is not None:
            return self._decompose_sharded(x, rank, iters, z0, hooks)
        return lz.decompose(x, rank, iters, z0=z0, hooks=hooks)

    def _decompose_sharded(self, x: torch.Tensor, rank: int,
                           iters: Optional[int], z0: torch.Tensor,
                           hooks) -> LowRank:
        """The batched Lanczos run DP-sharded over ``config.mesh``: the
        flat [B, S, H] batch splits into B / dp contiguous blocks when dp
        divides B (the divisibility guard of every rule in
        ``distributed.sharding``), rank i decomposing block i, and the
        factors are all-gathered over the DP group; otherwise every rank
        decomposes the whole batch.  Per element the arithmetic is the
        unsharded call's: at one rank the factors are bit-identical."""
        from ..distributed import sharding as sh
        mesh = self.config.mesh
        batch_shape = x.shape[:-2]
        flat = x.reshape((-1,) + tuple(x.shape[-2:]))
        b, dp = flat.shape[0], sh.dp_size(mesh)
        if b % dp or b == 0:
            return lz.decompose(x, rank, iters, z0=z0, hooks=hooks)
        n = b // dp
        i = sh.dp_rank(mesh)
        part = lz.decompose(flat[i * n:(i + 1) * n], rank, iters, z0=z0,
                            hooks=hooks)
        group = sh.dp_group(mesh)

        def gather(t: torch.Tensor) -> torch.Tensor:
            out = t.new_empty((b,) + tuple(t.shape[1:]))
            sh.all_gather_into(out, t.contiguous(), group, "factors")
            return out.reshape(batch_shape + tuple(t.shape[1:]))
        return LowRank(gather(part.u), gather(part.core), gather(part.vt))

    # -- stage 2: policy-driven multi-track activation decomposition -------
    def decompose_activation(self, x: torch.Tensor,
                             layer_idx: Optional[int] = None,
                             lp: Optional[LayerPolicy] = None,
                             threshold: Optional[float] = None,
                             local: bool = False) -> LowRank:
        """x [B, S, H] → LowRank with a dense outlier channel track
        (``local``: x is this rank's block of a batch its caller split
        over DP, decomposed alone, as :meth:`decompose`'s).

        Each prompt decomposes on its own (paper §3.1).  The channel count
        is ``max(1, round(outlier_frac · H))`` (Python's ``round``, as in
        the reference).  The channel statistics read x in its own dtype
        where the kernel takes it (float32 or bf16: |x| is exact in float32
        either way, so the selection is that of the float32 copy); the
        split and Lanczos run on the float32 copy of x, and the factors and
        the outlier values are cast back to ``x.dtype`` before any
        projection (where the reference casts)."""
        if lp is None:
            lp = self.layer_policy(layer_idx)
        if threshold is None:
            threshold = self.threshold(layer_idx)
        num_c = max(1, round(lp.outlier_frac * x.shape[-1])) \
            if lp.outlier_frac > 0 else 0
        if num_c:           # before the float32 copy evicts x from the L2
            sx = x if x.dtype == torch.bfloat16 else x.float()
            idx = ol.select_outlier_channels(sx.contiguous(), threshold,
                                             num_c, self.kernels.outlier_stats)
        x32 = x.to(torch.float32).contiguous()
        if num_c:
            base, vals = ol.split_outliers(x32, idx)
        else:
            base = x32
        lr = self.decompose(base, lp.rank, iters=lp.effective_iters,
                            local=local)
        lr = lr.astype(x.dtype)
        if num_c:
            lr = ol.attach_dense_outliers(lr, vals.to(x.dtype), idx)
        return lr

    # -- KV-cache decomposition (serving) ---------------------------------
    def decompose_kv(self, x: torch.Tensor, rank: int,
                     iters: Optional[int] = None,
                     exact: bool = False, local: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, T, kvw] → (U·Σ [B, T, r], Vᵀ [B, r, kvw]) in x's dtype.

        The rank caps at min(T, kvw); ``exact`` runs a direct SVD (the
        near-full-rank regime where floating-point Lanczos loses trailing
        directions, §2.3); ``local`` as :meth:`decompose`."""
        rank = min(rank, *x.shape[-2:])
        _OBS.counter("decompose_kv_total", "KV-cache factorizations",
                     mode="exact" if exact else "lanczos",
                     bucket=bucket_label(*x.shape[-2:])).inc()
        x32 = x.to(torch.float32)
        if exact:
            lr = from_dense_svd(x32, rank)
        else:
            iters = iters or min(rank + self.config.kv_iters_extra,
                                 min(x.shape[-2:]))
            lr = self.decompose(x32, rank, iters=iters, local=local)
        return lr.scaled_u().to(x.dtype), lr.vt.to(x.dtype)

    # -- stage 3: preserved-form consumption (paper §3.2) -----------------
    def project(self, lr: LowRank, wp, wfac: Optional[LowRank] = None
                ) -> LowRank:
        """Preserved matmul through a layer's weight dict ``{"w": …[, "b"]}``;
        the Eq. 7 input+weight chain when an offline weight factor is
        supplied."""
        mm = self.kernels.lowrank_matmul
        if wfac is not None:
            y = lowrank_x_lowrank_weight(lr, wfac, matmul=mm)
            if "b" in wp:
                y = add_bias_rank(y, wp["b"])   # exact rank-1 bias fold
            return y
        return lowrank_matmul(lr, wp["w"], bias=wp.get("b"), matmul=mm)

    def qk_scores(self, q: LowRank, k: LowRank, num_heads: int, scale: float,
                  num_kv_heads: Optional[int] = None) -> torch.Tensor:
        return preserved_qk_scores(q, k, num_heads, scale, num_kv_heads)

    def pv(self, p: torch.Tensor, v: LowRank, num_heads: int,
           num_kv_heads: Optional[int] = None) -> torch.Tensor:
        return preserved_pv(p, v, num_heads, num_kv_heads)

    def decompose_weight(self, w: torch.Tensor, rank: int) -> LowRank:
        """Offline weight factorization (Table 3 mode) — exact SVD."""
        return decompose_weight(w, rank)

    def __repr__(self) -> str:
        return (f"DecomposeEngine(backend={self.backend.name!r}, "
                f"expansion={self.config.expansion}, "
                f"attn_mode={self.config.attn_mode!r}, "
                f"kv_rank={self.config.kv_rank})")
