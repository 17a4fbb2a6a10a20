"""DecomposeEngine — the one owner of the decomposition pipeline.

Counterpart of ``repro.engine.DecomposeEngine``.  It owns, end to end:

1. **Backend** — ``EngineConfig.backend`` picks the kernel set once, at
   construction (``kernels.ops.make_kernels``): ``"cuda"`` dispatches
   each kernel on its tensors' device, ``"reference"`` runs every
   kernel's plain version.
2. **Batched Lanczos** — ``decompose`` runs the fused re-orth kernels,
   one launch per Lanczos pass for the whole [B, S, H] batch.  The
   kernels mask ragged shapes themselves, so nothing is padded.
3. **Multi-track outliers** — ``decompose_activation`` applies the
   per-layer policy (rank, iters, outlier fraction, threshold) before
   the base-track Lanczos and re-attaches the dense outlier track (§4).
4. **Preserved consumption** — the Eq. 6/7 projections and the factored
   attention contractions (§3.2): ``project``, ``qk_scores``, ``pv``.
5. **KV-cache factorization** — ``decompose_kv`` (serving).

The Lanczos start vector comes from ``z0(width)``: by default a seeded
numpy draw (:func:`default_z0`); parity tests hand in the JAX package's
``jax.random.normal(PRNGKey(0))`` value, which torch cannot replay.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core import lanczos as lz, outlier as ol
from ..core.lowrank import LowRank, add_bias_rank, from_dense_svd
from ..core.policy import LayerPolicy
from ..core.preserved import (decompose_weight, lowrank_matmul,
                              lowrank_x_lowrank_weight, preserved_pv,
                              preserved_qk_scores)
from ..kernels import ops
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
        self.kernels = ops.make_kernels(self.config.backend,
                                        self.config.expansion)

    # -- config passthroughs ---------------------------------------------
    def layer_policy(self, idx: int) -> LayerPolicy:
        return self.config.layer(idx)

    def threshold(self, idx: int) -> float:
        return self.config.threshold(idx)

    @property
    def attn_mode(self) -> str:
        return self.config.attn_mode

    # -- stage 1: batched Lanczos ------------------------------------------
    def start_vector(self, width: int, device: torch.device) -> torch.Tensor:
        key = (width, str(device))
        if key not in self._z0:
            z = np.asarray(self._z0_fn(width), np.float32).reshape(width)
            self._z0[key] = torch.from_numpy(z.copy()).to(device)
        return self._z0[key]

    def decompose(self, x: torch.Tensor, rank: int,
                  iters: Optional[int] = None) -> LowRank:
        """x [..., S, H] → LowRank by one batched Lanczos run."""
        z0 = self.start_vector(x.shape[-1], x.device)
        return lz.decompose(x, rank, iters, z0=z0, hooks=self.kernels.hooks)

    # -- stage 2: policy-driven multi-track activation decomposition -------
    def decompose_activation(self, x: torch.Tensor,
                             layer_idx: Optional[int] = None,
                             lp: Optional[LayerPolicy] = None,
                             threshold: Optional[float] = None) -> LowRank:
        """x [B, S, H] → LowRank with a dense outlier channel track.

        Each prompt decomposes on its own (paper §3.1).  The channel count
        is ``max(1, round(outlier_frac · H))`` (Python's ``round``, as in
        the reference); extraction and Lanczos run on the float32 copy of
        x, and the factors and the outlier values are cast back to
        ``x.dtype`` before any projection (where the reference casts)."""
        if lp is None:
            lp = self.layer_policy(layer_idx)
        if threshold is None:
            threshold = self.threshold(layer_idx)
        num_c = max(1, round(lp.outlier_frac * x.shape[-1])) \
            if lp.outlier_frac > 0 else 0
        x32 = x.to(torch.float32).contiguous()
        if num_c:
            base, vals, idx = ol.extract(x32, threshold, num_c,
                                         self.kernels.outlier_stats)
        else:
            base = x32
        lr = self.decompose(base, lp.rank, iters=lp.effective_iters)
        lr = lr.astype(x.dtype)
        if num_c:
            lr = ol.attach_dense_outliers(lr, vals.to(x.dtype), idx)
        return lr

    # -- KV-cache decomposition (serving) ---------------------------------
    def decompose_kv(self, x: torch.Tensor, rank: int,
                     iters: Optional[int] = None,
                     exact: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, T, kvw] → (U·Σ [B, T, r], Vᵀ [B, r, kvw]) in x's dtype.

        The rank caps at min(T, kvw); ``exact`` runs a direct SVD (the
        near-full-rank regime where floating-point Lanczos loses trailing
        directions, §2.3)."""
        rank = min(rank, *x.shape[-2:])
        x32 = x.to(torch.float32)
        if exact:
            lr = from_dense_svd(x32, rank)
        else:
            iters = iters or min(rank + self.config.kv_iters_extra,
                                 min(x.shape[-2:]))
            lr = self.decompose(x32, rank, iters=iters)
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
        return (f"DecomposeEngine(backend={self.config.backend!r}, "
                f"expansion={self.config.expansion}, "
                f"attn_mode={self.config.attn_mode!r}, "
                f"kv_rank={self.config.kv_rank})")
