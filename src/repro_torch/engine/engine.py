"""DecomposeEngine — the one owner of the decomposition pipeline.

Counterpart of ``repro.engine.DecomposeEngine`` for the serving path:
batched Lanczos through the fused re-orth kernels (``decompose``) and the
KV-cache factorization (``decompose_kv``).  The kernels mask ragged
shapes themselves, so nothing is padded.

The Lanczos start vector comes from ``z0(width)``: by default a seeded
numpy draw (:func:`default_z0`); parity tests hand in the JAX package's
``jax.random.normal(PRNGKey(0))`` value, which torch cannot replay.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core import lanczos as lz
from ..core.lowrank import LowRank, from_dense_svd
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
        self.hooks = ops.make_batched_hooks(self.config.expansion)

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
        return lz.decompose(x, rank, iters, z0=z0, hooks=self.hooks)

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

    def __repr__(self) -> str:
        return (f"DecomposeEngine(expansion={self.config.expansion}, "
                f"kv_rank={self.config.kv_rank})")
