"""Low-rank activation representation ``U @ core @ Vt`` (+ outlier track).

Counterpart of ``repro.core.lowrank``.  ``core`` is a vector ``[..., k]``
(diagonal, fresh SVD output) or a matrix ``[..., k, k2]`` (after an
input+weight preserved product, paper Eq. 7).

The optional *outlier track* (paper §4) carries the extracted channels
either densely (``o_dense [..., S, C]`` at channel indices
``o_idx [..., C]``) or as a factored full-width pair
(``o_u @ o_core @ o_vt``, what a preserved matmul turns the dense track
into).  ``Vt`` of the base track lives in the original H-wide channel
space with the outlier channels zeroed, so reconstruction is
``U @ core @ Vt + scatter(outlier_track, o_idx)``.

Channel indices are int64 (torch's index type; the JAX package keeps
int32).  A batched ``o_idx [B, C]`` indexes each prompt's own channels.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def _ein(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``einsum`` with JAX's type promotion (bf16 · f32 → f32); torch's
    einsum refuses mixed dtypes."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in ops))


@dataclasses.dataclass(frozen=True)
class LowRank:
    u: torch.Tensor        # [..., S, k]
    core: torch.Tensor     # [..., k] (diag) or [..., k, k2]
    vt: torch.Tensor       # [..., k2, H]
    # ---- outlier track (all None when disabled) ----
    o_idx: Optional[torch.Tensor] = None    # [..., C] int64 channel indices
    o_u: Optional[torch.Tensor] = None      # [..., S, ko]
    o_core: Optional[torch.Tensor] = None   # [..., ko] or [..., ko, ko2]
    o_vt: Optional[torch.Tensor] = None     # [..., ko2, C or N]
    o_dense: Optional[torch.Tensor] = None  # [..., S, C]

    @property
    def rank(self) -> int:
        return self.u.shape[-1]

    @property
    def seq_len(self) -> int:
        return self.u.shape[-2]

    @property
    def hidden(self) -> int:
        return self.vt.shape[-1]

    @property
    def has_outliers(self) -> bool:
        """A second (outlier) track is present: channel-indexed (``o_idx``
        set) or, after a preserved matmul, full-width factored."""
        return (self.o_idx is not None or self.o_u is not None
                or self.o_dense is not None)

    @property
    def core_is_diag(self) -> bool:
        return self.core.dim() == self.u.dim() - 1

    def scaled_u(self) -> torch.Tensor:
        """U @ core folded to the left: [..., S, k2]."""
        if self.core_is_diag:
            return self.u * self.core.unsqueeze(-2)
        return self.u @ self.core

    def outlier_values(self) -> Optional[torch.Tensor]:
        """Dense [..., S, C] (or [..., S, N]) values of the outlier track."""
        if not self.has_outliers:
            return None
        if self.o_dense is not None:
            return self.o_dense
        if self.o_core.dim() == self.o_u.dim() - 1:
            su = self.o_u * self.o_core.unsqueeze(-2)
        else:
            su = _ein("...sk,...kl->...sl", self.o_u, self.o_core)
        return _ein("...sk,...kc->...sc", su, self.o_vt)

    def reconstruct(self) -> torch.Tensor:
        """Materialize the dense [..., S, H] activation."""
        x = self.scaled_u() @ self.vt
        ov = self.outlier_values()
        if ov is not None:
            if self.o_idx is not None:
                x = scatter_channels_add(x, ov, self.o_idx)
            else:                     # full-width second track
                x = x + ov
        return x

    def without_outliers(self) -> "LowRank":
        return LowRank(self.u, self.core, self.vt)

    def astype(self, dtype: torch.dtype) -> "LowRank":
        """Cast every float factor (indices stay integer)."""
        cast = lambda a: None if a is None else a.to(dtype)
        return LowRank(cast(self.u), cast(self.core), cast(self.vt),
                       self.o_idx, cast(self.o_u), cast(self.o_core),
                       cast(self.o_vt), cast(self.o_dense))


def _expand_idx(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched idx [..., C] → [..., S, C] for gather/scatter along H."""
    return idx.unsqueeze(-2).expand(idx.shape[:-1] + (x.shape[-2],)
                                    + idx.shape[-1:])


def scatter_channels_add(x: torch.Tensor, vals: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    """x[..., :, idx[c]] += vals[..., :, c] (batched idx supported)."""
    vals = vals.to(x.dtype)
    if idx.dim() == 1:
        return x.index_add(-1, idx, vals)
    return x.scatter_add(-1, _expand_idx(x, idx), vals)


def gather_channels(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., :, idx] (batched idx supported) → [..., S, C]."""
    if idx.dim() == 1:
        return x[..., idx]
    return torch.gather(x, -1, _expand_idx(x, idx))


def zero_channels(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x with the indexed channels set to zero (batched idx supported)."""
    if idx.dim() == 1:
        return x.index_fill(-1, idx, 0.0)
    return x.scatter(-1, _expand_idx(x, idx), 0.0)


def from_dense_svd(x: torch.Tensor, rank: int) -> LowRank:
    """Direct truncated SVD (LAPACK on the host, cuSOLVER on the card)."""
    u, s, vt = torch.linalg.svd(x, full_matrices=False)
    return LowRank(u[..., :, :rank], s[..., :rank], vt[..., :rank, :])


def relative_error(lr: LowRank, x: torch.Tensor) -> torch.Tensor:
    """‖X − X̂‖_F / ‖X‖_F (paper Eq. 2's ε), per leading index."""
    flat = lambda t: t.reshape(x.shape[:-2] + (-1,))
    num = torch.linalg.vector_norm(flat(lr.reconstruct() - x), dim=-1)
    den = torch.linalg.vector_norm(flat(x), dim=-1)
    return num / torch.clamp(den, min=1e-12)


def retruncate(lr: LowRank, new_rank: int) -> LowRank:
    """Re-compress factors that lost orthogonality (e.g. after a rank
    concatenation) through two thin QRs and one small SVD:
    O(S·k² + H·k²), never O(S·H·min(S, H)).  The outlier track passes
    through unchanged."""
    su = lr.scaled_u()                                   # [..., S, k2]
    qu, ru = torch.linalg.qr(su)                         # S×k2, k2×k2
    qv, rv = torch.linalg.qr(lr.vt.transpose(-1, -2))    # H×k2, k2×k2
    small = ru @ rv.transpose(-1, -2)                    # k2 × k2
    us, ss, vts = torch.linalg.svd(small, full_matrices=False)
    u = qu @ us[..., :, :new_rank]
    vt = vts[..., :new_rank, :] @ qv.transpose(-1, -2)
    return LowRank(u, ss[..., :new_rank], vt, lr.o_idx, lr.o_u, lr.o_core,
                   lr.o_vt, lr.o_dense)


def add_bias_rank(lr: LowRank, bias: torch.Tensor) -> LowRank:
    """Exact ``lr + 1·biasᵀ`` as one extra rank (U gains a ones column, Vᵀ
    the bias row); outlier tracks pass through unchanged."""
    u, core, vt = lr.u, lr.core, lr.vt
    u = torch.cat([u, torch.ones(u.shape[:-1] + (1,), dtype=u.dtype,
                                 device=u.device)], dim=-1)
    brow = bias.to(vt.dtype).expand(vt.shape[:-2] + (1, vt.shape[-1]))
    if lr.core_is_diag:
        core = torch.cat([core, torch.ones(core.shape[:-1] + (1,),
                                           dtype=core.dtype,
                                           device=core.device)], dim=-1)
    else:
        k, k2 = core.shape[-2], core.shape[-1]
        core = torch.nn.functional.pad(core, (0, 1, 0, 1))
        core[..., k, k2] = 1.0
    vt = torch.cat([vt, brow], dim=-2)
    return LowRank(u, core, vt, lr.o_idx, lr.o_u, lr.o_core, lr.o_vt,
                   lr.o_dense)


def rank_concat(a: LowRank, b: LowRank) -> LowRank:
    """Exact sum ``a + b`` as a rank-(ka+kb) LowRank (residual streams).
    Outlier tracks must share channel indices (or be absent on one side);
    they are summed densely when both are present."""
    u = torch.cat([a.scaled_u(), b.scaled_u()], dim=-1)
    vt = torch.cat([a.vt, b.vt], dim=-2)
    core = torch.ones(u.shape[:-2] + (u.shape[-1],), dtype=u.dtype,
                      device=u.device)
    o_idx = a.o_idx if a.o_idx is not None else b.o_idx
    o_dense = None
    if a.has_outliers or b.has_outliers:
        ov_a, ov_b = a.outlier_values(), b.outlier_values()
        if ov_a is not None and ov_b is not None:
            o_dense = ov_a + ov_b
        else:
            o_dense = ov_a if ov_a is not None else ov_b
    return LowRank(u, core, vt, o_idx, o_dense=o_dense)
