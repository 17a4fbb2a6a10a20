"""Low-rank activation representation ``U @ core @ Vt``.

Counterpart of ``repro.core.lowrank`` for the serving path: the base
track only (the outlier track arrives with the activation path).
``core`` is a vector ``[..., k]`` (diagonal, fresh SVD output) or a
matrix ``[..., k, k2]``.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LowRank:
    u: torch.Tensor        # [..., S, k]
    core: torch.Tensor     # [..., k] (diag) or [..., k, k2]
    vt: torch.Tensor       # [..., k2, H]

    @property
    def core_is_diag(self) -> bool:
        return self.core.dim() == self.u.dim() - 1

    def scaled_u(self) -> torch.Tensor:
        """U @ core folded to the left: [..., S, k2]."""
        if self.core_is_diag:
            return self.u * self.core.unsqueeze(-2)
        return self.u @ self.core

    def reconstruct(self) -> torch.Tensor:
        return self.scaled_u() @ self.vt


def from_dense_svd(x: torch.Tensor, rank: int) -> LowRank:
    """Direct truncated SVD (LAPACK on the host, cuSOLVER on the card)."""
    u, s, vt = torch.linalg.svd(x, full_matrices=False)
    return LowRank(u[..., :, :rank], s[..., :rank], vt[..., :rank, :])


def retruncate(lr: LowRank, new_rank: int) -> LowRank:
    """Re-compress factors that lost orthogonality (e.g. after a rank
    concatenation) through two thin QRs and one small SVD:
    O(S·k² + H·k²), never O(S·H·min(S, H))."""
    su = lr.scaled_u()                                   # [..., S, k2]
    qu, ru = torch.linalg.qr(su)                         # S×k2, k2×k2
    qv, rv = torch.linalg.qr(lr.vt.transpose(-1, -2))    # H×k2, k2×k2
    small = ru @ rv.transpose(-1, -2)                    # k2 × k2
    us, ss, vts = torch.linalg.svd(small, full_matrices=False)
    u = qu @ us[..., :, :new_rank]
    vt = vts[..., :new_rank, :] @ qv.transpose(-1, -2)
    return LowRank(u, ss[..., :new_rank], vt)
