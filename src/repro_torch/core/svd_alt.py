"""Fig. 2's comparison set: the SVD contenders beside Lanczos.

Counterpart of ``repro.core.svd_alt``, in float32 whatever the input
dtype:

* :func:`oracle_svd` — ``torch.linalg.svd`` truncated, the accuracy
  oracle (the paper's dotted "optimal" line);
* :func:`qr_iteration_svd` — subspace (block power) iteration on AᵀA
  with QR re-orthogonalization, the classical "QR" contender;
* :func:`randomized_svd` — Halko–Martinsson–Tropp range finder with
  power iterations;
* Lanczos is ``core.lanczos.lanczos_svd`` (the paper's choice).

The library calls here (``torch.linalg.qr``/``svd``, matrix products)
are the contenders' own algorithms, not ports of a kernel.  The start
matrices are explicit: ``v0`` [H, rank] and ``omega`` [H, k], or drawn
N(0, 1) from ``generator`` (the reference draws them from
``jax.random.PRNGKey(1)`` and ``PRNGKey(2)``, which torch cannot replay,
so parity tests pass those values in).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .lowrank import LowRank

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _start(given: Optional[torch.Tensor], shape, generator, device
           ) -> torch.Tensor:
    if given is not None:
        if tuple(given.shape) != tuple(shape):
            raise ValueError(f"start matrix of shape {tuple(given.shape)}, "
                             f"expected {tuple(shape)}")
        return given.to(device=device, dtype=torch.float32)
    if generator is None:
        raise ValueError("pass the start matrix or a torch.Generator")
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=torch.float32).to(device)


def oracle_svd(a: torch.Tensor, rank: int) -> Triple:
    """Full SVD, truncated to ``rank``."""
    u, s, vt = torch.linalg.svd(a.float(), full_matrices=False)
    return u[:, :rank], s[:rank], vt[:rank, :]


def qr_iteration_svd(a: torch.Tensor, rank: int, iters: int = 8, *,
                     v0: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None) -> Triple:
    """Subspace iteration V ← qr(Aᵀ(A V)), ``iters`` times from
    qr(``v0``), then the SVD of the small R of qr(A V).  Each iteration is
    two [S, H]·[H, r] products: heavier than a Lanczos step at equal
    rank, which is the paper's point for small r."""
    a32 = a.float()
    v = _start(v0, (a.shape[-1], rank), generator, a.device)
    v, _ = torch.linalg.qr(v)
    for _ in range(iters):
        v, _ = torch.linalg.qr(a32.T @ (a32 @ v))
    u, r_small = torch.linalg.qr(a32 @ v)
    us, s, vts = torch.linalg.svd(r_small)
    return u @ us, s, vts @ v.T


def randomized_svd(a: torch.Tensor, rank: int, oversample: int = 4,
                   power_iters: int = 2, *,
                   omega: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> Triple:
    """Randomized SVD: range of A·omega (k = rank + oversample columns,
    capped at min(S, H)), ``power_iters`` QR-stabilized power
    iterations, then the SVD of QᵀA."""
    a32 = a.float()
    s_dim, h_dim = a.shape
    k = min(rank + oversample, min(s_dim, h_dim))
    q, _ = torch.linalg.qr(a32 @ _start(omega, (h_dim, k), generator,
                                        a.device))
    for _ in range(power_iters):
        z, _ = torch.linalg.qr(a32.T @ q)
        q, _ = torch.linalg.qr(a32 @ z)
    ub, s, vt = torch.linalg.svd(q.T @ a32, full_matrices=False)
    return (q @ ub)[:, :rank], s[:rank], vt[:rank, :]


def as_lowrank(u: torch.Tensor, s: torch.Tensor,
               vt: torch.Tensor) -> LowRank:
    return LowRank(u, s, vt)


def reconstruction_error(a: torch.Tensor, u: torch.Tensor, s: torch.Tensor,
                         vt: torch.Tensor) -> torch.Tensor:
    """Relative Frobenius error of U·diag(s)·Vᵀ against A."""
    a32 = a.float()
    rec = (u * s[None, :]) @ vt
    return (torch.linalg.norm(rec - a32)
            / torch.clamp(torch.linalg.norm(a32), min=1e-12))
