"""The precision a reference computes its matrix products in."""
from __future__ import annotations

import torch

FP8_MAX = 448.0            # largest finite float8 e4m3fn


class Cast:
    """``mm(a, b)``: a @ b in float32 after rounding both operands;
    ``fp8=True`` rounds each to float8 e4m3 with one scale per tensor
    (its largest magnitude mapped to 448), else leaves them float32."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def round(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.fp8:
            return x
        amax = x.abs().amax().clamp(min=1e-30)
        scale = FP8_MAX / amax
        return (x * scale).to(torch.float8_e4m3fn).float() / scale

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.round(a) @ self.round(b)


def no_tf32() -> None:
    """float32 products in float32 (TF32 off) for the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
