"""Device resolution and process-wide numerics for the PyTorch port.

Entry points take an explicit ``device`` and run on ``cuda`` by default.
Without a GPU they raise unless the caller asked for ``device="cpu"``
(what the CPU tests do): a measurement or a serving run that silently
landed on the host would report host numbers under a device's name.

Numerics: the JAX reference computes float32 products in full float32.
PyTorch keeps float32 matmuls exact by default but lets cuDNN use TF32,
and lets cuBLAS reduce bf16 products in reduced precision on split-K
paths.  TF32 keeps ~3 decimal digits, which would break the float32
parity the port is held to (Lanczos re-orthogonalization is sensitive to
it), so all three are pinned here, once, at import.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None``/``"cuda"`` → the current CUDA device (raises without one);
    ``"cpu"`` → the host, only when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the host explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string (``"bfloat16"``, ``"float32"``) → torch dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def device_name(device: Optional[torch.device] = None) -> str:
    dev = torch.device("cpu") if device is None else torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"
