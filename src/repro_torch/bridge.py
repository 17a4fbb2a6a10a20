"""numpy ↔ torch conversion of parameter trees.

The JAX package's parameters become numpy through ``np.asarray``; their
nested-dict layout (layers stacked on a leading L axis, weights in
``[in, out]``) is kept as it is, so the bridge is a plain copy.

bf16 arrays come out of JAX with the ``ml_dtypes`` ``bfloat16`` dtype,
which numpy cannot hand to ``torch.from_numpy`` and which the GPU
machine does not carry.  They are detected by dtype name and widened to
float32 first; every bf16 value is exactly representable in float32, so
``bf16 → f32 → bf16`` is the identity.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def array_to_tensor(arr, device: torch.device) -> torch.Tensor:
    """``arr`` as a tensor on ``device`` of its shape (a 0-d array stays
    0-d, which ``np.ascontiguousarray`` would make 1-d)."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.require(arr.astype(np.float32),
                                        requirements="C"))
        return t.to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.require(arr, requirements="C")).to(device)


def to_torch(tree: Any, device) -> Any:
    """Nested dict/list/tuple of arrays → same structure of tensors."""
    device = torch.device(device)
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    return array_to_tensor(tree, device)


def to_numpy(tree: Any) -> Any:
    """Tensors → numpy; bf16 comes back as float32 (numpy has no bf16)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
