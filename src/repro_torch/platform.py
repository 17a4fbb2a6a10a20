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

import functools
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


def host_to_device(arr, device: torch.device,
                   dtype: torch.dtype = torch.long) -> torch.Tensor:
    """A host array as a ``dtype`` tensor on ``device``.  To a CUDA
    device the copy leaves from pinned memory without blocking the host
    (a copy from pageable memory waits for the whole stream: an async
    prefill's dispatch would wait for the prefill stream, and with it
    for the decode work it follows)."""
    t = torch.from_numpy(arr).to(dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def device_name(device: Optional[torch.device] = None) -> str:
    dev = torch.device("cpu") if device is None else torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


@functools.lru_cache(maxsize=None)
def capture_stream(index: int) -> "torch.cuda.Stream":
    """The one side stream of CUDA device ``index`` that every CUDA-graph
    warm-up and capture of the process runs on: each new stream would
    get a cuBLAS workspace of its own, which the process keeps."""
    return torch.cuda.Stream(torch.device("cuda", index))


@functools.lru_cache(maxsize=None)
def prefill_stream(index: int) -> "torch.cuda.Stream":
    """The one side stream of CUDA device ``index`` that async serving
    engines run their prefills on (one per process, for the reason
    :func:`capture_stream` gives; apart from it, so a capture never
    shares a stream with a prefill)."""
    return torch.cuda.Stream(torch.device("cuda", index))
