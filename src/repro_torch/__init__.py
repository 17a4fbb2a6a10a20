"""PyTorch/CUDA port of the D-com system (``repro`` is the JAX reference).

Runs on a CUDA device by default; ``device="cpu"`` runs the same code on
the host with the kernels' plain PyTorch versions.  Imports nothing of
JAX or of the ``repro`` package.
"""
from . import platform  # noqa: F401  (pins float32 matmul numerics)
