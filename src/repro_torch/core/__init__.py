"""Decomposition core: low-rank factors and the batched Lanczos."""
