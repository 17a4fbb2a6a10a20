"""The plain reference the benchmark holds the port against.

Plain PyTorch in float32 (TF32 off), written from the published
equations and the port's documented semantics, importing nothing of the
port and nothing of JAX.  It works out every decomposition again from
the inputs the benchmark hands to both sides (token ids and the weights
the benchmark drew): the outlier channels, the Lanczos factors, the KV
factors and their folds.

``precision.Cast`` puts every matrix product's operands through one
rounding: none for the reference, float8 (e4m3, one scale per tensor)
for the control that stands for a precision below the configuration's
bf16.
"""
