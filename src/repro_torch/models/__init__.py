"""Models of the port: every family of the reference (dense and its
variants, ssm, moe, hybrid, vlm, audio), the decomposed KV cache and the
decomposed (activation) forward; ``api.model_fns`` maps a config to its
family's functions."""
