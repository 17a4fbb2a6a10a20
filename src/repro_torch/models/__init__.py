"""Models of the port: the dense transformer and its decomposed KV cache."""
