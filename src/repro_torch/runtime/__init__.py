"""Step functions of the port (the decomposed-execution steps)."""
