"""The plain reference the benchmark holds the port to: float32 PyTorch of
the same models, samplers and training step, importing nothing of the
port, of JAX or of the JAX package."""
