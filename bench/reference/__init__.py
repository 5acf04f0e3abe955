"""The plain reference: float32 PyTorch, TF32 off, written from the
configuration file alone.  It imports nothing of the program, of JAX or of
the JAX package."""
