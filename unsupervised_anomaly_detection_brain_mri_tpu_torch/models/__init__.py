"""Models of the port (the parity paths of the JAX zoo)."""
