"""The architecture registry (copied from the JAX package)."""
