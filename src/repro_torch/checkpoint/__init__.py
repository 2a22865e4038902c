"""Atomic checkpoints (twin of the JAX package's ``checkpoint``)."""
