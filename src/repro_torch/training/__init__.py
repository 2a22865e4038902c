"""Optimizer and train step (twin of the JAX package's ``training``)."""
