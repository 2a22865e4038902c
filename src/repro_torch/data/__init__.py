"""Synthetic token pipeline (twin of the JAX package's ``data``)."""
