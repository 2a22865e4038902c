"""Launch-layer helpers (twin of the JAX package's ``launch``): so far
``analysis`` (analytic step FLOPs, the policy-sweep summary)."""
