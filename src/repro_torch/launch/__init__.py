"""Launch layer (twin of the JAX package's ``launch``): ``analysis``
(analytic step FLOPs, the policy-sweep summary) and ``train`` (the
training launcher); the mesh and the dry run wait for the distributed
slice."""
