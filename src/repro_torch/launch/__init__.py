"""Launch layer (twin of the JAX package's ``launch``): ``analysis``
(analytic step FLOPs, the collective parser, the policy-sweep summary),
``mesh`` (the production and host meshes), ``train`` (the training
launcher) and ``dryrun`` (one rank's step of every cell on a fake
process group)."""
