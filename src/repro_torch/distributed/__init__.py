"""Mesh half of the port (twin of the JAX package's ``distributed``):
logical-axis sharding rules on ``torch.distributed.tensor`` (DTensor)
over a ``DeviceMesh``."""
