"""KV-cache and attention geometries of the models the port runs
(``qwen1_5_0_5b``, ``qwen2_5_14b``)."""
from .qwen1_5_0_5b import KV, REDUCED, KVGeometry

__all__ = ["KV", "REDUCED", "KVGeometry"]
