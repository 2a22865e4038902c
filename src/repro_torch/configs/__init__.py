"""KV-cache geometries of the models the port serves."""
from .qwen1_5_0_5b import KV, REDUCED, KVGeometry

__all__ = ["KV", "REDUCED", "KVGeometry"]
