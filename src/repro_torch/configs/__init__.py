"""Architecture registry: ``get_config(arch_id)`` + the shape table (twin
of the JAX package's ``configs``), and the KV-cache geometry of
Qwen1.5-0.5B that the tiered paged-KV server runs (``KV``, ``REDUCED``,
``KVGeometry``)."""
from .base import (ArchConfig, MambaConfig, MoEConfig, ShapeConfig, SHAPES,
                   cell_is_valid, reduced)

from . import (nemotron_4_340b, deepseek_coder_33b, qwen2_5_14b,
               qwen1_5_0_5b, llama4_maverick_400b, llama4_scout_17b,
               qwen2_vl_2b, hubert_xlarge, jamba_v0_1_52b, rwkv6_3b)
from .qwen1_5_0_5b import KV, REDUCED, KVGeometry

_MODULES = (nemotron_4_340b, deepseek_coder_33b, qwen2_5_14b, qwen1_5_0_5b,
            llama4_maverick_400b, llama4_scout_17b, qwen2_vl_2b,
            hubert_xlarge, jamba_v0_1_52b, rwkv6_3b)

REGISTRY = {m.CONFIG.name: m.CONFIG for m in _MODULES}
ARCH_IDS = tuple(REGISTRY)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


__all__ = ["ArchConfig", "MambaConfig", "MoEConfig", "ShapeConfig", "SHAPES",
           "REGISTRY", "ARCH_IDS", "get_config", "cell_is_valid", "reduced",
           "KV", "REDUCED", "KVGeometry"]
