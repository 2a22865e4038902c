"""Llama-4-Maverick-400B-A17B [hf:meta-llama]: MoE 128e top-1, shared expert.

MoE layers interleave with dense layers (every=2), as in the released
architecture; this lands the total at ~400B with ~17B active."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048, mlp="swiglu", rope="rope",
    moe=MoEConfig(n_experts=128, top_k=1, d_ff=8192, shared_expert=True,
                  every=2))
