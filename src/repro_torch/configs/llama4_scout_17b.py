"""Llama-4-Scout-17B-16E [hf:meta-llama]: MoE 16e top-1, shared expert."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048, mlp="swiglu", rope="rope",
    moe=MoEConfig(n_experts=16, top_k=1, d_ff=8192, shared_expert=True))
