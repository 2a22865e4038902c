"""Jamba-v0.1-52B [arXiv:2403.19887]: Mamba+attention 1:7, MoE 16e top-2.

Layer schedule per 8-layer period: attention at offset 3, Mamba elsewhere;
MoE MLP every second layer (16 MoE layers over 32).
"""
from .base import ArchConfig, MambaConfig, MoEConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536, mlp="swiglu", rope="none",
    attn_every=8, mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff=14336, every=2))
