"""Qwen2-VL-2B [arXiv:2409.12191]: VLM backbone with M-RoPE.

The vision frontend is a stub: ``input_specs`` supplies precomputed patch
embeddings and 3-component (t, h, w) M-RoPE position ids.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151936, mlp="swiglu", qkv_bias=True, rope="mrope",
    frontend="vision")
