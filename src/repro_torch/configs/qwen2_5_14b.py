"""Qwen2.5-14B [hf:Qwen/Qwen2.5-14B]: dense GQA with QKV bias
(config.json: num_hidden_layers 48, hidden_size 5120, num_attention_heads
40, num_key_value_heads 8).

It is also the grouped-query width of the port's paged attention: 5 query
heads read each KV head (``N_*`` below).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=13824, vocab=152064, mlp="swiglu", qkv_bias=True, rope="rope")

N_LAYERS = CONFIG.n_layers
N_HEADS = CONFIG.n_heads
N_KV_HEADS = CONFIG.n_kv_heads
HEAD_DIM = CONFIG.head_dim
