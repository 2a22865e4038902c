"""RWKV6-3B "Finch" [arXiv:2404.05892]: attention-free, data-dependent decay.

d_model=2560 -> 40 heads of fixed size 64.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, d_head=64,
    d_ff=8960, vocab=65536, mlp="rwkv_channel_mix", rope="none", rwkv=True)
