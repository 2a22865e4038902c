"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B]: small dense, QKV bias, tied
embeddings (config.json: num_hidden_layers 24, hidden_size 1024,
num_attention_heads 16, num_key_value_heads 16, intermediate_size 2816,
vocab_size 151936).

``CONFIG`` is the architecture; ``KV`` / ``REDUCED`` are its KV-cache
geometry at full width and at ``reduced()``'s width, which the tiered
paged-KV server (``serving/``) runs.  A KV group is one layer
(``examples/serve_tiered.py`` maps groups to layers).
"""
from __future__ import annotations

import dataclasses

import torch

from .base import ArchConfig, reduced

CONFIG = ArchConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab=151936, mlp="swiglu", qkv_bias=True, rope="rope",
    tie_embeddings=True)

N_LAYERS = CONFIG.n_layers
N_HEADS = CONFIG.n_heads
N_KV_HEADS = CONFIG.n_kv_heads
HEAD_DIM = CONFIG.head_dim


@dataclasses.dataclass(frozen=True)
class KVGeometry:
    n_groups: int
    kv_heads: int
    head_dim: int
    block_size: int = 16
    dtype: torch.dtype = torch.bfloat16


# full width: 24 * 16 * 16 * 64 * 2 B = 786,432 B per block and pool
KV = KVGeometry(N_LAYERS, N_KV_HEADS, HEAD_DIM)
# the width of ``configs.reduced`` (4 layers, 2 KV heads, d_head 32), for
# CPU tests
_r = reduced(CONFIG)
REDUCED = KVGeometry(_r.n_layers, _r.n_kv_heads, _r.head_dim)
