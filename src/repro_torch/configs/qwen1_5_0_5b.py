"""Qwen1.5-0.5B's KV-cache geometry [hf:Qwen/Qwen1.5-0.5B, config.json:
num_hidden_layers 24, hidden_size 1024, num_attention_heads 16,
num_key_value_heads 16].

The JAX package's ``configs/qwen1_5_0_5b.py`` holds the same numbers; the
port keeps its own copy because ``repro.configs`` imports JAX.  A KV group
is one layer (``examples/serve_tiered.py`` maps groups to layers).
"""
from __future__ import annotations

import dataclasses

import torch

N_LAYERS = 24
N_HEADS = 16
N_KV_HEADS = 16
HEAD_DIM = 1024 // 16


@dataclasses.dataclass(frozen=True)
class KVGeometry:
    n_groups: int
    kv_heads: int
    head_dim: int
    block_size: int = 16
    dtype: torch.dtype = torch.bfloat16


# full width: 24 * 16 * 16 * 64 * 2 B = 786,432 B per block and pool
KV = KVGeometry(N_LAYERS, N_KV_HEADS, HEAD_DIM)
# the width of the JAX package's ``configs.reduced`` (4 layers, 2 KV heads,
# d_head 32), for CPU tests
REDUCED = KVGeometry(4, 2, 32)
