"""Qwen2.5-14B's attention geometry [hf:Qwen/Qwen2.5-14B, config.json:
num_hidden_layers 48, hidden_size 5120, num_attention_heads 40,
num_key_value_heads 8].

The JAX package's ``configs/qwen2_5_14b.py`` holds the same numbers; the
port keeps its own copy because ``repro.configs`` imports JAX.  It is the
grouped-query width of the port's paged attention: 5 query heads read
each KV head.
"""
N_LAYERS = 48
N_HEADS = 40
N_KV_HEADS = 8
HEAD_DIM = 5120 // 40
