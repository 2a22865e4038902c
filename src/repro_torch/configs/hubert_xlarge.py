"""HuBERT-XLarge [arXiv:2106.07447]: encoder-only audio transformer.

The convolutional waveform frontend is a stub: ``input_specs`` supplies
precomputed frame embeddings; the head predicts 504 cluster targets.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab=504, mlp="gelu", rope="none", encoder_only=True,
    frontend="audio")
