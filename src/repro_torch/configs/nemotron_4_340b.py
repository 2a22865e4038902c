"""Nemotron-4-340B [arXiv:2402.16819]: dense GQA, squared-ReLU MLP."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
    d_ff=73728, vocab=256000, mlp="squared_relu", rope="rope")
