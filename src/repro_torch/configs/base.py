"""Architecture and shape configuration (twin of the JAX package's
``configs/base.py``, with the same names and numbers).

Every assigned architecture is an :class:`ArchConfig`; the four assigned
input shapes are :data:`SHAPES`.  ``reduced()`` produces the CPU-smoke-test
variant of an architecture (same family/topology, tiny widths).
``ArchConfig.param_dtype()`` returns a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def torch_dtype(name: str) -> torch.dtype:
    """The ``torch.dtype`` a config's dtype string names ("bfloat16",
    "float32", "float8_e4m3fn", ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden width
    shared_expert: bool = False    # llama4-style always-on shared expert
    capacity_factor: float = 1.25
    every: int = 1                 # MoE layer every N layers (jamba: 2)


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int                   # attention heads (0 for attn-free)
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None   # defaults to d_model // n_heads
    mlp: str = "swiglu"            # swiglu | squared_relu | gelu
    qkv_bias: bool = False
    rope: str = "rope"             # rope | mrope | none
    encoder_only: bool = False
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    attn_every: int = 1            # jamba: attention layer every N (=8)
    rwkv: bool = False
    frontend: Optional[str] = None  # vision | audio (stubbed embeddings)
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        if self.d_head is not None:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def attn_free(self) -> bool:
        return self.rwkv

    @property
    def sub_quadratic(self) -> bool:
        """Supports 500k-token decode (SSM / hybrid with O(1) state)."""
        return self.rwkv or self.mamba is not None

    @property
    def has_decode(self) -> bool:
        return not self.encoder_only

    def param_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def n_params(self) -> int:
        """Approximate parameter count (for MODEL_FLOPS and sanity checks)."""
        d, L = self.d_model, self.n_layers
        dh = self.head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        for i in range(L):
            is_attn = (i % self.attn_every) == (self.attn_every - 1) \
                if self.attn_every > 1 else True
            if self.rwkv:
                per_layer += 4 * d * d + 2 * d * self.d_ff   # time-mix + channel-mix
                continue
            if self.mamba is not None and not is_attn:
                di = self.mamba.expand * d
                per_layer += 2 * d * di + di * d + di * (2 * self.mamba.d_state)
            else:
                per_layer += d * (self.n_heads * dh) * 2 \
                    + d * (self.n_kv_heads * dh) * 2
            if self.moe is not None and (i % self.moe.every
                                         == self.moe.every - 1):
                mult = 3 if self.mlp == "swiglu" else 2
                per_layer += self.moe.n_experts * mult * d * self.moe.d_ff
                per_layer += d * self.moe.n_experts
                if self.moe.shared_expert:
                    per_layer += mult * d * self.moe.d_ff
            elif not (self.rwkv or (self.mamba is not None and not is_attn)):
                mult = 3 if self.mlp == "swiglu" else 2
                per_layer += mult * d * self.d_ff
        return emb + per_layer

    def _n_moe_layers(self) -> int:
        return sum(1 for i in range(self.n_layers)
                   if (i % self.moe.every) == self.moe.every - 1)

    def n_expert_params(self) -> int:
        """Routed-expert parameters only (excludes shared experts)."""
        if self.moe is None:
            return 0
        mult = 3 if self.mlp == "swiglu" else 2
        return self._n_moe_layers() * self.moe.n_experts * mult \
            * self.d_model * self.moe.d_ff

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: routed top-k + shared only)."""
        if self.moe is None:
            return self.n_params()
        mult = 3 if self.mlp == "swiglu" else 2
        active = self._n_moe_layers() * self.moe.top_k * mult \
            * self.d_model * self.moe.d_ff
        return self.n_params() - self.n_expert_params() + active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_is_valid(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is a runnable dry-run cell; reason if not.

    Skips follow the assignment text: encoder-only archs have no decode
    step; ``long_500k`` needs sub-quadratic attention.
    """
    if shape.is_decode and not arch.has_decode:
        return False, "encoder-only: no decode step"
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "full-attention arch: 500k decode skipped per assignment"
    return True, ""


def reduced(arch: ArchConfig) -> ArchConfig:
    """Tiny same-family variant for CPU smoke tests."""
    kw = dict(
        name=arch.name + "-smoke",
        n_layers=min(arch.n_layers, 4 if arch.attn_every <= 1
                     else arch.attn_every),
        d_model=128,
        n_heads=min(arch.n_heads, 4) if arch.n_heads else 0,
        n_kv_heads=min(arch.n_kv_heads, 2) if arch.n_kv_heads else 0,
        d_head=32 if arch.n_heads else None,
        d_ff=256,
        vocab=512,
    )
    if arch.moe is not None:
        kw["moe"] = dataclasses.replace(arch.moe, n_experts=4,
                                        top_k=min(arch.moe.top_k, 2),
                                        d_ff=128)
    if arch.rwkv:
        kw["n_heads"] = 2
        kw["n_kv_heads"] = 2
        kw["d_head"] = 64           # RWKV6 head size is fixed at 64
        kw["d_model"] = 128
    return dataclasses.replace(arch, **kw)
