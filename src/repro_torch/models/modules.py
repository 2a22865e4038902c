"""Minimal functional module system: parameter specs with logical axes
(twin of the JAX package's ``models/modules.py``).

Models declare their parameters as a nested dict of :class:`ParamSpec`
(shape, dtype, logical axis names, initializer).  From that single
declaration we derive:

  * ``abstract_params``  — tensors on the ``meta`` device (shape and dtype,
    no storage: PyTorch's ``ShapeDtypeStruct``), for 340B-parameter
    configs,
  * ``init_params``      — real tensors from a ``torch.Generator``,
  * ``logical_axes_tree`` / ``count_params``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from ..configs.base import torch_dtype
from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical_axes: Tuple[Optional[str], ...]   # e.g. ("vocab", "embed")
    dtype: str = "bfloat16"
    init: str = "normal"                      # normal | zeros | ones | scaled
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.logical_axes):
            raise ValueError(f"{self.shape} vs {self.logical_axes}")


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (keys in sorted order, as
    ``jax.tree`` flattens them); ``rest`` are trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def abstract_params(specs) -> dict:
    return tree_map(lambda s: torch.empty(s.shape, dtype=torch_dtype(s.dtype),
                                          device="meta"), specs)


def init_params(specs, generator: torch.Generator, device=None) -> dict:
    """Draws every leaf in f32 on ``generator``'s device (one leaf after
    another, in ``tree_leaves`` order), scales it, then casts it to the
    spec's dtype on ``device``: zeros, ones, ``normal * scale`` and
    ``scaled`` = ``scale / sqrt(shape[0])`` (1/sqrt(fan_in) output
    projections), as the reference draws them; the bits differ from
    ``jax.random``'s."""
    dev = resolve_device(device)

    def make(s: ParamSpec):
        dt = torch_dtype(s.dtype)
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=dev)
        scale = s.scale
        if s.init == "scaled":
            scale = s.scale / math.sqrt(max(s.shape[0], 1))
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return x.mul_(scale).to(device=dev, dtype=dt)

    return tree_map(make, specs)


def logical_axes_tree(specs):
    return tree_map(lambda s: s.logical_axes, specs)


def count_params(specs) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs))
