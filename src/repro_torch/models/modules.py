"""Minimal functional module system: parameter specs with logical axes
(twin of the JAX package's ``models/modules.py``).

Models declare their parameters as a nested dict of :class:`ParamSpec`
(shape, dtype, logical axis names, initializer).  From that single
declaration we derive:

  * ``abstract_params``  — tensors on the ``meta`` device (shape and dtype,
    no storage: PyTorch's ``ShapeDtypeStruct``), for 340B-parameter
    configs,
  * ``init_params``      — real tensors from a ``torch.Generator``,
  * ``logical_axes_tree`` / ``count_params``,

and ``remat``, the reference's ``jax.remat`` under autograd; ``whole``
and ``split_heads`` / ``merge_heads`` gather a dim of a DTensor where an
op has no sharding rule across it, and ``on_head_shards`` runs attention
on each rank's batch and head shards (plain tensors pass through all four
as they are).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

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


REMAT_POLICIES = ("full", "dots", "none")
# the products with no batch dims: what
# jax.checkpoint_policies.dots_with_no_batch_dims_saveable keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _needs_grad(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.requires_grad
    if isinstance(tree, dict):
        return any(_needs_grad(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_needs_grad(v) for v in tree)
    return False


def remat(fn: Callable, *args, policy: str = "full"):
    """``fn(*args)``, keeping for the backward pass what ``policy`` says
    (the reference's ``jax.remat`` / ``jax.checkpoint`` policies):
    "full" only ``args`` (``fn`` runs again in the backward pass), "dots"
    also the outputs of products with no batch dims (``aten.mm`` /
    ``aten.addmm``), "none" everything.  Values do not depend on the
    policy.  Every tensor ``fn`` differentiates must be in ``args``
    (nested in dicts, lists or tuples); without grad mode, or with no
    such tensor requiring grad, ``fn`` simply runs."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {policy!r} not in {REMAT_POLICIES}")
    if policy == "none" or not (torch.is_grad_enabled() and _needs_grad(args)):
        return fn(*args)
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_saveable)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def whole(x, dim: int):
    """``x`` with tensor dim ``dim`` whole on every rank, where ``x`` is a
    DTensor sharded across it (the mesh path, at an op DTensor has no
    sharding rule for across that dim); anything else as it is."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.dim()
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(
        x.device_mesh, pl)


def split_heads(x, n: int, d: int, groups: int):
    """x [..., n*d] -> [..., n, d], the heads later split into ``groups``
    groups (``groups`` divides ``n``).  A DTensor sharded across its last
    dim into a count of shards that does not divide ``groups`` has that
    dim gathered first: DTensor shards a split dim only through its
    leading part, as GSPMD would move the rest of the split into ``d``."""
    if isinstance(x, DTensor):
        k = math.prod(x.device_mesh.size(i)
                      for i, p in enumerate(x.placements)
                      if isinstance(p, Shard) and p.dim == x.dim() - 1)
        if groups % k:
            x = whole(x, -1)
    return x.reshape(tuple(x.shape[:-1]) + (n, d))


def on_head_shards(fn: Callable, q, k, v, n_kv: int):
    """``fn(q, k, v)`` (attention: q [B, S, H, Dh], k / v [B, S, n_kv, Dh],
    a result shaped as q) on each rank's shards of the DTensors q, k, v:
    the batch and the heads stay sharded as q's are (the heads only where
    their shard count divides ``n_kv``, so that each rank holds whole GQA
    groups), every other dim is gathered, and the result is laid out as
    those shards.  The local ops are the one-device path's."""
    mesh = q.device_mesh
    pl = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
          for p in q.placements]

    def count(dim):
        return math.prod(mesh.size(i) for i, p in enumerate(pl)
                         if isinstance(p, Shard) and p.dim == dim)
    if n_kv % count(2):
        pl = [Replicate() if isinstance(p, Shard) and p.dim == 2 else p
              for p in pl]
    if q.shape[0] % count(0):
        pl = [Replicate() if isinstance(p, Shard) and p.dim == 0 else p
              for p in pl]
    q, k, v = (x.redistribute(mesh, pl) for x in (q, k, v))
    out = fn(q.to_local(), k.to_local(), v.to_local())
    shape = tuple(q.shape)
    return DTensor.from_local(
        out, mesh, pl, shape=torch.Size(shape),
        stride=tuple(math.prod(shape[i + 1:]) for i in range(len(shape))))


def merge_heads(x):
    """x [..., n, d] -> [..., n*d].  A DTensor's result is pinned to its
    forward layout, so that the backward pass's grad of the merged dim
    comes back in a layout the reshape can split again (DTensor shards a
    split dim only through its leading part)."""
    y = x.reshape(tuple(x.shape[:-2]) + (-1,))
    if isinstance(y, DTensor):
        y = y.redistribute(y.device_mesh, y.placements)
    return y
