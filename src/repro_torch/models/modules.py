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
op has no sharding rule across it, ``on_head_shards`` runs attention
on each rank's batch and head shards, ``on_ff_shards`` an MLP on its
batch and hidden shards and ``on_shards`` a step loop on each rank's
shards (plain tensors pass through the first three as they are);
``local_share`` is the local shard whose grad is the rank's share, and
``on_dims``, ``batch_layout``, ``replicated`` and ``reduce_over`` lay out
and reduce the shard-local paths' values; ``row_parallel`` and
``settled`` lay a row-parallel product and its pending sum out as GSPMD
does.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
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


def _global(y, mesh, pl):
    """The DTensor whose local shard on this rank is ``y``, laid out as
    ``pl`` (equal shards, a contiguous global stride)."""
    shape = list(y.shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            shape[p.dim] *= mesh.size(i)
    return DTensor.from_local(
        y, mesh, pl, shape=torch.Size(shape),
        stride=tuple(math.prod(shape[i + 1:]) for i in range(len(shape))))


def on_dims(ndim: int, dims, p) -> list:
    """Placements over a mesh of ``ndim`` dims: ``p`` on the mesh dims
    ``dims``, ``Replicate()`` on the others."""
    return [p if i in dims else Replicate() for i in range(ndim)]


def batch_layout(x, sharded):
    """(the mesh dims outside ``sharded`` on which the DTensor ``x`` shards
    its dim 0, the placements that keep those shards and replicate the
    rest): the batch layout of a shard-local path whose other mesh dims
    ``sharded`` split something else."""
    batch = {i for i, p in enumerate(x.placements)
             if i not in sharded and p == Shard(0)}
    return batch, on_dims(x.device_mesh.ndim, batch, Shard(0))


def replicated(x, mesh):
    """``x`` as a DTensor on ``mesh``: a plain tensor replicated over it,
    a DTensor as it is."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def reduce_over(x, mesh, dims, op: str = "sum", pl=None):
    """The DTensor laid out as ``pl`` (replicated if None) whose local value
    is each rank's ``x`` reduced (``op``) over the mesh dims ``dims``."""
    pl = [Replicate()] * mesh.ndim if pl is None else pl
    return DTensor.from_local(x, mesh, [
        Partial(op) if i in dims else p for i, p in enumerate(pl)
    ]).redistribute(mesh, pl)


def local_share(x, pl, summed):
    """The local shard of the DTensor ``x`` laid out as ``pl``, its grad
    in the backward pass summed over the mesh dims ``summed``: where the
    shard is replicated but each rank uses it for its share of the work,
    each rank's grad is its share of the sum."""
    return x.redistribute(x.device_mesh, pl).to_local(grad_placements=[
        Partial() if i in summed else p for i, p in enumerate(pl)])


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
    return _global(fn(q.to_local(), k.to_local(), v.to_local()), mesh, pl)


def on_shards(fn: Callable, like, args, dims, out_dims):
    """``fn(*args)`` on each rank's local shards, for a step loop whose ops
    are elementwise or batched over two dims of ``like`` (a DTensor): the
    mesh dims that shard one of ``like``'s dims named in ``dims`` shard
    every arg alike, every other mesh dim replicates, and ``fn`` runs on
    plain tensors with the one-device path's ops, free of DTensor's
    dispatch on each of them (a loop over 4,096 steps is ~1e5 ops).
    ``dims[i]`` maps a dim of ``like`` to the matching dim of ``args[i]``
    (a dim it lacks replicates the arg across those mesh dims; a plain
    tensor arg is replicated to begin with); ``out_dims[i]`` does the same
    for the i-th result, which comes back as a DTensor so laid out."""
    mesh = like.device_mesh
    keep = set().union(*dims)
    pl = [p if isinstance(p, Shard) and p.dim in keep
          and like.shape[p.dim] % mesh.size(i) == 0 else None
          for i, p in enumerate(like.placements)]

    def layout(dmap):
        return [Shard(dmap[p.dim]) if p is not None and p.dim in dmap
                else Replicate() for p in pl]
    local = []
    for a, dmap in zip(args, dims):
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        apl = layout(dmap)
        # an arg replicated across mesh dims that shard the loop gets from
        # each rank the grad of its shard's work: their sum
        grad = [Partial() if p is not None and p.dim not in dmap else q
                for p, q in zip(pl, apl)]
        local.append(a.redistribute(mesh, apl).to_local(grad_placements=grad))
    return tuple(_global(y, mesh, layout(dmap))
                 for y, dmap in zip(fn(*local), out_dims))


def on_ff_shards(fn: Callable, x, w: dict, ff: dict):
    """``fn(x, w)`` (an MLP: x [B, ..., D], weights ``w`` whose hidden dim
    is ``ff[name]``, the result the down projection [B, ..., D]) on each
    rank's shards of the DTensor ``x``: x keeps its batch shards and is
    gathered in every other dim, each weight keeps the shards of its
    hidden dim (on the mesh dims that shard every weight's) and is
    gathered in every other dim, so the hidden layer stays [B / dp, ...,
    F / tp] (Megatron's tensor parallelism, the layout GSPMD gives the
    reference).  Each rank's result is its partial sum of the down
    projection over the hidden shards; it comes back summed and laid out
    as ``x`` (replicated where ``x`` is a pending sum).  The local ops are
    the one-device path's."""
    mesh = x.device_mesh
    w = {k: replicated(v, mesh) for k, v in w.items()}
    ffd = {i for i in range(mesh.ndim)
           if all(v.placements[i] == Shard(ff[k]) for k, v in w.items())}
    batch, xpl = batch_layout(x, ffd)
    x_l = local_share(x, xpl, ffd)
    w_l = {k: local_share(v, on_dims(mesh.ndim, ffd, Shard(ff[k])), batch)
           for k, v in w.items()}
    y = _global(fn(x_l, w_l), mesh,
                [Partial() if i in ffd else p for i, p in enumerate(xpl)])
    return y.redistribute(mesh, [Replicate() if p.is_partial() else p
                                 for p in x.placements])


def merge_heads(x):
    """x [..., n, d] -> [..., n*d].  A DTensor's result is pinned to its
    forward layout, so that the backward pass's grad of the merged dim
    comes back in a layout the reshape can split again (DTensor shards a
    split dim only through its leading part)."""
    return pinned(x.reshape(tuple(x.shape[:-2]) + (-1,)))


def row_parallel(x, w):
    """``x @ w`` where the DTensor ``w`` shards its dim 0 over some mesh
    dims on which ``x`` is replicated: ``x`` is first cut into the
    matching slices of its last dim (local, no traffic), so that each
    rank's product is its partial sum and ``w``'s grad is computed and
    reduced at ``w``'s shard (left whole, ``x`` is what the backward pass
    keeps, and ``w``'s grad comes out whole on every rank, to be summed
    whole over the data ranks); anything else as ``x @ w``."""
    if isinstance(x, DTensor) and isinstance(w, DTensor):
        pl = [Shard(x.dim() - 1) if q == Shard(0) and p == Replicate()
              else p for p, q in zip(x.placements, w.placements)]
        if pl != list(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    return x @ w


def settled(x):
    """A DTensor with its pending sums resolved: each ``Partial`` mesh dim
    replicated (the all-reduce GSPMD places at a row-parallel product's
    output, before the residual add; left pending, the next norm
    scatters the rows over that mesh dim and the backward pass gathers
    whole weights to meet them); anything else as it is."""
    if isinstance(x, DTensor) and any(p.is_partial() for p in x.placements):
        return x.redistribute(x.device_mesh, [
            Replicate() if p.is_partial() else p for p in x.placements])
    return x


def pinned(x):
    """A DTensor as it is, but its grad in the backward pass laid out as
    ``x`` is (an identity ``redistribute``); anything else as it is."""
    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, x.placements)
    return x
