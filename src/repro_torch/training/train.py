"""Train-step factories: microbatched grad accumulation, the AdamW update
in place, and the compressed cross-DP gradient sync (twin of the JAX
package's ``training/train.py``, same names).

Two paths, as the reference's:

  * ``make_train_step(cfg, tc, mesh=None)`` gives ``train_step(params,
    opt_state, batch) -> (params, opt_state, metrics)``: the loss and its
    grads by autograd (``models.lm_loss``, whose ``remat_policy`` chooses
    what the backward pass keeps), global-norm clipping and
    ``adamw_update``, which writes the params and moments in place (the
    reference donates them to its jitted step).  With a ``DeviceMesh`` the
    params and the optimizer state are DTensors (laid out by
    ``distributed.sharding.param_shardings`` / ``opt_state_shardings``),
    the batch is sharded over the DP axes, and DTensor inserts the
    collectives GSPMD would (the grads' reduction over DP among them); the
    residual stream is held to ``batch_constraint`` or, with ``seq_shard``,
    ``seq_constraint`` at every layer group.
  * ``make_compressed_train_step`` — per-rank code over the mesh's DP
    group (the reference's ``shard_map``): each rank's grads on its rows
    are int8-quantized per tensor with a shared scale before an explicit
    int32 sum over DP — 4x less traffic on the cross-DP links — then
    dequantized for the replicated AdamW update.

The metrics stay tensors on the device: reading them is the caller's
choice.  The dtypes are the reference's: with ``microbatches == 1`` each
grad has its param's dtype (bf16 grads for bf16 params); with more, the
microbatches' grads are summed in ``accum_dtype`` and divided by their
count, and clipping casts each back to the grad's own dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from ..configs.base import ArchConfig, torch_dtype
from ..device import resolve_device
from ..distributed.sharding import dp_axes, placements
from ..models import lm_loss
from ..models.modules import tree_leaves, tree_map
from . import optimizer as opt_mod

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1            # grad-accumulation steps per train step
    remat_policy: str = "full"       # none | dots | full
    aux_weight: float = 0.01
    compress_grads: Optional[str] = None   # None | "int8"
    seq_shard: bool = False          # sequence parallelism on activations
    accum_dtype: str = "float32"     # grad-accumulation dtype (bf16 halves
    #                                  the accumulator for 340B+ cells)
    opt: opt_mod.OptConfig = opt_mod.OptConfig()


def _constraint(mesh, spec):
    """[B, S, D] DTensors redistributed to ``spec``'s placements; the
    identity on a plain tensor."""
    target = placements(spec, mesh)

    def constrain(x):
        if not isinstance(x, DTensor):
            return x
        return x.redistribute(mesh, target)
    return constrain


def batch_constraint(mesh):
    """DP-only activation constraint: [B, S, D] batch over ("pod","data"),
    replicated over the rest."""
    return _constraint(mesh, (dp_axes(mesh), None, None))


def seq_constraint(mesh):
    """Sequence-parallel activation constraint: [B, S, D] -> S over model."""
    return _constraint(mesh, (dp_axes(mesh), "model", None))


def _shard_rows(x: torch.Tensor, mesh, dim: int = 0) -> DTensor:
    """``x`` (the same full tensor on every rank) as a DTensor with ``dim``
    sharded over the DP axes: each rank keeps its rows."""
    spec = [None] * x.dim()
    spec[dim] = dp_axes(mesh)
    return distribute_tensor(x, mesh, placements(tuple(spec), mesh),
                             src_data_rank=None)


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int, mesh=None):
    """[B, ...] -> [n, B/n, ...] per leaf.

    With a mesh, microbatch ``i`` is the global rows ``i*B/n ...
    (i+1)*B/n`` sharded over DP on dim 1, as the reference constrains it
    (not the first rows of each rank's own): the rows are gathered, split
    and each rank keeps its share of each microbatch."""
    def one(x):
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} rows does not split "
                             f"into {n} microbatches")
        if isinstance(x, DTensor):
            x = x.full_tensor()
        y = x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
        return y if mesh is None else _shard_rows(y, mesh, dim=1)
    return {k: one(v) for k, v in batch.items()}


def _value_and_grad(loss_fn, params, batch):
    """(loss, grads): grads by autograd, a tree like ``params``, each leaf
    in its param's dtype (zeros for a param the loss does not use, as
    ``jax.grad`` gives)."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(cfg: ArchConfig, tc: TrainConfig, mesh=None,
                    device=None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    Without a mesh, ``device`` (``None``: the CUDA device; raises without
    one) holds the params and the optimizer state; the batch is moved
    there.  With a ``DeviceMesh`` (``device`` is then the mesh's), the
    params and the optimizer state must be DTensors on it, and the batch
    is either DTensors or the global batch as plain tensors, the same on
    every rank (each keeps its rows).  The step sets ``requires_grad`` on
    the param leaves and updates them in place.
    """
    if mesh is not None:
        return _mesh_train_step(cfg, tc, mesh)
    dev = resolve_device(device)
    adt = torch_dtype(tc.accum_dtype)

    def loss_fn(params, mb):
        return lm_loss(cfg, params, mb, remat_policy=tc.remat_policy,
                       aux_weight=tc.aux_weight)

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        if any(p.device.type != dev.type for p in leaves):
            raise ValueError(f"the params must lie on {dev}")
        for p in leaves:
            p.requires_grad_(True)
        batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        if tc.microbatches > 1:
            mbs = _split_microbatches(batch, tc.microbatches)
            loss = torch.zeros((), dtype=F32, device=dev)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=adt,
                                                   device=dev), params)
            for i in range(tc.microbatches):
                l, g = _value_and_grad(loss_fn, params,
                                       {k: v[i] for k, v in mbs.items()})
                loss = loss + l
                grads = tree_map(lambda a, b: a + b.to(adt), grads, g)
            inv = opt_mod.recip_f32(tc.microbatches)
            loss = loss * inv
            grads = tree_map(lambda g: g * inv, grads)
        else:
            loss, grads = _value_and_grad(loss_fn, params, batch)
        return _update(tc, params, grads, opt_state, loss)

    return train_step


def _update(tc: TrainConfig, params, grads, opt_state, loss):
    grads, gnorm = opt_mod.clip_by_global_norm(grads, tc.opt.grad_clip)
    params, opt_state = opt_mod.adamw_update(tc.opt, params, grads,
                                             opt_state)
    metrics = {"loss": loss, "grad_norm": gnorm,
               "lr": opt_mod.schedule(tc.opt, opt_state["step"])}
    return params, opt_state, metrics


def _mesh_train_step(cfg: ArchConfig, tc: TrainConfig, mesh) -> Callable:
    """``make_train_step`` on a mesh: the same step on DTensors, run under
    ``implicit_replication`` (the tensors made inside layers, positions
    and masks, count as replicated), each grad laid out as its param."""
    act = seq_constraint(mesh) if tc.seq_shard else batch_constraint(mesh)
    adt = torch_dtype(tc.accum_dtype)

    def loss_fn(params, mb):
        return lm_loss(cfg, params, mb, remat_policy=tc.remat_policy,
                       aux_weight=tc.aux_weight, act_constraint=act)

    def value_and_grad(params, mb):
        loss, grads = _value_and_grad(loss_fn, params, mb)
        return loss, tree_map(
            lambda g, p: g.redistribute(mesh, p.placements), grads, params)

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        if not all(isinstance(p, DTensor) and p.device_mesh == mesh
                   for p in leaves):
            raise ValueError("the params must be DTensors on the step's "
                             "mesh (distributed.sharding.distribute)")
        for p in leaves:
            p.requires_grad_(True)
        batch = {k: v if isinstance(v, DTensor) else _shard_rows(v, mesh)
                 for k, v in batch.items()}
        with implicit_replication():
            if tc.microbatches > 1:
                mbs = _split_microbatches(batch, tc.microbatches, mesh)
                loss = torch.zeros((), dtype=F32, device=mesh.device_type)
                grads = tree_map(lambda p: torch.zeros_like(p, dtype=adt),
                                 params)
                for i in range(tc.microbatches):
                    l, g = value_and_grad(params,
                                          {k: v[i] for k, v in mbs.items()})
                    loss = loss + l
                    grads = tree_map(lambda a, b: a + b.to(adt), grads, g)
                inv = opt_mod.recip_f32(tc.microbatches)
                loss = loss * inv
                grads = tree_map(lambda g: g * inv, grads)
            else:
                loss, grads = value_and_grad(params, batch)
            loss = loss.redistribute(mesh, [Replicate()] * mesh.ndim)
            return _update(tc, params, grads, opt_state, loss)

    return train_step


# ---------------------------------------------------------------------------
# compressed-gradient path (explicit DP collectives, per-rank code)
# ---------------------------------------------------------------------------
def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: (q, scale), ``round`` half to even."""
    scale = torch.clamp(g.abs().max(), min=1e-12) * opt_mod.recip_f32(127)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale.to(F32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def dp_group(mesh):
    """The process group over the mesh's DP axes (one axis, or ("pod",
    "data") flattened into one)."""
    dp = dp_axes(mesh)
    if isinstance(dp, tuple):
        return mesh[dp]._flatten().get_group()
    return mesh.get_group(dp)


def compressed_psum(grads, group):
    """int8-compressed mean over the ranks of ``group``.

    Each leaf is quantized per-tensor with the largest scale of the
    group's ranks (``all_reduce`` MAX), summed in int32 (no overflow for
    <= 2^23 ranks) and dequantized with that scale over the rank count —
    the standard 1-bit/8-bit-Adam style scheme without error feedback.
    """
    n = torch.tensor(float(dist.get_world_size(group)), dtype=F32)

    def one(g):
        g32 = g.to(F32)
        _, scale = quantize_int8(g32)
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return (total.to(F32) * scale / n.to(g.device)).to(g.dtype)
    return tree_map(one, grads)


def _pmean(x: torch.Tensor, group) -> torch.Tensor:
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x / dist.get_world_size(group)


def make_compressed_train_step(cfg: ArchConfig, tc: TrainConfig,
                               mesh) -> Callable:
    """Per-rank train step over the mesh's DP group, int8 gradient sync.

    The params and the optimizer state are plain tensors, the same on
    every rank (the reference's ``P()``: the model axis computes
    replicated); the batch is the global batch as plain tensors or a
    DTensor, and each rank takes its DP rows.  The grads of the rank's
    rows are averaged over DP through :func:`compressed_psum`
    (``compress_grads="int8"``) or a plain mean, and so is the loss; the
    update then runs alike on every rank."""
    group = dp_group(mesh)
    dp = dp_axes(mesh)
    names = dp if isinstance(dp, tuple) else (dp,)

    def loss_fn(params, mb):
        return lm_loss(cfg, params, mb, remat_policy=tc.remat_policy,
                       aux_weight=tc.aux_weight)

    def rows(x):
        if isinstance(x, DTensor):
            x = x.full_tensor()
        n_dp, r = 1, 0
        for a in names:
            n_dp *= mesh.size(mesh.mesh_dim_names.index(a))
            r = r * mesh.size(mesh.mesh_dim_names.index(a)) \
                + mesh.get_local_rank(a)
        per = x.shape[0] // n_dp
        return x[r * per:(r + 1) * per]

    def per_shard(params, opt_state, batch):
        for p in tree_leaves(params):
            p.requires_grad_(True)
        loss, grads = _value_and_grad(loss_fn, params,
                                      {k: rows(v) for k, v in batch.items()})
        grads = tree_map(lambda g: g.to(F32), grads)
        if tc.compress_grads == "int8":
            grads = compressed_psum(grads, group)
        else:
            grads = tree_map(lambda g: _pmean(g, group), grads)
        loss = _pmean(loss, group)
        return _update(tc, params, grads, opt_state, loss)

    return per_shard
