"""AdamW with f32 state, cosine schedule, global-norm clipping (twin of the
JAX package's ``training/optimizer.py``, same names and arithmetic).

Params, grads and moments are the port's dict trees of tensors
(``models.modules.tree_map``).  The step counter is a 0-dim int32 tensor
on the params' device; the schedule and the bias corrections are f32
tensor arithmetic on that device, as the reference's (no host read of the
step, no float64).  :func:`adamw_update` writes the params and moments in
place under ``torch.no_grad()`` (the reference donates them to its jitted
step) and returns the same trees.

On a mesh the leaves are DTensors (``distributed.sharding``): the
moments shard like their params (the factored update takes its row and
column means across the ranks and runs its elementwise tail on each
rank's shard of the param, never gathering one), the global norm is a
replicated scalar, and the step counter is a replicated 0-dim DTensor
whose local value drives the schedule and the bias corrections (plain
tensors, the same on every rank); the caller runs the update under DTensor's
``implicit_replication`` (``training.train`` does).

``zero1`` is a field that nothing reads, as in the reference (whose
docstring promises a ZeRO-1 sharding of the moments that its code never
applies).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..libm import powf
from ..models.modules import tree_leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    zero1: bool = False
    # Factored mode (Adafactor-style): bf16 first moment + row/col-factored
    # f32 second moment.  Cuts optimizer memory from 8 to ~2 bytes/param.
    factored: bool = False


def _f32(x: float) -> float:
    """``x`` rounded to f32, as the reference's weak-typed Python scalars
    are when they meet an f32 array."""
    return float(torch.tensor(x, dtype=F32))


def _full(x: float, like: torch.Tensor) -> torch.Tensor:
    """An f32 0-dim tensor on ``like``'s device: an operand that stays a
    tensor (torch divides by a host scalar as a product with its
    reciprocal on the card, where the reference divides)."""
    return torch.full((), x, dtype=F32, device=like.device)


def recip_f32(n) -> float:
    """``1 / n`` rounded once to f32: XLA compiles the reference's division
    by a constant into a product with it (as torch does on the card)."""
    return float(torch.ones((), dtype=F32) / float(n))


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to 0 at ``total_steps``; ``step``
    an int tensor, the result an f32 tensor on its device (torch's
    ``cos``, within an ulp of the reference's glibc ``cosf``)."""
    warm = torch.clamp(step.to(F32) * recip_f32(max(cfg.warmup_steps, 1)),
                       max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps).to(F32)
                       * recip_f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0.0, 1.0)
    cos = torch.cos(_f32(math.pi) * prog)
    return _f32(cfg.lr) * warm * 0.5 * (1.0 + cos)


def _v_shapes(shape) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Factored second-moment shapes: row/col stats over the last two dims."""
    shape = tuple(shape)
    if len(shape) < 2:
        return shape, ()
    return shape[:-1], shape[:-2] + shape[-1:]


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def init_opt_state(params, factored: bool = False) -> Dict[str, Any]:
    """Zero moments beside the params, on their device."""
    if not factored:
        zeros = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": _step0(params)}
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                                            device=p.device), params),
        "vr": tree_map(lambda p: torch.zeros(_v_shapes(p.shape)[0], dtype=F32,
                                             device=p.device), params),
        "vc": tree_map(lambda p: torch.zeros(_v_shapes(p.shape)[1], dtype=F32,
                                             device=p.device), params),
        "step": _step0(params)}


def abstract_opt_state(abstract_tree, factored: bool = False) -> Dict[str, Any]:
    """The optimizer state's shapes and dtypes as ``meta`` tensors."""
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    step = meta((), torch.int32)
    if not factored:
        return {"m": tree_map(lambda p: meta(p.shape, F32), abstract_tree),
                "v": tree_map(lambda p: meta(p.shape, F32), abstract_tree),
                "step": step}
    return {"m": tree_map(lambda p: meta(p.shape, torch.bfloat16),
                          abstract_tree),
            "vr": tree_map(lambda p: meta(_v_shapes(p.shape)[0], F32),
                           abstract_tree),
            "vc": tree_map(lambda p: meta(_v_shapes(p.shape)[1], F32),
                           abstract_tree),
            "step": step}


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so their global f32 norm is at most ``max_norm``, each
    cast back to its own dtype; the norm before clipping)."""
    leaves = tree_leaves(grads)
    sq = torch.zeros((), dtype=F32, device=leaves[0].device)
    for g in leaves:
        sq = sq + torch.sum(torch.square(g.to(F32)))
    norm = torch.sqrt(sq)
    scale = torch.clamp(_full(_f32(max_norm), norm)
                        / torch.clamp(norm, min=_f32(1e-9)), max=1.0)
    return tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), grads), norm


def _local(t: torch.Tensor) -> torch.Tensor:
    """A replicated DTensor's local value (the same on every rank); a
    plain tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def _laid_out_as(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A DTensor ``x`` redistributed to ``like``'s placements (a partial
    mean summed into its shards); a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(like.device_mesh, like.placements)


def _local_beside(x: torch.Tensor, p: torch.Tensor, dims) -> torch.Tensor:
    """The local shard of ``x`` that broadcasts against ``p``'s: ``dims``
    maps each dim of ``p`` that ``x`` has to its dim in ``x``; ``x`` is
    sharded as ``p`` across those and replicated across the mesh dims that
    shard the rest.  A plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    pl = [Shard(dims[q.dim]) if isinstance(q, Shard) and q.dim in dims
          else Replicate() for q in p.placements]
    return x.redistribute(x.device_mesh, pl).to_local()


def _bias_correction(b: float, step: torch.Tensor) -> torch.Tensor:
    """``1 - b ** step`` in f32 on the step's device (glibc's ``powf``,
    as the reference's)."""
    return 1.0 - powf(_full(_f32(b), step), step.to(F32))


@torch.no_grad()
def adamw_update(cfg: OptConfig, params, grads, opt_state):
    """One AdamW step, in place: returns ``(params, opt_state)``, the same
    trees, with the params, moments and step written."""
    if cfg.factored:
        return _factored_update(cfg, params, grads, opt_state)
    step = _local(opt_state["step"]) + 1
    lr = schedule(cfg, step)
    b1, b2 = _f32(cfg.b1), _f32(cfg.b2)
    one_b1, one_b2 = _f32(1 - cfg.b1), _f32(1 - cfg.b2)
    eps, wd = _f32(cfg.eps), _f32(cfg.weight_decay)
    bc1 = _bias_correction(cfg.b1, step)
    bc2 = _bias_correction(cfg.b2, step)

    def upd(p, g, m, v):
        g = g.to(F32)
        m_new = b1 * m + one_b1 * g
        v_new = b2 * v + one_b2 * torch.square(g)
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + eps) + wd * p.to(F32)
        p.copy_((p.to(F32) - lr * delta).to(p.dtype))
        m.copy_(m_new)
        v.copy_(v_new)

    tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    _local(opt_state["step"]).copy_(step)
    return params, opt_state


@torch.no_grad()
def _factored_update(cfg: OptConfig, params, grads, opt_state):
    step = _local(opt_state["step"]) + 1
    lr = schedule(cfg, step)
    b1, b2 = _f32(cfg.b1), _f32(cfg.b2)
    one_b1, one_b2 = _f32(1 - cfg.b1), _f32(1 - cfg.b2)
    eps, wd, tiny = _f32(cfg.eps), _f32(cfg.weight_decay), _f32(1e-30)

    def upd(p, g, m, vr, vc):
        g = g.to(F32)
        g2 = torch.square(g) + tiny
        nd = g.dim()
        same = {d: d for d in range(nd)}
        if nd >= 2:
            vr_new = b2 * vr + one_b2 * _laid_out_as(
                torch.mean(g2, dim=-1), vr)
            vc_new = b2 * vc + one_b2 * _laid_out_as(
                torch.mean(g2, dim=-2), vc)
            lead = {d: d for d in range(nd - 2)}
            rows = _local_beside(vr_new, p, {**lead, nd - 2: nd - 2})
            cols = _local_beside(vc_new, p, {**lead, nd - 1: nd - 2})
            mean = _local_beside(torch.mean(vr_new, dim=-1, keepdim=True),
                                 p, lead)
            denom = torch.sqrt(rows[..., :, None] * cols[..., None, :]
                               / torch.clamp(mean[..., None], min=tiny))
        else:
            vr_new = b2 * vr + one_b2 * g2
            vc_new = vc
            denom = torch.sqrt(_local_beside(vr_new, p, same))
        # the elementwise tail on each rank's shard of p
        p_l, m_l = _local(p), _local(m)
        m_new = b1 * m_l.to(F32) + one_b1 * _local_beside(g, p, same)
        delta = m_new / (denom + eps) + wd * p_l.to(F32)
        p_l.copy_((p_l.to(F32) - lr * delta).to(p.dtype))
        m_l.copy_(m_new.to(torch.bfloat16))
        vr.copy_(vr_new)
        if vc_new is not vc:
            vc.copy_(vc_new)

    tree_map(upd, params, grads, opt_state["m"], opt_state["vr"],
             opt_state["vc"])
    _local(opt_state["step"]).copy_(step)
    return params, opt_state
