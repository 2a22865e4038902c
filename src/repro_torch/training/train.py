"""Train-step factory: microbatched grad accumulation and the AdamW update
in place (twin of the JAX package's ``training/train.py``, same names).

``make_train_step(cfg, tc)`` gives ``train_step(params, opt_state, batch)
-> (params, opt_state, metrics)``: the loss and its grads by autograd
(``models.lm_loss``, whose ``remat_policy`` chooses what the backward
pass keeps), global-norm clipping and ``adamw_update``, which writes the
params and moments in place (the reference donates them to its jitted
step).  The metrics stay tensors on the device: reading them is the
caller's choice.

The dtypes are the reference's: with ``microbatches == 1`` each grad has
its param's dtype (bf16 grads for bf16 params); with more, the
microbatches' grads are summed in ``accum_dtype`` and divided by their
count, and clipping casts each back to the grad's own dtype.

One device.  What needs a mesh waits for the distributed slice
(``ROADMAP.md`` queue 1, item 13): ``batch_constraint``,
``seq_constraint``, ``compressed_psum`` and ``make_compressed_train_step``
are not ported, and ``make_train_step`` refuses ``mesh``, ``seq_shard``
and ``compress_grads``.  ``quantize_int8`` / ``dequantize_int8`` are.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig, torch_dtype
from ..device import resolve_device
from ..models import lm_loss
from ..models.modules import tree_leaves, tree_map
from . import optimizer as opt_mod

F32 = torch.float32
_DISTRIBUTED = ("waits for the distributed slice (ROADMAP.md queue 1, item "
                "13); the port's train step runs on one device")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1            # grad-accumulation steps per train step
    remat_policy: str = "full"       # none | dots | full
    aux_weight: float = 0.01
    compress_grads: Optional[str] = None   # None | "int8" (needs a mesh)
    seq_shard: bool = False          # sequence parallelism (needs a mesh)
    accum_dtype: str = "float32"     # grad-accumulation dtype
    opt: opt_mod.OptConfig = opt_mod.OptConfig()


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int):
    """[B, ...] -> [n, B/n, ...] per leaf."""
    def one(x):
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} rows does not split "
                             f"into {n} microbatches")
        return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
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

    ``device`` (``None``: the CUDA device; raises without one) holds the
    params and the optimizer state; the batch is moved there.  The step
    sets ``requires_grad`` on the param leaves and updates them in place.
    """
    if mesh is not None:
        raise ValueError(f"make_train_step(mesh=...) {_DISTRIBUTED}")
    if tc.seq_shard:
        raise ValueError(f"TrainConfig(seq_shard=True) {_DISTRIBUTED}")
    if tc.compress_grads is not None:
        raise ValueError(f"TrainConfig(compress_grads={tc.compress_grads!r})"
                         f" {_DISTRIBUTED}")
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

        grads, gnorm = opt_mod.clip_by_global_norm(grads, tc.opt.grad_clip)
        params, opt_state = opt_mod.adamw_update(tc.opt, params, grads,
                                                 opt_state)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "lr": opt_mod.schedule(tc.opt, opt_state["step"])}
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# int8 gradient compression (the quantizer; its collective needs a mesh)
# ---------------------------------------------------------------------------
def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: (q, scale), ``round`` half to even."""
    scale = torch.clamp(g.abs().max(), min=1e-12) * opt_mod.recip_f32(127)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale.to(F32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale
