"""Mixture-of-Experts layer: top-k routing, capacity-based dispatch (twin
of the JAX package's ``models/moe.py``).

Switch/GShard-style dense dispatch: tokens are routed per sequence with
capacity ``C = ceil(S * top_k / E * capacity_factor)`` per S-chunk; a
token's slot in its expert's buffer counts the (token, k-slot) pairs
before it, token-major.  Overflowed tokens are dropped (contribute zero),
standard for capacity-based MoE.  Top-k breaks ties by the lower expert
index, as ``jax.lax.top_k`` does (``torch.topk`` does not promise it).

Returns the load-balancing auxiliary loss (Switch, eq. 4) alongside the
output.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from .modules import ParamSpec

F32 = torch.float32


def moe_param_specs(d_model: int, d_ff: int, n_experts: int, mlp: str,
                    shared_expert: bool, dtype: str) -> Dict[str, ParamSpec]:
    p = {
        "router": ParamSpec((d_model, n_experts), ("embed", None),
                            dtype="float32"),
    }
    if mlp == "swiglu":
        p["w_gate"] = ParamSpec((n_experts, d_model, d_ff),
                                ("experts", "embed", "ff"), dtype=dtype)
        p["w_up"] = ParamSpec((n_experts, d_model, d_ff),
                              ("experts", "embed", "ff"), dtype=dtype)
        p["w_down"] = ParamSpec((n_experts, d_ff, d_model),
                                ("experts", "ff", "embed"), dtype=dtype,
                                init="scaled")
    else:
        p["w_in"] = ParamSpec((n_experts, d_model, d_ff),
                              ("experts", "embed", "ff"), dtype=dtype)
        p["w_out"] = ParamSpec((n_experts, d_ff, d_model),
                               ("experts", "ff", "embed"), dtype=dtype,
                               init="scaled")
    if shared_expert:
        p["shared_w_gate"] = ParamSpec((d_model, d_ff), ("embed", "ff"),
                                       dtype=dtype)
        p["shared_w_up"] = ParamSpec((d_model, d_ff), ("embed", "ff"),
                                     dtype=dtype)
        p["shared_w_down"] = ParamSpec((d_ff, d_model), ("ff", "embed"),
                                       dtype=dtype, init="scaled")
    return p


def one_hot(idx, n: int, dtype):
    """``jax.nn.one_hot``: an index outside [0, n) is a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def stable_top_k(x, k: int):
    """``jax.lax.top_k`` over the last axis: ties go to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@dataclasses.dataclass
class Routing:
    """One S-chunk's routing: ``probs`` [B,S,E] f32, ``gate_vals`` /
    ``sel`` / ``pos`` / ``keep`` [B,S,k], ``dispatch`` / ``combine``
    [B,S,E,C] in the activations' dtype, ``aux`` (scalar f32)."""
    probs: torch.Tensor
    gate_vals: torch.Tensor
    sel: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    dispatch: torch.Tensor
    combine: torch.Tensor
    aux: torch.Tensor


def route(router, x, *, top_k: int, capacity_factor: float) -> Routing:
    """Routing of x [B, S, D] (one chunk) over ``router`` [D, E]."""
    B, S, D = x.shape
    E = router.shape[1]
    C = max(int(math.ceil(S * top_k / E * capacity_factor)), 1)

    logits = x.to(F32) @ router.to(F32)
    probs = torch.softmax(logits, dim=-1)                      # [B,S,E]
    gate_vals, sel = stable_top_k(probs, top_k)                # [B,S,k]

    # Switch load-balance loss: E * sum_e f_e * p_e
    density = one_hot(sel[..., 0], E, F32).mean(dim=(0, 1))
    p_mean = probs.mean(dim=(0, 1))
    aux = E * (density * p_mean).sum()

    # position of each (token, k-slot) within its expert's capacity buffer
    onehot = one_hot(sel, E, torch.int32)                      # [B,S,k,E]
    flat = onehot.reshape(B, S * top_k, E)
    pos = torch.cumsum(flat, dim=1, dtype=torch.int32) - 1     # [B,S*k,E]
    pos = (pos.reshape(B, S, top_k, E) * onehot).sum(-1, dtype=torch.int32)
    keep = pos < C

    # dispatch [B,S,E,C]: one-hot over expert and slot (an overflowed slot
    # maps to C, whose one-hot row is zero -> the token is dropped)
    slot_oh = one_hot(torch.where(keep, pos, C), C, x.dtype)   # [B,S,k,C]
    exp_oh = one_hot(sel, E, x.dtype)                          # [B,S,k,E]
    dispatch = torch.einsum("bske,bskc->bsec", exp_oh, slot_oh)
    combine = torch.einsum("bske,bskc->bsec",
                           exp_oh * gate_vals.to(x.dtype)[..., None], slot_oh)
    return Routing(probs, gate_vals, sel, pos, keep, dispatch, combine, aux)


class _Dense(torch.autograd.Function):
    """The identity, its result and its grad each made contiguous."""

    @staticmethod
    def forward(ctx, h):
        return h.contiguous()

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _dense(h):
    """``h`` as it is, or, for a DTensor, with a contiguous layout, its
    grad in the backward pass too.

    Where DTensor runs the up-projections by gathering the batch (FSDP
    weights that outweigh the activations, as at Maverick's full width),
    each rank's shard of ``h`` is laid out batch-major while the DTensor's
    global strides say expert-major.  The down-projection's ``einsum``
    permutes to (e, b, c, f) and merges (b, c): a view by the global
    strides, which the local shard cannot take.  A contiguous copy makes
    the two layouts agree.  The grad of ``h`` that the down-projection's
    backward pass gives comes back batch-major too where the experts shard
    over "data" (``MOE_EP_RULES``, in 4 microbatches at Maverick's full
    width), and the up-projections' backward merges it the same way.  The
    one-device path keeps its ops."""
    return _Dense.apply(h) if isinstance(h, DTensor) else h


def moe_apply(w, x, *, top_k: int, capacity_factor: float,
              mlp: str, seq_chunk: int = 4096) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """x: [B, S, D] -> ([B, S, D], aux_loss scalar).

    Long sequences are processed in S-chunks (capacity per chunk, standard
    for capacity-based MoE), when S > seq_chunk and S is a multiple of it;
    the aux loss is then the chunks' mean.
    """
    B, S, D = x.shape
    if S > seq_chunk and S % seq_chunk == 0:
        nc = S // seq_chunk
        outs, aux = [], torch.zeros((), dtype=F32, device=x.device)
        for c in range(nc):
            yc, a = moe_apply(w, x[:, c * seq_chunk:(c + 1) * seq_chunk],
                              top_k=top_k, capacity_factor=capacity_factor,
                              mlp=mlp, seq_chunk=seq_chunk)
            outs.append(yc)
            aux = aux + a
        return torch.cat(outs, dim=1), aux / nc
    r = route(w["router"], x, top_k=top_k, capacity_factor=capacity_factor)

    xe = torch.einsum("bsec,bsd->becd", r.dispatch, x)         # [B,E,C,D]
    if mlp == "swiglu":
        g = torch.einsum("becd,edf->becf", xe, w["w_gate"])
        u = torch.einsum("becd,edf->becf", xe, w["w_up"])
        h = F.silu(g.to(F32)).to(x.dtype) * u
        ye = torch.einsum("becf,efd->becd", _dense(h), w["w_down"])
    else:
        h = torch.einsum("becd,edf->becf", xe, w["w_in"])
        h = torch.relu(h.to(F32)).square().to(x.dtype)
        ye = torch.einsum("becf,efd->becd", _dense(h), w["w_out"])
    out = torch.einsum("bsec,becd->bsd", r.combine, ye)

    if "shared_w_gate" in w:
        g = x @ w["shared_w_gate"]
        u = x @ w["shared_w_up"]
        h = F.silu(g.to(F32)).to(x.dtype) * u
        out = out + h @ w["shared_w_down"]
    return out, r.aux
