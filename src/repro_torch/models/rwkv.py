"""RWKV6 ("Finch") blocks: time-mix with data-dependent decay + channel-mix
(twin of the JAX package's ``models/rwkv.py``).

Attention-free: the per-head state is a fixed [64, 64] outer-product
accumulator with an input-dependent diagonal decay
``w_t = exp(-exp(w0 + tanh(x W_A) W_B))``, so both the parallel path (a
loop over steps) and decode (O(1) state) never hold a KV cache.

As in the reference, token-shift mixing uses static per-channel lerp
weights, and the parallel path rounds each step's output to bfloat16
(whatever the model's dtype) before the group norm; decode does not.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from .modules import ParamSpec, merge_heads, on_shards, remat, split_heads

F32 = torch.float32
HEAD = 64  # RWKV6 fixed head size
DECAY_RANK = 64
YS_DTYPE = torch.bfloat16  # the parallel path's step outputs, as the reference's ys


def rwkv_time_mix_specs(d_model: int, dtype: str) -> Dict[str, ParamSpec]:
    d = d_model
    return {
        "mu_r": ParamSpec((d,), ("embed",), dtype="float32", init="zeros"),
        "mu_k": ParamSpec((d,), ("embed",), dtype="float32", init="zeros"),
        "mu_v": ParamSpec((d,), ("embed",), dtype="float32", init="zeros"),
        "mu_w": ParamSpec((d,), ("embed",), dtype="float32", init="zeros"),
        "mu_g": ParamSpec((d,), ("embed",), dtype="float32", init="zeros"),
        "w_r": ParamSpec((d, d), ("embed", "heads_mm"), dtype=dtype),
        "w_k": ParamSpec((d, d), ("embed", "heads_mm"), dtype=dtype),
        "w_v": ParamSpec((d, d), ("embed", "heads_mm"), dtype=dtype),
        "w_g": ParamSpec((d, d), ("embed", "heads_mm"), dtype=dtype),
        "w_o": ParamSpec((d, d), ("heads_mm", "embed"), dtype=dtype,
                         init="scaled"),
        "decay_base": ParamSpec((d,), ("embed",), dtype="float32",
                                init="ones"),
        "decay_A": ParamSpec((d, DECAY_RANK), ("embed", None),
                             dtype="float32"),
        "decay_B": ParamSpec((DECAY_RANK, d), (None, "embed"),
                             dtype="float32"),
        "bonus_u": ParamSpec((d,), ("embed",), dtype="float32",
                             init="zeros"),
        "ln_scale": ParamSpec((d,), ("embed",), dtype="float32", init="ones"),
    }


def rwkv_channel_mix_specs(d_model: int, d_ff: int,
                           dtype: str) -> Dict[str, ParamSpec]:
    return {
        "mu_k": ParamSpec((d_model,), ("embed",), dtype="float32",
                          init="zeros"),
        "mu_r": ParamSpec((d_model,), ("embed",), dtype="float32",
                          init="zeros"),
        "w_kk": ParamSpec((d_model, d_ff), ("embed", "ff"), dtype=dtype),
        "w_vv": ParamSpec((d_ff, d_model), ("ff", "embed"), dtype=dtype,
                          init="scaled"),
        "w_rr": ParamSpec((d_model, d_model), ("embed", "embed_out"),
                          dtype=dtype),
    }


def _shift(x):
    """Token shift: x[:, t] -> x[:, t-1] with zero at t=0."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1, :]


def _lerp(x, xx, mu):
    return (x.to(F32) + (xx - x).to(F32) * mu).to(x.dtype)


def _decay(w, mixed_w):
    lo = torch.tanh(mixed_w.to(F32) @ w["decay_A"])
    lo = lo @ w["decay_B"]
    return torch.exp(-torch.exp(w["decay_base"] + lo))  # [B,S,d] in (0,1)


def _mix_inputs(w, x, xx):
    """r, k, v, the gate g (f32) and the decay from x and its shift."""
    r = _lerp(x, xx, w["mu_r"]) @ w["w_r"]
    k = _lerp(x, xx, w["mu_k"]) @ w["w_k"]
    v = _lerp(x, xx, w["mu_v"]) @ w["w_v"]
    g = F.silu((_lerp(x, xx, w["mu_g"]) @ w["w_g"]).to(F32))
    return r, k, v, g, _decay(w, _lerp(x, xx, w["mu_w"]))


def _group_norm_out(w, y, g, dtype):
    """Per-head group norm of y [..., H, 64] (f32), then gate and project."""
    mu = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, unbiased=False)
    y = merge_heads((y - mu) * torch.rsqrt(var + 1e-5))
    y = y * w["ln_scale"] * g
    return y.to(dtype) @ w["w_o"]


def _chunk_body(u, st, rh, kh, vh, wh):
    """One chunk of steps: r/k/v/decay [B, chunk, H, 64] (f32), the state
    st [B, H, 64, 64]; returns (st, ys [B, chunk, H, 64] in YS_DTYPE).
    DTensors (the mesh path) run it on each rank's batch and head
    shards."""
    if isinstance(rh, DTensor):
        return on_shards(_chunk_body, rh, (u, st, rh, kh, vh, wh),
                         ({2: 0}, {0: 0, 2: 1}) + ({0: 0, 2: 2},) * 4,
                         ({0: 0, 2: 1}, {0: 0, 2: 2}))
    ys = []
    for t in range(rh.shape[1]):
        kv = kh[:, t, :, :, None] * vh[:, t, :, None, :]  # [B,H,64,64]
        y = torch.einsum("bhk,bhkv->bhv", rh[:, t], st + u[..., :, None] * kv)
        st = wh[:, t, :, :, None] * st + kv
        ys.append(y.to(YS_DTYPE))
    return st, torch.stack(ys, dim=1)


def time_mix_apply(w, x, *, chunk: int = 256):
    """x: [B, S, D] -> [B, S, D] (training / prefill).  ``chunk`` is the
    reference's scan chunk (S must be a multiple of it, or smaller); under
    autograd each chunk of steps is rematerialized, as the reference's."""
    B, S, D = x.shape
    H = D // HEAD
    r, k, v, g, decay = _mix_inputs(w, x, _shift(x))
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk {chunk}")

    rh = split_heads(r, H, HEAD, H).to(F32)
    kh = split_heads(k, H, HEAD, H).to(F32)
    vh = split_heads(v, H, HEAD, H).to(F32)
    wh = split_heads(decay, H, HEAD, H)
    u = split_heads(w["bonus_u"], H, HEAD, H)
    st = torch.zeros((B, H, HEAD, HEAD), dtype=F32, device=x.device)
    ys = []
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        st, y = remat(_chunk_body, u, st, rh[:, sl], kh[:, sl], vh[:, sl],
                      wh[:, sl])
        ys.append(y)
    y = torch.cat(ys, dim=1).to(F32)                      # [B,S,H,64]
    return _group_norm_out(w, y, g, x.dtype)


def time_mix_decode(w, state, x_prev, x):
    """One token: x [B, D]; state [B, H, 64, 64]; x_prev [B, D] (shift).
    Returns (new state, y [B, D])."""
    B, D = x.shape
    H = D // HEAD
    r, k, v, g, decay = _mix_inputs(w, x, x_prev.to(x.dtype))
    rh = split_heads(r, H, HEAD, H).to(F32)
    kh = split_heads(k, H, HEAD, H).to(F32)
    vh = split_heads(v, H, HEAD, H).to(F32)
    wh = split_heads(decay, H, HEAD, H)
    u = split_heads(w["bonus_u"], H, HEAD, H)
    kv = kh[..., :, None] * vh[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", rh, state + u[..., :, None] * kv)
    state = wh[..., :, None] * state + kv
    return state, _group_norm_out(w, y, g, x.dtype)


def _channel_mix(w, x, xx):
    k = _lerp(x, xx, w["mu_k"]) @ w["w_kk"]
    k = torch.relu(k.to(F32)).square().to(x.dtype)
    v = k @ w["w_vv"]
    rr = torch.sigmoid((_lerp(x, xx, w["mu_r"]) @ w["w_rr"]).to(F32))
    return (rr * v.to(F32)).to(x.dtype)


def channel_mix_apply(w, x):
    return _channel_mix(w, x, _shift(x))


def channel_mix_decode(w, x_prev, x):
    """One token: x, x_prev [B, D] -> [B, D]."""
    return _channel_mix(w, x, x_prev.to(x.dtype))
