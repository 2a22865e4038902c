"""Mamba (S6) block for the Jamba hybrid architecture (twin of the JAX
package's ``models/mamba.py``).

Selective state-space layer: input-dependent (dt, B, C) with diagonal decay
``exp(dt * A)``.  The sequence recurrence runs chunk by chunk (the
projections, conv and gating on [B, chunk, ...] slabs, the recurrence a
loop over the chunk's steps), carrying the (SSM state, conv tail) pair.
Decode carries the (conv window, SSM state) pair: O(1) memory per token.
``softplus`` and the recurrence run in f32, as in the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .modules import ParamSpec, remat

F32 = torch.float32


def mamba_param_specs(d_model: int, d_state: int, d_conv: int, expand: int,
                      dtype: str) -> Dict[str, ParamSpec]:
    di = expand * d_model
    dt_rank = max(math.ceil(d_model / 16), 1)
    return {
        "in_proj": ParamSpec((d_model, 2 * di), ("embed", "inner2"),
                             dtype=dtype),
        "conv_w": ParamSpec((d_conv, di), (None, "inner"), dtype=dtype),
        "conv_b": ParamSpec((di,), ("inner",), dtype=dtype, init="zeros"),
        "x_proj": ParamSpec((di, dt_rank + 2 * d_state), ("inner", None),
                            dtype=dtype),
        "dt_proj": ParamSpec((dt_rank, di), (None, "inner"), dtype=dtype),
        "dt_bias": ParamSpec((di,), ("inner",), dtype="float32", init="zeros"),
        "A_log": ParamSpec((di, d_state), ("inner", None), dtype="float32",
                           init="ones"),
        "D": ParamSpec((di,), ("inner",), dtype="float32", init="ones"),
        "out_proj": ParamSpec((di, d_model), ("inner", "embed"), dtype=dtype,
                              init="scaled"),
    }


def _selective(w, xs_conv):
    """dt (softplus, f32), B, C (f32) and A = -exp(A_log)."""
    dt_rank = w["dt_proj"].shape[0]
    d_state = w["A_log"].shape[1]
    x_dbl = (xs_conv @ w["x_proj"]).to(F32)
    dt, Bs, Cs = torch.split(x_dbl, [dt_rank, d_state, d_state], dim=-1)
    dt = F.softplus(dt @ w["dt_proj"].to(F32) + w["dt_bias"])
    A = -torch.exp(w["A_log"])                            # [di, ds]
    return dt, Bs, Cs, A


def _conv_taps(window, conv_w, conv_b, n: int):
    """The depthwise causal conv's K taps over ``window`` [B, K-1+n, di],
    summed left to right in the activations' dtype, then SiLU in f32."""
    K = conv_w.shape[0]
    out = window[:, 0:n, :] * conv_w[0]
    for i in range(1, K):
        out = out + window[:, i:i + n, :] * conv_w[i]
    return F.silu((out + conv_b).to(F32)).to(window.dtype)


def causal_conv(xs, conv_w, conv_b):
    """Depthwise causal conv over time: xs [B,S,di], conv_w [K,di]."""
    K = conv_w.shape[0]
    pad = F.pad(xs, (0, 0, K - 1, 0))
    return _conv_taps(pad, conv_w, conv_b, xs.shape[1])


def _chunk_body(w, h, tail, x_c):
    """One chunk: x_c [B, chunk, D], carrying (h [B, di, ds] f32, tail
    [B, K-1, di]); returns (h, tail, out_c [B, chunk, D])."""
    chunk = x_c.shape[1]
    xs, z = torch.chunk(x_c @ w["in_proj"], 2, dim=-1)
    window = torch.cat([tail, xs], dim=1)                 # [B,K-1+chunk,di]
    conv = _conv_taps(window, w["conv_w"], w["conv_b"], chunk)
    dt, Bs, Cs, A = _selective(w, conv)
    conv32 = conv.to(F32)
    dA = torch.exp(dt[..., None] * A)                     # [B,chunk,di,ds]
    dBx = dt[..., None] * Bs[:, :, None, :] * conv32[..., None]
    ys = []
    for t in range(chunk):
        h = dA[:, t] * h + dBx[:, t]
        ys.append(torch.einsum("bis,bs->bi", h, Cs[:, t]).to(x_c.dtype))
    y = torch.stack(ys, dim=1).to(F32)                    # [B,chunk,di]
    y = (y + w["D"] * conv32) * F.silu(z.to(F32))
    return h, window[:, chunk:], y.to(x_c.dtype) @ w["out_proj"]


def mamba_apply(w, x, *, chunk: int = 512):
    """Training/prefill forward: x [B, S, D] -> [B, S, D].

    The entire layer (projections, conv, selective scan, gating, output
    projection) is chunked over S, carrying the (SSM state, conv tail)
    pair from chunk to chunk; under autograd each chunk body is
    rematerialized, as the reference's.
    """
    B, S, D = x.shape
    di = w["dt_proj"].shape[1]
    d_state = w["A_log"].shape[1]
    K = w["conv_w"].shape[0]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk {chunk}")
    h = torch.zeros((B, di, d_state), dtype=F32, device=x.device)
    tail = torch.zeros((B, K - 1, di), dtype=x.dtype, device=x.device)
    outs = []
    for c in range(S // chunk):
        h, tail, out = remat(_chunk_body, w, h, tail,
                             x[:, c * chunk:(c + 1) * chunk])
        outs.append(out)
    return torch.cat(outs, dim=1)


def mamba_decode_init(w, batch: int):
    di = w["dt_proj"].shape[1]
    d_state = w["A_log"].shape[1]
    K = w["conv_w"].shape[0]
    dev = w["in_proj"].device
    return {"conv": torch.zeros((batch, K - 1, di), dtype=w["in_proj"].dtype,
                                device=dev),
            "ssm": torch.zeros((batch, di, d_state), dtype=F32, device=dev)}


def mamba_decode(w, state: Dict, x) -> Tuple[Dict, torch.Tensor]:
    """One-token decode: x [B, D] -> (new_state, y [B, D])."""
    xs, z = torch.chunk(x @ w["in_proj"], 2, dim=-1)      # [B,di] each
    window = torch.cat([state["conv"].to(xs.dtype), xs[:, None, :]], dim=1)
    conv = _conv_taps(window, w["conv_w"], w["conv_b"], 1)[:, 0]
    dt, Bs, Cs, A = _selective(w, conv)
    dA = torch.exp(dt[..., None] * A)
    h = dA * state["ssm"] + dt[..., None] * Bs[:, None, :] \
        * conv.to(F32)[..., None]
    y = torch.einsum("bis,bs->bi", h, Cs)
    y = (y + w["D"] * conv.to(F32)) * F.silu(z.to(F32))
    out = y.to(x.dtype) @ w["out_proj"]
    return {"conv": window[:, 1:], "ssm": h}, out
