"""Transformer building blocks: norms, RoPE/M-RoPE, GQA attention, MLPs
(twin of the JAX package's ``models/layers.py``, same names and order of
operations).

Attention comes in three flavors:

  * ``chunked_attention`` — flash-style online softmax over query and
    key/value chunks, a running (max, denom, acc) in f32.  Live
    intermediates stay at [B, Cq, KH, G, Ck] instead of [B, S, H, S].
    Block-causal masking computes masked blocks and discards them, as the
    reference does; masked scores are ``NEG_INF`` (finite), so a row whose
    every score is masked comes out as the uniform mean of V, not NaN.
  * ``decode_attention`` — one new token against a [B, S, KH, Dh] cache.
  * the paged variant is ``repro_torch.kernels.ops.paged_attention``.

Products that the reference takes with ``preferred_element_type=f32``
upcast both operands to f32 here (exact for bf16 inputs); plain products
stay in the operands' dtype.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from .modules import on_head_shards, remat

F32 = torch.float32
NEG_INF = -1e30


def _softmax_scale(head_dim: int) -> float:
    """``1 / sqrt(Dh)`` rounded as the reference's f32 ops round it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(head_dim)))


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def rms_norm(x, scale, eps=1e-5):
    """The scale multiplies after the cast back to ``x.dtype``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------
def _rope_freqs(head_dim: int, base: float = 10000.0, device=None):
    half = head_dim // 2
    return 1.0 / (base ** (torch.arange(half, dtype=F32, device=device)
                           / half))


def _rotate(x, angles):
    """``angles`` [..., S, 1, half] (f32) rotate the halves of x [..., S,
    H, Dh]; the result is computed in f32 and cast back to ``x.dtype``."""
    half = x.shape[-1] // 2
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, base: float = 10000.0):
    """x: [..., S, H, Dh]; positions: broadcastable to [..., S]."""
    freqs = _rope_freqs(x.shape[-1], base, x.device)          # [half]
    angles = positions[..., None].to(F32) * freqs             # [..., S, half]
    return _rotate(x, angles[..., None, :])


def apply_mrope(x, positions3, sections=(0.25, 0.375, 0.375),
                base: float = 10000.0):
    """Qwen2-VL multimodal RoPE.

    positions3: [..., S, 3] (temporal, height, width position ids).  The
    rotary frequency slots are split into three contiguous sections, each
    rotated by its own position component.
    """
    half = x.shape[-1] // 2
    s0 = int(half * sections[0])
    s1 = int(half * sections[1])
    freqs = _rope_freqs(x.shape[-1], base, x.device)
    slot = torch.arange(half, device=x.device)
    comp = torch.where(slot < s0, 0, torch.where(slot < s0 + s1, 1, 2))
    pos = positions3.to(F32)[..., comp]                       # [..., S, half]
    return _rotate(x, (pos * freqs)[..., None, :])


def sinusoidal_positions(seq_len: int, d_model: int, device=None):
    pos = torch.arange(seq_len, dtype=F32, device=device)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=F32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, dim / d_model)
    pe = torch.zeros((seq_len, d_model), dtype=F32, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
def _kv_step(i: int, j: int, causal: bool, scale: float, q_blk, k_blk,
             v_blk, m, l, acc):
    """One kv chunk of the online softmax: q_blk [B, Cq, KH, G, Dh] (f32),
    k_blk / v_blk [B, Ck, KH, Dh]; returns the new (m, l, acc)."""
    s = torch.einsum("bqkgd,bckd->bqkgc", q_blk,
                     k_blk.to(F32)) * scale               # [B,Cq,KH,G,Ck]
    if causal:
        dev = q_blk.device
        qpos = i * q_blk.shape[1] + torch.arange(q_blk.shape[1], device=dev)
        kpos = j * k_blk.shape[1] + torch.arange(k_blk.shape[1], device=dev)
        mask = qpos[:, None] >= kpos[None, :]
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum(
        "bqkgc,bckd->bqkgd", p.to(v_blk.dtype).to(F32), v_blk.to(F32))
    return m_new, l, acc


def _q_step(i: int, causal: bool, q_blk, kr, vr):
    """All kv chunks for q chunk ``i`` (q_blk [B, Cq, KH, G, Dh]); each kv
    step rematerialized, as the reference's."""
    B, Cq, KH, G, Dh = q_blk.shape
    dev = q_blk.device
    scale = _softmax_scale(Dh)
    q_blk = q_blk.to(F32)
    m = torch.full((B, Cq, KH, G), NEG_INF, dtype=F32, device=dev)
    l = torch.zeros((B, Cq, KH, G), dtype=F32, device=dev)
    acc = torch.zeros((B, Cq, KH, G, Dh), dtype=F32, device=dev)
    for j in range(kr.shape[1]):
        m, l, acc = remat(functools.partial(_kv_step, i, j, causal, scale),
                          q_blk, kr[:, j], vr[:, j], m, l, acc)
    return acc / torch.clamp(l[..., None], min=1e-30)


def chunked_attention(q, k, v, *, causal: bool, q_chunk: int = 512,
                      kv_chunk: int = 512):
    """Flash-style online-softmax attention.

    q: [B, S, H, Dh]; k, v: [B, S, KH, Dh] with H a multiple of KH (GQA).
    Returns [B, S, H, Dh].  A Python loop over q chunks and, inside it,
    kv chunks takes the place of the reference's two ``lax.scan``s; under
    autograd both bodies are rematerialized, as the reference's "double
    remat" (the backward keeps only each step's inputs, never the
    [Cq, Ck] probabilities of every chunk pair).  DTensors (the mesh
    path) run it on each rank's batch and head shards.
    """
    if isinstance(q, DTensor):
        return on_head_shards(functools.partial(
            chunked_attention, causal=causal, q_chunk=q_chunk,
            kv_chunk=kv_chunk), q, k, v, k.shape[2])
    B, S, H, Dh = q.shape
    KH = k.shape[2]
    G = H // KH
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, S)
    if S % q_chunk or S % kv_chunk:
        raise ValueError(f"S={S} is not a multiple of the chunks "
                         f"({q_chunk}, {kv_chunk})")
    nq, nk = S // q_chunk, S // kv_chunk
    qr = q.reshape(B, nq, q_chunk, KH, G, Dh)
    kr = k.reshape(B, nk, kv_chunk, KH, Dh)
    vr = v.reshape(B, nk, kv_chunk, KH, Dh)
    outs = [remat(functools.partial(_q_step, i, causal), qr[:, i], kr, vr)
            .to(q.dtype) for i in range(nq)]
    return torch.stack(outs, dim=1).reshape(B, S, H, Dh)


def decode_attention(q, k_cache, v_cache, length=None):
    """One-token attention: q [B, H, Dh]; caches [B, S, KH, Dh].

    ``length``: optional [B] valid-length mask (entries >= length ignored).
    An f8 cache is dequantized to ``q.dtype`` first, as in the reference.
    """
    B, H, Dh = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    if k_cache.element_size() == 1:     # f8 quantized cache: dequant here
        k_cache = k_cache.to(q.dtype)
        v_cache = v_cache.to(q.dtype)
    qr = q.reshape(B, KH, G, Dh)
    s = torch.einsum("bkgd,bskd->bkgs", qr.to(F32), k_cache.to(F32)) \
        * _softmax_scale(Dh)
    if length is not None:
        mask = torch.arange(S, device=q.device)[None, :] < length[:, None]
        s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).to(F32),
                       v_cache.to(F32))
    return out.reshape(B, H, Dh).to(q.dtype)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------
def mlp_apply(kind: str, x, w):
    """w: dict of the MLP's weights (``model.param_specs``).  ``gelu`` is the
    tanh approximation (``jax.nn.gelu``'s default)."""
    if kind == "swiglu":
        g = x @ w["w_gate"]
        u = x @ w["w_up"]
        h = F.silu(g.float()).to(x.dtype) * u
        return h @ w["w_down"]
    if kind == "squared_relu":
        h = x @ w["w_in"]
        h = torch.relu(h.float()).square().to(x.dtype)
        return h @ w["w_out"]
    if kind == "gelu":
        h = x @ w["w_in"] + w["b_in"]
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        return h @ w["w_out"] + w["b_out"]
    raise ValueError(kind)
