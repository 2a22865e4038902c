"""Decode attention on the card: launch wrapper of ``csrc/paged_attention.cu``.

Replaces the JAX package's Pallas kernel ``kernels/paged_attention.py::
paged_attention_kernel``.  Takes the kernel-native layout (``q [B, KH, G,
Dh]``, pools ``[KH, P, bs, Dh]``); :func:`repro_torch.kernels.ops.
paged_attention` adapts the public ``[B, H, Dh]`` layout and takes the
plain version (``ref.paged_attention_ref``) for CPU tensors.
"""
from __future__ import annotations

import torch

from . import build

launches = 0    # calls since the last reset (ops.reset_launches); each
                # call launches the partial and the combine kernel

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)
# partial-kernel CTAs to aim for per SM; the chunks past a short
# sequence's end have no work, so this is well above one (PERF.md)
CTAS_PER_SM = 8
MAX_GROUP = 8             # query rows per CTA (csrc kMaxGroup)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention: {msg}")


def num_splits(batch: int, kv_heads: int, group: int, n_blocks: int,
               sm_count: int) -> int:
    """KV splits per (sequence, KV head): enough that the partial kernel
    has about ``CTAS_PER_SM * sm_count`` CTAs, at most one split per
    block.  Depends on the shapes and the card alone, never on
    ``lengths``."""
    ctas = batch * kv_heads * -(-group // MAX_GROUP)
    return max(1, min(n_blocks, -(-CTAS_PER_SM * sm_count // max(ctas, 1))))


def check_args(q, k_pool, v_pool, tables, lengths) -> None:
    """Raise ``ValueError`` on anything the kernel does not take (the
    plain version is held to the same rules, so both routes accept the
    same calls)."""
    tensors = (q, k_pool, v_pool, tables, lengths)
    _check(all(t.device == q.device for t in tensors),
           f"tensors lie on different devices: {[str(t.device) for t in tensors]}")
    _check(q.dtype in DTYPES, f"q must be float32 or bfloat16, got {q.dtype}")
    _check(k_pool.dtype == v_pool.dtype == q.dtype,
           f"q and the pools differ in dtype: {q.dtype}, {k_pool.dtype}, "
           f"{v_pool.dtype}")
    _check(tables.dtype == lengths.dtype == torch.int32,
           "tables and lengths must be int32")
    _check(q.dim() == 4 and k_pool.dim() == 4, "q must be [B, KH, G, Dh] and "
           "the pools [KH, P, bs, Dh]")
    B, KH, G, Dh = q.shape
    _, P, bs, _ = k_pool.shape
    _check(k_pool.shape == v_pool.shape, "the K and V pools differ in shape")
    _check(k_pool.shape[0] == KH and k_pool.shape[3] == Dh,
           f"pools {tuple(k_pool.shape)} do not match q {tuple(q.shape)}")
    _check(Dh in HEAD_DIMS, f"head_dim must be one of {HEAD_DIMS}, got {Dh}")
    _check(bs > 0 and bs % 8 == 0, f"block size must be a multiple of 8, got {bs}")
    _check(P > 0, "the pools hold no block")
    _check(tables.dim() == 2 and tables.shape[0] == B and tables.shape[1] > 0,
           f"tables must be [B, NB] with NB > 0, got {tuple(tables.shape)}")
    _check(tuple(lengths.shape) == (B,),
           f"lengths must be [B], got {tuple(lengths.shape)}")
    _check(tables.shape[1] * bs < 2**31, "NB * bs must fit in int32")
    _check(all(t.is_contiguous() for t in tensors), "needs contiguous tensors")
    _check(k_pool.data_ptr() % 16 == 0 and v_pool.data_ptr() % 16 == 0,
           "the pools must start on a 16-byte boundary")


def paged_attention_cuda(q, k_pool, v_pool, tables, lengths):
    """``q [B, KH, G, Dh]``, pools ``[KH, P, bs, Dh]``, ``tables i32[B,
    NB]``, ``lengths i32[B]`` -> ``[B, KH, G, Dh]`` on the tensors' CUDA
    device.  Raises on anything the kernel does not take."""
    global launches
    if not torch.cuda.is_available():
        raise RuntimeError("paged_attention_cuda needs CUDA, but "
                           "torch.cuda.is_available() is False")
    _check(q.is_cuda, f"the kernel needs CUDA tensors, got {q.device}")
    check_args(q, k_pool, v_pool, tables, lengths)
    B, KH, G, Dh = q.shape
    _, P, bs, _ = k_pool.shape
    NB = tables.shape[1]
    _check(B < 2**16 and KH * -(-G // MAX_GROUP) < 2**16,
           "B and KH * ceil(G / 8) must be below 65536 (grid limits)")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out                          # nothing to attend, no launch
    sm_count = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits = num_splits(B, KH, G, NB, sm_count)
    workspace = torch.empty(B * KH * splits * G * (Dh + 2),
                            dtype=torch.float32, device=q.device)
    lib = build.build().lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            workspace.data_ptr(), DTYPES[q.dtype], B, KH, G, Dh, P, bs, NB,
            splits, stream)
    build.check_launch("paged_attention", err)
    launches += 1
    return out
