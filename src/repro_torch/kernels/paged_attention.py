"""Decode attention on the card: launch wrapper of ``csrc/paged_attention.cu``.

Replaces the JAX package's Pallas kernel ``kernels/paged_attention.py::
paged_attention_kernel``.  Takes the kernel-native layout (``q [B, KH, G,
Dh]``, pools ``[KH, P, bs, Dh]``); :func:`repro_torch.kernels.ops.
paged_attention` adapts the public ``[B, H, Dh]`` layout and takes the
plain version (``ref.paged_attention_ref``) for CPU tensors.
"""
from __future__ import annotations

import ctypes
from fractions import Fraction

import torch

from . import build

launches = 0    # calls since the last reset (ops.reset_launches)

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_HEAD_DIM = 256        # head dims: multiples of 16 up to this
# a call aims for 8/3 of the CTAs an SM holds at once (8 at head dims up to
# 64, where 3 are resident; 16/3 at 128, where 2 are): near the best of 7
# to 17 splits at both served widths (PERF.md).  The chunks past a short
# sequence's end have no work, so this is well above one wave.
WAVES = Fraction(8, 3)
MAX_GROUP = 8             # query rows per CTA (csrc kMaxGroup)
MAX_SPLITS = 512          # splits of a sequence (csrc kMaxSplits)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention: {msg}")


def ctas_per_sm(dtype: torch.dtype, head_dim: int) -> int:
    """CTAs of the kernel resident per SM on an H100.  The tensor-core
    kernel's (bf16, f16) are set by its shared-memory ring: 64, 96 and
    128 KB on the instances of head dim 64, 128 and 256 give 3, 2 and 1
    (``chip_smoke.py`` holds them to the card's occupancy query).  The
    f32 kernel's are set by its registers; 3, as at G = 5 and Dh 128,
    stands for every f32 call."""
    if dtype == torch.float32 or head_dim <= 64:
        return 3
    return 2 if head_dim <= 128 else 1


def num_splits(batch: int, kv_heads: int, group: int, n_blocks: int,
               sm_count: int, resident: int) -> int:
    """KV splits per (sequence, KV head): enough that the kernel has about
    ``WAVES * resident * sm_count`` CTAs, at most one split per block and
    ``MAX_SPLITS``.  Depends on the shapes and the card alone, never on
    ``lengths``."""
    ctas = batch * kv_heads * -(-group // MAX_GROUP)
    # ceil(WAVES * resident * sm_count / ctas) in integers (a Fraction's
    # arithmetic would cost an eager call microseconds)
    num = WAVES.numerator * resident * sm_count
    den = max(ctas, 1) * WAVES.denominator
    return max(1, min(n_blocks, MAX_SPLITS, -(-num // den)))


def check_args(q, k_pool, v_pool, tables, lengths) -> None:
    """Raise ``ValueError`` on anything the kernel does not take (the
    plain version is held to the same rules, so both routes accept the
    same calls).

    The kernel's domain: float32, bfloat16 or float16 (q and both pools
    alike); a head dim that is a multiple of 16 up to 256; any block size
    of at least 1; int32 tables and lengths; contiguous tensors, the
    pools on 16-byte boundaries.  float64 and other head dims are
    refused."""
    tensors = (q, k_pool, v_pool, tables, lengths)
    _check(all(t.device == q.device for t in tensors),
           f"tensors lie on different devices: {[str(t.device) for t in tensors]}")
    _check(q.dtype in DTYPES,
           f"q must be float32, bfloat16 or float16, got {q.dtype}")
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
    _check(0 < Dh <= MAX_HEAD_DIM and Dh % 16 == 0,
           f"head_dim must be a multiple of 16 up to {MAX_HEAD_DIM}, got {Dh}")
    _check(bs > 0, f"block size must be at least 1, got {bs}")
    _check(P > 0, "the pools hold no block")
    _check(tables.dim() == 2 and tables.shape[0] == B and tables.shape[1] > 0,
           f"tables must be [B, NB] with NB > 0, got {tuple(tables.shape)}")
    _check(tuple(lengths.shape) == (B,),
           f"lengths must be [B], got {tuple(lengths.shape)}")
    _check(tables.shape[1] * bs < 2**31 and KH * P * bs < 2**31,
           "NB * bs and the pools' rows KH * P * bs must fit in int32")
    _check(all(t.is_contiguous() for t in tensors), "needs contiguous tensors")
    _check(k_pool.data_ptr() % 16 == 0 and v_pool.data_ptr() % 16 == 0,
           "the pools must start on a 16-byte boundary")


# per (device, stream, graph capture): one arrival counter per (sequence,
# KV head, group chunk), which every call leaves at 0.  Calls on one stream
# run one after another, so they can share them; calls on two streams, or
# in two captured graphs, never do.  A buffer made during a capture is
# zeroed by that graph's replay, which no other graph runs.  A grown buffer
# replaces the old one, which is kept: a graph captured with it may still
# be replayed.
_arrivals: dict = {}
_retired: list = []
_sm_counts: dict = {}     # device index -> SMs


def _arrival_counters(lib, device: torch.device, stream: int,
                      n: int) -> torch.Tensor:
    capture = None
    if torch.cuda.is_current_stream_capturing():
        capture = ctypes.c_ulonglong(0)
        build.check_launch("paged_attention_capture_id",
                           lib.paged_attention_capture_id(
                               stream, ctypes.byref(capture)))
        capture = capture.value
    key = (device.index, stream, capture)
    buf = _arrivals.get(key)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _retired.append(buf)
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _arrivals[key] = buf
    return buf


def paged_attention_cuda(q, k_pool, v_pool, tables, lengths):
    """``q [B, KH, G, Dh]``, pools ``[KH, P, bs, Dh]``, ``tables i32[B,
    NB]``, ``lengths i32[B]`` -> ``[B, KH, G, Dh]`` on the tensors' CUDA
    device.  Raises on anything the kernel does not take.  One launch per
    call: the last CTA of each sequence and KV head to finish merges the
    splits, counted on arrival counters of the current stream (and graph
    capture), so calls on different streams may run at once.  Like any
    graph with a workspace, one captured graph must not be replayed on two
    streams at once."""
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
    sm_count = _sm_counts.get(q.device.index)
    if sm_count is None:
        sm_count = torch.cuda.get_device_properties(
            q.device).multi_processor_count
        _sm_counts[q.device.index] = sm_count
    splits = num_splits(B, KH, G, NB, sm_count, ctas_per_sm(q.dtype, Dh))
    ws = torch.empty(B * KH * splits * G * (Dh + 2), dtype=torch.float32,
                     device=q.device)
    lib = build.build().lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        arrivals = _arrival_counters(lib, q.device, stream,
                                     B * KH * -(-G // MAX_GROUP))
        err = lib.paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            ws.data_ptr(), arrivals.data_ptr(), DTYPES[q.dtype], B, KH, G,
            Dh, P, bs, NB, splits, stream)
    build.check_launch("paged_attention", err)
    launches += 1
    return out


def occupancy(dtype: torch.dtype, head_dim: int,
              device: torch.device) -> int:
    """CTAs of the tensor-core kernel resident per SM on the CUDA
    ``device`` at this head dim, by the card's occupancy query (what
    :func:`ctas_per_sm` is checked against)."""
    _check(dtype in (torch.bfloat16, torch.float16),
           f"the tensor-core kernel takes bfloat16 or float16, got {dtype}")
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = build.build().lib.paged_attention_occupancy(
            DTYPES[dtype], head_dim, ctypes.byref(n))
    build.check_launch("paged_attention_occupancy", err)
    return n.value
