"""An event-free segment of the time-blocked engine on the card: launch
wrapper of ``csrc/fast_window.cu``.

No Pallas original: replaces the JAX package's
``core/sim.py::_build_fast_window`` (its tile precompute and its inner
``lax.scan``) but for the per-row f32 sums over threads, which the caller
takes.  Callers go through :func:`repro_torch.kernels.ops.fast_window`,
which checks the arguments and takes the plain version
(``ref.fast_window_ref``) for CPU tensors.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build, ref

launches = 0    # kernel launches since the last reset (ops.reset_launches)


def fast_window_cuda(va, is_write, thr, oom_killed, nodes, lat, caches, acc,
                     counters, hot, row_counts, now0: int, map_shift: int,
                     radix_bits: int, thp: bool, costs):
    """Launch the segment on the tensors' CUDA device (arguments checked by
    ``ops``); updates the state in place and returns ``cum f32[L, R, 4,
    T]``, allocated here."""
    global launches
    L, R, T = va.shape
    cum = torch.empty((L, R, 4, T), dtype=torch.float32, device=va.device)
    if L * R * T == 0:
        return cum
    tags, lru = zip(*caches)
    ptrs = [va, is_write, thr, oom_killed, *nodes, *lat, *tags, *lru, *acc,
            *counters, *hot, *row_counts, cum]
    magic = [ref.set_magic(t.shape[2]) for t in tags]
    ints = [L, R, T, int(now0), int(map_shift), int(radix_bits), int(thp),
            *(n.shape[1] for n in nodes), lat[0].shape[0],
            *(t.shape[2] for t in tags), *(t.shape[3] for t in tags),
            *(m for m, _ in magic), *(s for _, s in magic),
            *row_counts[0].stride()]
    lib = build.build().lib
    with torch.cuda.device(va.device):
        err = lib.fast_window_launch(
            (ctypes.c_uint64 * len(ptrs))(*(t.data_ptr() for t in ptrs)),
            (ctypes.c_longlong * len(ints))(*ints),
            (ctypes.c_float * 4)(*(float(np.float32(c)) for c in costs)),
            torch.cuda.current_stream().cuda_stream)
    build.check_launch("fast_window", err)
    launches += 1
    return cum
