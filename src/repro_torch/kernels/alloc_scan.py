"""The allocator scan on the card: launch wrapper of ``csrc/alloc_scan.cu``.

No Pallas original: replaces the ``lax.scan`` of the JAX package's
``core/alloc.py::alloc_many``.  Callers go through
:func:`repro_torch.kernels.ops.alloc_scan`, which checks the arguments and
takes the plain version (``ref.alloc_scan_ref``) for CPU tensors.

Besides the host count of launches, the kernel adds the chunks of 32
threads that took more than one pass (a node's predicate fell inside them,
so the chunk was replayed from there) to a count kept on each device;
:func:`replays` reads it, a device read, so a caller reads it after a run
and never inside one.
"""
from __future__ import annotations

import torch

from . import build

launches = 0    # kernel launches since the last reset (ops.reset_launches)
chunks = 0      # chunks of 32 threads those launches ran, over every run
_replays: dict = {}     # device -> i64[1], chunks replayed since the reset


def replays() -> int:
    """Chunks the kernel replayed since the last reset, over every device
    (reads the card)."""
    return sum(int(c.item()) for c in _replays.values())


def reset() -> None:
    global launches, chunks
    launches = chunks = 0
    for c in _replays.values():
        c.zero_()


def alloc_scan_cuda(node_free, node_reclaimable, interleave_ptr, oom_killed,
                    wm, data_policy, pt_policy, need_pt, need_data,
                    slot_thread, n_threads: int, alloc_mask: int, thp: bool):
    """Launch the scan on the tensors' CUDA device (arguments checked by
    ``ops``); returns its nine outputs, allocated here."""
    global launches, chunks
    L, T = need_data.shape
    N = node_free.shape[1]
    dev = node_free.device
    counter = _replays.get(dev)
    if counter is None:
        counter = _replays[dev] = torch.zeros(1, dtype=torch.int64, device=dev)

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    nodes = empty((L, T, 5), torch.int32)
    slow, ok, act = (empty((L, T, 5), torch.bool) for _ in range(3))
    gate = empty((L, T), torch.bool)
    free, rec = empty((L, N), torch.int32), empty((L, N), torch.int32)
    ptr, oom = empty((L,), torch.int32), empty((L,), torch.bool)
    lib = build.build().lib
    with torch.cuda.device(dev):
        err = lib.alloc_scan_launch(
            node_free.data_ptr(), node_reclaimable.data_ptr(),
            interleave_ptr.data_ptr(), oom_killed.data_ptr(), wm.data_ptr(),
            data_policy.data_ptr(), pt_policy.data_ptr(), need_pt.data_ptr(),
            need_data.data_ptr(),
            None if slot_thread is None else slot_thread.data_ptr(), L, T, N,
            0 if slot_thread is None else slot_thread.shape[1],
            n_threads // 2, alloc_mask, int(thp), nodes.data_ptr(),
            slow.data_ptr(), ok.data_ptr(), act.data_ptr(), gate.data_ptr(),
            free.data_ptr(), rec.data_ptr(), ptr.data_ptr(), oom.data_ptr(),
            counter.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check_launch("alloc_scan", err)
    launches += 1
    chunks += L * -(-T // 32)
    return nodes, slow, ok, act, gate, free, rec, ptr, oom
