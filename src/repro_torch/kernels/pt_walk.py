"""The table walk on the card: launch wrapper of ``csrc/pt_walk.cu``.

Replaces the JAX package's Pallas kernel ``kernels/pt_walk.py::
pt_walk_kernel``.  Callers go through :func:`repro_torch.kernels.ops.
pt_walk` or ``ops.pt_walk_rows_any``, which check the arguments and take
the plain versions (``ref.pt_walk_ref``, ``ref.pt_walk_rows_any_ref``)
for CPU tensors.
"""
from __future__ import annotations

import torch

from . import build

launches = 0    # kernel launches since the last reset (ops.reset_launches)


def pt_walk_cuda(upper, leaf_tier, leaf_entries, vb, rows=None,
                 flag_tier=None):
    """Launch the walk on the tensors' CUDA device (arguments checked by
    ``ops``).  ``upper`` is ``[n_rows, max_leaf]``.  Without ``rows`` every
    row is walked, with ``rows`` (``i32[R]``) the rows it names.  Returns
    ``(tier, slot)``, each ``i32[R, N]``, or, given ``flag_tier``, the
    flags ``i32[R]``: 1 where a walk of the row read a leaf page of that
    tier.  ``leaf_entries`` may be a strided view: the kernel reads it
    through its strides."""
    global launches
    n_rows, max_leaf = upper.shape
    n_leaf, fanout = leaf_entries.shape
    r_count = n_rows if rows is None else rows.shape[0]
    n = vb.shape[0]
    dev = upper.device
    if flag_tier is None:
        tier = torch.empty((r_count, n), dtype=torch.int32, device=dev)
        slot = torch.empty_like(tier)
        flags = None
        out = (tier, slot)
    else:
        tier = slot = None
        # no query reads anything: every flag is 0 without a launch
        alloc = torch.zeros if n == 0 else torch.empty
        flags = alloc((r_count,), dtype=torch.int32, device=dev)
        out = flags
    if r_count == 0 or n == 0:
        return out                         # empty walk, no launch
    lib = build.build().lib
    ptr = lambda t: None if t is None else t.data_ptr()    # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pt_walk_launch(
            upper.data_ptr(), n_rows, max_leaf, ptr(rows), r_count,
            leaf_tier.data_ptr(), leaf_entries.data_ptr(), n_leaf, fanout,
            *leaf_entries.stride(), vb.data_ptr(), n, ptr(tier), ptr(slot),
            ptr(flags), 0 if flag_tier is None else flag_tier, stream)
    build.check_launch("pt_walk", err)
    launches += 1
    return out


def empty_cuda(device) -> None:
    """Launch an empty kernel in the walk's launch shape (the floor of one
    launch, for timing); not counted as a walk."""
    lib = build.build().lib
    with torch.cuda.device(device):
        err = lib.empty_launch(torch.cuda.current_stream().cuda_stream)
    build.check_launch("empty", err)
