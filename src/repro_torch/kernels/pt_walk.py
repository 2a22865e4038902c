"""The table walk on the card: launch wrapper of ``csrc/pt_walk.cu``.

Replaces the JAX package's Pallas kernel ``kernels/pt_walk.py::
pt_walk_kernel``.  Callers go through :func:`repro_torch.kernels.ops.
pt_walk`, which checks the arguments and takes the plain version
(``ref.pt_walk_ref``) for CPU tensors.
"""
from __future__ import annotations

import torch

from . import build

launches = 0    # kernel launches since the last reset (ops.reset_launches)


def pt_walk_cuda(upper, leaf_tier, leaf_entries, vb):
    """Launch the walk on the tensors' CUDA device (arguments checked by
    ``ops.pt_walk``); ``upper`` is ``[R, max_leaf]``, outputs ``[R, N]``.
    ``leaf_entries`` may be a strided view: the kernel reads it through
    its strides."""
    global launches
    rows, max_leaf = upper.shape
    n_leaf, fanout = leaf_entries.shape
    n = vb.shape[0]
    tier = torch.empty((rows, n), dtype=torch.int32, device=upper.device)
    slot = torch.empty_like(tier)
    if rows == 0 or n == 0:
        return tier, slot                  # empty walk, no launch
    lib = build.build().lib
    with torch.cuda.device(upper.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pt_walk_launch(
            upper.data_ptr(), rows, max_leaf, leaf_tier.data_ptr(),
            leaf_entries.data_ptr(), n_leaf, fanout, *leaf_entries.stride(),
            vb.data_ptr(), n, tier.data_ptr(), slot.data_ptr(), stream)
    build.check_launch("pt_walk", err)
    launches += 1
    return tier, slot
