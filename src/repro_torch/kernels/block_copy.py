"""The migration copy on the card: launch wrapper of ``csrc/block_copy.cu``.

Replaces the JAX package's Pallas kernel ``kernels/block_copy.py::
block_copy_kernel``.  Callers go through :func:`repro_torch.kernels.ops.
block_copy`, which checks the arguments and takes the plain version
(``ref.block_copy_ref``) for CPU tensors.
"""
from __future__ import annotations

import torch

from . import build

launches = 0    # kernel launches since the last reset (ops.reset_launches)


def block_copy_cuda(src_pool, dst_pool, ids):
    """Copy in place on the tensors' CUDA device (arguments checked by
    ``ops.block_copy``); pools are ``[G, P, bs, KH, Dh]``."""
    global launches
    if ids.shape[0] == 0 or src_pool.shape[0] == 0:
        return dst_pool                    # nothing to copy, no launch
    lib = build.build().lib
    groups, p_src = src_pool.shape[:2]
    p_dst = dst_pool.shape[1]
    block_bytes = src_pool[0, 0].numel() * src_pool.element_size()
    with torch.cuda.device(dst_pool.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.block_copy_launch(
            src_pool.data_ptr(), dst_pool.data_ptr(), ids.data_ptr(),
            ids.shape[0], groups, p_src, p_dst, block_bytes, stream)
    build.check_launch("block_copy", err)
    launches += 1
    return dst_pool
