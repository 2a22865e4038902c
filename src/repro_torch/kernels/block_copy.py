"""The migration copy on the card: launch wrapper of ``csrc/block_copy.cu``.

Replaces the JAX package's Pallas kernel ``kernels/block_copy.py::
block_copy_kernel``.  Callers go through :func:`repro_torch.kernels.ops.
block_copy_pools` (or ``ops.block_copy`` for one pair), which checks the
arguments and takes the plain version (``ref.block_copy_ref``) for CPU
tensors.
"""
from __future__ import annotations

import torch

from . import build

launches = 0    # kernel launches since the last reset (ops.reset_launches)
MAX_PAIRS = 2   # pool pairs per launch: a migration's K and V pools


def block_copy_cuda(pairs, ids):
    """Copy in place on the tensors' CUDA device, every pair (at most
    ``MAX_PAIRS``) in one launch (arguments checked by
    ``ops.block_copy_pools``); pools are ``[G, P, bs, KH, Dh]``, every
    source of one shape, every destination of one."""
    global launches
    (src0, dst0), *rest = pairs
    src1, dst1 = rest[0] if rest else (None, None)
    groups, p_src = src0.shape[:2]
    p_dst = dst0.shape[1]
    m = ids.shape[0]
    if m == 0 or groups == 0:
        return                             # nothing to copy, no launch
    block_bytes = src0[0, 0].numel() * src0.element_size()
    lib = build.build().lib
    ptr = lambda t: None if t is None else t.data_ptr()    # noqa: E731
    with torch.cuda.device(dst0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.block_copy_launch(src0.data_ptr(), dst0.data_ptr(),
                                    ptr(src1), ptr(dst1), ids.data_ptr(), m,
                                    groups, p_src, p_dst, block_bytes, stream)
    build.check_launch("block_copy", err)
    launches += 1
