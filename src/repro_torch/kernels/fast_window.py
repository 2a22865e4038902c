"""The fast window's inner scan on the card: launch wrapper of
``csrc/fast_window.cu``.

No Pallas original: replaces the inner ``lax.scan`` (``row``) of the JAX
package's ``core/sim.py::_build_fast_window``.  Callers go through
:func:`repro_torch.kernels.ops.fast_window`, which checks the arguments
and takes the plain version (``ref.fast_window_ref``) for CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from . import build

launches = 0    # kernel launches since the last reset (ops.reset_launches)


def fast_window_cuda(m, flags, terms, caches, acc, now0: int,
                     radix_bits: int, thp: bool, costs):
    """Launch the scan on the tensors' CUDA device (arguments checked by
    ``ops``); updates ``caches`` and ``acc`` in place and returns ``(cum,
    counts)``, allocated here."""
    global launches
    L, R, T = m.shape
    dev = m.device
    cum = torch.empty((L, R, 4, T), dtype=torch.float32, device=dev)
    counts = torch.empty((L, R, 4, T), dtype=torch.int32, device=dev)
    if L * R * T == 0:
        return cum, counts
    (t1, r1), (t2, r2), (t3, r3), (t4, r4) = caches
    lib = build.build().lib
    with torch.cuda.device(dev):
        err = lib.fast_window_launch(
            m.data_ptr(), flags.data_ptr(), terms.data_ptr(),
            t1.data_ptr(), r1.data_ptr(), t2.data_ptr(), r2.data_ptr(),
            t3.data_ptr(), r3.data_ptr(), t4.data_ptr(), r4.data_ptr(),
            *(a.data_ptr() for a in acc), cum.data_ptr(), counts.data_ptr(),
            L, R, T, int(now0), int(radix_bits), int(thp), t1.shape[2],
            t1.shape[3], t2.shape[2], t2.shape[3], t3.shape[2] * t3.shape[3],
            t4.shape[2] * t4.shape[3], *(float(np.float32(c)) for c in costs),
            torch.cuda.current_stream().cuda_stream)
    build.check_launch("fast_window", err)
    launches += 1
    return cum, counts
