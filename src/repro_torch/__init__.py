"""PyTorch/CUDA port of the ``repro`` package, slice by slice.

The JAX package ``repro`` stays the reference; this package mirrors its
sub-package names (``kernels``, ``memsys``, ``serving``, ``configs``) and
imports nothing from it and nothing of JAX.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``; without CUDA they raise
(see :mod:`repro_torch.device`).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
