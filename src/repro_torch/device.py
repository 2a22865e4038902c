"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device.  Asking for CUDA on a machine
    without it raises: no entry point drops to the CPU on its own, the
    caller passes ``device="cpu"`` for that."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default, but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions")
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for queued device work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
