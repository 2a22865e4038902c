"""Production and host meshes (twin of the JAX package's
``launch/mesh.py``).

A pod is 256 devices as (data=16, model=16); the multi-pod mesh prepends
a "pod" axis (2 pods = 512 devices).  Each is a ``DeviceMesh`` over the
initialised process group (the dry run's is a ``"fake"`` group of that
many ranks).  Defined as functions, so importing this module touches no
process-group state.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..distributed import sharding


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return sharding.make_mesh(shape, axes, device_type)


def make_host_mesh(data: int = 2, model: int = 4, device_type=None):
    """Small (data, model) mesh over the ranks of the initialised process
    group, clamped to their count as the reference clamps to its devices.
    ``device_type=None`` means "cuda" (the group's NCCL backend) and
    raises without CUDA; pass "cpu" for a gloo group."""
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_host_mesh runs on CUDA by default, but "
                "torch.cuda.is_available() is False; pass device_type='cpu' "
                "for a gloo process group")
        device_type = "cuda"
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    n = dist.get_world_size()
    data = min(data, max(n // model, 1))
    if data * model > n:
        model = n // data
    return sharding.make_mesh((data, model), ("data", "model"), device_type)
