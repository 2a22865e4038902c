"""Checkpointing with atomic manifests and async save (twin of the JAX
package's ``checkpoint/ckpt.py``: the same files, byte for byte, so
either package restores what the other wrote).

Layout:  <dir>/step_<N>/
            manifest.json       tree structure, shapes, dtypes, step
            <leaf-path>.npy     one file per tree leaf

Leaf paths are the dict keys (list and tuple indices) joined with ``/``,
in sorted key order, as ``jax.tree_util`` flattens dicts; a file is named
``path.replace("/", "__") + ".npy"``.  bfloat16, which numpy lacks, is
stored as its 16-bit pattern (``uint16``) with ``"bfloat16"`` in the
manifest.  Writes go to ``step_<N>.tmp`` and are renamed only after the
manifest is fsynced — a crashed save can never be mistaken for a complete
checkpoint (``latest_step`` only considers directories with a manifest).

``save`` copies every leaf to the host before it returns, also with
``blocking=False`` (the writer thread then only writes files): the train
step updates params and moments in place, so the thread must not read
them.  A DTensor leaf is gathered whole (``full_tensor``, a collective,
so every rank calls ``save``) before the thread starts, and in a process
group only rank 0 writes: the files are those of a one-device save.
``restore`` reads every leaf on every rank; with ``shardings`` (a tree of
``distributed.sharding.NamedSharding``, any mesh) each leaf becomes a
DTensor laid out as its sharding says — the elastic path: one mesh's
checkpoint reloads onto another — and the rest go to ``device``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from ..device import resolve_device
from ..distributed.sharding import NamedSharding

_SEP = "/"


def _flatten(tree, prefix=()) -> Dict[str, Any]:
    """{path: leaf} in ``jax.tree_util``'s order: dict keys sorted, list
    and tuple entries by index (a NamedSharding is a leaf)."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)) \
            and not isinstance(tree, NamedSharding):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {_SEP.join(prefix): tree}
    flat: Dict[str, Any] = {}
    for k, v in items:
        flat.update(_flatten(v, prefix + (k,)))
    return flat


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` that shares no memory with it (bfloat16 as
    its 16-bit pattern)."""
    t = t.detach()
    if isinstance(t, DTensor):
        t = t.full_tensor()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy() \
            .view(np.uint16)
    return t.to("cpu", copy=True).numpy()


def save(ckpt_dir: str, step: int, tree, *, blocking: bool = True
         ) -> threading.Thread:
    """Atomic checkpoint write; pass blocking=False for async save."""
    base = Path(ckpt_dir)
    final = base / f"step_{step}"
    tmp = base / f"step_{step}.tmp"
    flat = {k: (str(v.dtype).removeprefix("torch."), _host_copy(v))
            for k, v in _flatten(tree).items()}

    def write():
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": {}}
        for key, (dtype, arr) in flat.items():
            fname = key.replace(_SEP, "__") + ".npy"
            np.save(tmp / fname, arr)
            manifest["leaves"][key] = {
                "file": fname, "shape": list(arr.shape), "dtype": dtype}
        mpath = tmp / "manifest.json"
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)

    if dist.is_initialized() and dist.get_rank() != 0:
        write = _nothing
    t = threading.Thread(target=write, daemon=True)
    t.start()
    if blocking:
        t.join()
    return t


def _nothing():
    pass


def latest_step(ckpt_dir: str) -> Optional[int]:
    base = Path(ckpt_dir)
    if not base.exists():
        return None
    steps = []
    for d in base.iterdir():
        if d.is_dir() and d.name.startswith("step_") \
                and not d.name.endswith(".tmp") \
                and (d / "manifest.json").exists():
            steps.append(int(d.name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, example_tree, shardings=None,
            device=None):
    """Load into the structure of ``example_tree`` (tensors, ``meta`` ones
    and DTensors included, giving each leaf's shape and dtype), each leaf
    cast to its example's dtype.  A leaf with a NamedSharding in
    ``shardings`` becomes a DTensor on that sharding's mesh; the others go
    to ``device`` (``None``: the CUDA device)."""
    final = Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((final / "manifest.json").read_text())
    flat = _flatten(example_tree)
    missing = [k for k in flat if k not in manifest["leaves"]]
    if missing:
        raise ValueError(f"checkpoint missing leaves: {missing[:5]}")
    flat_sh = _flatten(shardings) if shardings is not None else {}
    out = []
    for key, leaf in flat.items():
        info = manifest["leaves"][key]
        arr = np.load(final / info["file"])
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"{key}: checkpoint shape {arr.shape} != {tuple(leaf.shape)}")
        if info["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        sh = flat_sh.get(key)
        if sh is not None:
            t = t.to(device=sh.mesh.device_type, dtype=leaf.dtype)
            out.append(distribute_tensor(t, sh.mesh, list(sh.placements),
                                         src_data_rank=None))
        else:
            out.append(t.to(device=resolve_device(device), dtype=leaf.dtype))
    return _unflatten(example_tree, iter(out))
