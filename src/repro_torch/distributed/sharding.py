"""Logical-axis -> mesh-axis sharding rules (DP / TP / EP / CP) on a
``torch.distributed.device_mesh.DeviceMesh`` (twin of the JAX package's
``distributed/sharding.py``, the same rules and names).

Parameters declare *logical* axes ("embed", "heads_mm", "ff", "experts",
"vocab", ...); this module maps them onto the mesh's named dims.  The
default rule set is Megatron-style tensor parallelism on the "model" axis
with data parallelism over ("pod", "data"):

  heads_mm / kv_mm   attention projection columns  -> model
  ff / inner*        MLP / Mamba hidden width      -> model
  experts            MoE expert axis (EP)          -> model
  vocab              embedding / LM head rows      -> model
  embed / layers     replicated (row dimension)

A logical dim is only sharded if its size divides the mesh axis; otherwise
it silently falls back to replication.

A spec (:func:`spec_for`) is the reference's ``PartitionSpec`` as a tuple
of the same entries, one per tensor dim: a mesh-axis name, a tuple of
names, or ``None``.  :func:`placements` turns it into DTensor's
``[Shard(d) | Replicate()]`` list, one per mesh dim (a tensor dim over
("pod", "data") is ``Shard(d)`` on both mesh dims, the major one first,
as GSPMD splits it), and :class:`NamedSharding` carries the mesh, the
placements and the spec: what ``distribute_tensor`` takes.

``make_mesh`` is ``init_device_mesh`` over the initialised process group.
The reference's ``shard_map`` (an API-drift wrapper around JAX's manual
SPMD) has no counterpart: the compressed train step is per-rank code over
the mesh's DP group (``training/train.py::make_compressed_train_step``).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

from torch.distributed.tensor import Replicate, Shard

from ..models.modules import ParamSpec, tree_map

# logical axis -> mesh axis (None = replicate)
DEFAULT_RULES: Dict[str, Optional[str]] = {
    "vocab": "model",
    "heads_mm": "model",
    "kv_mm": "model",
    "ff": "model",
    "experts": "model",
    "inner": "model",
    "inner2": "model",
    "heads": "model",
    "embed": None,
    "embed_out": None,
    "layers": None,
    "batch": ("pod", "data"),
    "seq": None,
}

# torch.cuda.get_device_properties(0).total_memory on an NVIDIA H100 80GB
# HBM3 (chip_smoke.py prints it): the per-device memory choose_rules sizes
# a cell against by default
H100_HBM_BYTES = 85_017_493_504


class NamedSharding(NamedTuple):
    """A leaf's layout on a mesh: DTensor's placements, one per mesh dim,
    and the reference's PartitionSpec entries they come from."""
    mesh: object
    placements: Tuple
    spec: Tuple


def make_mesh(axis_shapes, axis_names, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``axis_shapes`` named ``axis_names`` over the
    ranks of the initialised process group (their count must be the
    product of the shape)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(axis_shapes),
                            mesh_dim_names=tuple(axis_names))


def axis_sizes(mesh) -> Dict[str, int]:
    """{mesh-dim name: size} (the reference's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axis, tuple):
        return int(math.prod(sizes[a] for a in axis))
    return sizes[axis]


def spec_for(spec: ParamSpec, mesh, rules: Optional[Dict] = None) -> Tuple:
    rules = rules or DEFAULT_RULES
    out = []
    used = set()
    for dim, logical in zip(spec.shape, spec.logical_axes):
        axis = rules.get(logical) if logical else None
        if axis is not None and axis not in used \
                and mesh_axis_size(mesh, axis) > 1 \
                and dim % mesh_axis_size(mesh, axis) == 0:
            out.append(axis)
            used.add(axis)
        else:
            out.append(None)
    return tuple(out)


def placements(spec: Tuple, mesh) -> list:
    """DTensor placements of a spec: per mesh dim, ``Shard(d)`` for the
    tensor dim ``d`` whose entry names it (alone or in a tuple), else
    ``Replicate()``.  A mesh dim of size 1 replicates: the same layout,
    which DTensor's view rules take where a dim of global size 1 would
    otherwise count as sharded."""
    out = []
    for name, size in axis_sizes(mesh).items():
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims and size > 1 else Replicate())
    return out


def named(mesh, spec: Tuple) -> NamedSharding:
    return NamedSharding(mesh, tuple(placements(spec, mesh)), tuple(spec))


def param_shardings(specs, mesh, rules: Optional[Dict] = None):
    """Tree of NamedSharding matching a ParamSpec tree."""
    return tree_map(lambda s: named(mesh, spec_for(s, mesh, rules)), specs)


FSDP_RULES: Dict[str, Optional[str]] = dict(
    DEFAULT_RULES,
    embed="data",       # shard the d_model dimension over DP (FSDP)
    embed_out="data",
)

# Expert-parallel-over-data: expert weights shard over ("data" x "model")
# via (E, ff), so they are never re-gathered.  Requires n_experts % data
# == 0.
MOE_EP_RULES: Dict[str, Optional[str]] = dict(
    FSDP_RULES,
    experts="data",
)

# moe_ep + TP-resident non-expert weights: dense params are small enough
# to live sharded-over-model only (no FSDP regather per microbatch).
MOE_EP_TP_RULES: Dict[str, Optional[str]] = dict(
    DEFAULT_RULES,
    experts="data",
)

RULE_SETS = {"default": DEFAULT_RULES, "fsdp": FSDP_RULES,
             "moe_ep": MOE_EP_RULES, "moe_ep_tp": MOE_EP_TP_RULES}


def choose_rules(param_bytes: int, mesh, mode: str = "serve",
                 hbm_bytes: int = H100_HBM_BYTES) -> Dict[str, Optional[str]]:
    """TP-only if the cell's parameter-proportional state fits comfortably
    per device, else TP+FSDP.

    Training carries ~7x the bf16 parameter bytes (params + f32 grads +
    f32 Adam moments); serving carries 1x.
    """
    tp = mesh_axis_size(mesh, "model") if "model" in mesh.mesh_dim_names \
        else 1
    mult = 7.0 if mode == "train" else 1.0
    if param_bytes * mult / tp < 0.35 * hbm_bytes:
        return DEFAULT_RULES
    return FSDP_RULES


def opt_state_shardings(specs, mesh, rules=None, factored=False):
    """NamedShardings for the optimizer state, from the ParamSpec tree."""
    m = param_shardings(specs, mesh, rules)
    scalar = named(mesh, ())
    if not factored:
        return {"m": m, "v": m, "step": scalar}

    def reduce_spec(s: ParamSpec, keep):
        shape = tuple(s.shape[i] for i in keep)
        axes = tuple(s.logical_axes[i] for i in keep)
        if not shape:
            return scalar
        return named(mesh, spec_for(ParamSpec(shape, axes, dtype="float32"),
                                    mesh, rules))

    vr = tree_map(lambda s: reduce_spec(s, range(len(s.shape) - 1))
                  if len(s.shape) >= 2 else reduce_spec(s, range(len(s.shape))),
                  specs)
    vc = tree_map(lambda s: reduce_spec(s, list(range(len(s.shape) - 2))
                                        + [len(s.shape) - 1])
                  if len(s.shape) >= 2 else scalar, specs)
    return {"m": m, "vr": vr, "vc": vc, "step": scalar}


def dp_axes(mesh):
    """The mesh's DP axes as a spec entry: a name, or a tuple of names."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    return dp[0] if len(dp) == 1 else dp


def data_sharding(mesh, *, batch_axes=None) -> NamedSharding:
    """Batch-leading arrays: shard dim 0 over DP axes."""
    axes = batch_axes or tuple(a for a in ("pod", "data")
                               if a in mesh.mesh_dim_names)
    if len(axes) == 1:
        axes = axes[0]
    return named(mesh, (axes,))


def batch_specs(input_tree, mesh) -> Dict:
    """Tree of tensors (``meta`` ones too) -> NamedSharding tree (dim 0 =
    batch)."""
    dp = dp_axes(mesh)

    def one(s):
        if s.shape and s.shape[0] % mesh_axis_size(mesh, dp) == 0:
            return named(mesh, (dp,) + (None,) * (len(s.shape) - 1))
        return named(mesh, ())
    return tree_map(one, input_tree)


def kv_cache_sharding(mesh, cache_tree):
    """Decode-state shardings.

    KV caches are [G, B, S, KH, Dh]: batch over DP; the *head_dim* over
    "model" — the attention contraction over a sharded Dh becomes a sum
    across the model axis, keeping per-device cache at B/dp x S x KH x
    Dh/tp.  SSM/RWKV states shard their inner width over "model" and
    batch over DP.
    """
    return tree_map(lambda s: named(mesh, _cache_spec(mesh, s.shape, 1)),
                    cache_tree)


def _cache_spec(mesh, shape, batch: int) -> Tuple:
    """``kv_cache_sharding``'s spec of a state of ``shape`` whose batch dim
    is ``batch``: the batch over DP and the trailing width over "model",
    each where divisible."""
    dp = dp_axes(mesh)
    tp = "model" if "model" in mesh.mesh_dim_names else None
    dims = [None] * len(shape)
    if len(shape) > batch and shape[batch] % mesh_axis_size(mesh, dp) == 0:
        dims[batch] = dp
    # shard the trailing width over model if divisible
    if tp and len(shape) >= batch + 2 \
            and shape[-1] % mesh_axis_size(mesh, tp) == 0:
        dims[-1] = tp
    return tuple(dims)


def kv_constraint(mesh):
    """One layer's k or v [B, S, KH, Dh] redistributed as
    ``kv_cache_sharding`` lays the stacked caches [G, B, S, KH, Dh] out
    (``models.forward``'s ``kv_constraint``: no rank holds a prefill's
    caches whole before they are stacked)."""
    return lambda x: x.redistribute(
        mesh, placements(_cache_spec(mesh, x.shape, 0), mesh))


def distribute(tree, shardings):
    """Each leaf of ``tree`` (the same full tensor on every rank) laid out
    as its NamedSharding says: each rank keeps its own shard, no
    communication."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map(lambda a, sh: distribute_tensor(
        a, sh.mesh, list(sh.placements), src_data_rank=None), tree,
        shardings)
