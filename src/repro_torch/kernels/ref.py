"""Plain PyTorch versions of the port's kernels (twins of the JAX
package's ``kernels/ref.py``).

The wrappers in :mod:`.ops` run these for tensors on the CPU; the tests
hold them against the JAX kernels in interpret mode and ``chip_smoke.py``
holds the CUDA kernels against them on the card.  Indices are int32 as in
JAX and are widened to int64 here only.
"""
from __future__ import annotations

import torch


def pt_walk_ref(upper, leaf_tier, leaf_entries, vb):
    """Two-level radix walk.

    ``upper`` is one table row ``i32[max_leaf]`` or a batch of rows
    ``i32[R, max_leaf]``; ``leaf_tier i32[n_leaf]``, ``leaf_entries
    i32[n_leaf, F]``, ``vb i32[N]`` -> ``(tier, slot)``, each ``i32[N]``
    or ``i32[R, N]``.  ``tier`` is the tier of the *leaf page* the walk
    reads.  A walk through an unallocated upper entry gives ``(-1, -1)``,
    and so does a query or leaf id outside the table (the JAX kernel
    clamps those reads; no caller makes such queries).
    """
    fanout = leaf_entries.shape[1]
    vb = vb.long()
    rows = upper.long().reshape(-1, upper.shape[-1])
    leaf_idx = torch.div(vb, fanout, rounding_mode="floor")
    in_row = (vb >= 0) & (leaf_idx < rows.shape[1])
    leaf_id = rows[:, leaf_idx.clamp(0, rows.shape[1] - 1)]       # [R, N]
    valid = in_row & (leaf_id >= 0) & (leaf_id < leaf_entries.shape[0])
    safe = torch.where(valid, leaf_id, 0)
    tier = leaf_tier.long()[safe]
    slot = leaf_entries.long()[safe, (vb % fanout).expand_as(safe)]
    tier = torch.where(valid, tier, -1).to(torch.int32)
    slot = torch.where(valid, slot, -1).to(torch.int32)
    if upper.dim() == 1:
        return tier[0], slot[0]
    return tier, slot


def block_copy_ref(src_pool, dst_pool, ids):
    """``dst_pool[..., ids[m, 1], :] = src_pool[..., ids[m, 0], :]`` in
    place; returns ``dst_pool``.

    Pools are ``[P, bs, KH, Dh]`` or, with a leading group axis,
    ``[G, P, bs, KH, Dh]`` (one call then copies the pairs in every
    group).  Source and destination pools may hold different ``P``.
    """
    src = ids[:, 0].long()
    dst = ids[:, 1].long()
    if dst_pool.dim() == 5:
        dst_pool[:, dst] = src_pool[:, src]
    else:
        dst_pool[dst] = src_pool[src]
    return dst_pool
