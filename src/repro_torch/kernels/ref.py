"""Plain PyTorch versions of the port's kernels (twins of the JAX
package's ``kernels/ref.py``).

The wrappers in :mod:`.ops` run these for tensors on the CPU; the tests
hold them against the JAX kernels in interpret mode and ``chip_smoke.py``
holds the CUDA kernels against them on the card.  Indices are int32 as in
JAX and are widened to int64 here only.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30     # the mask score of the JAX kernel and oracle (finite)


def paged_attention_ref(q, k_pool, v_pool, tables, lengths):
    """Decode attention over paged KV pools (twin of the JAX oracle
    ``kernels/ref.py::paged_attention_ref``).

    ``q [B, KH, G, Dh]``, pools ``[KH, P, bs, Dh]``, ``tables i32[B, NB]``,
    ``lengths i32[B]`` -> ``[B, KH, G, Dh]`` in ``q``'s dtype.  Table
    entries are clamped to ``[0, P-1]`` (a ``-1`` past the length reads
    block 0); scores are f32, scaled by ``1/sqrt(Dh)``, and positions
    ``>= lengths[b]`` score ``-1e30``.  So a row with ``lengths == 0``
    gets the uniform mean of V over all ``NB`` gathered blocks.
    """
    B, KH, G, Dh = q.shape
    _, P, bs, _ = k_pool.shape
    NB = tables.shape[1]
    safe = tables.long().clamp(0, P - 1)
    k = k_pool[:, safe].movedim(0, 1).reshape(B, KH, NB * bs, Dh)
    v = v_pool[:, safe].movedim(0, 1).reshape(B, KH, NB * bs, Dh)
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), k.float())
    s = s / math.sqrt(Dh)
    pos = torch.arange(NB * bs, device=q.device)
    mask = pos[None, :] < lengths[:, None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p, v.float())
    return out.to(q.dtype)


def paged_attention_public(q, k_pool, v_pool, tables, lengths):
    """:func:`paged_attention_ref` in the public layout of
    ``ops.paged_attention``: ``q [B, H, Dh]`` with ``H = KH * G`` ->
    ``[B, H, Dh]``, query head ``h`` reading KV head ``h // G``.  Runs on
    the tensors' device, the card's included."""
    B, H, Dh = q.shape
    KH = k_pool.shape[0]
    return paged_attention_ref(q.reshape(B, KH, H // KH, Dh), k_pool, v_pool,
                               tables, lengths).reshape(B, H, Dh)


def paged_attention_inputs(B, KH, G, Dh, P, bs, NB, dtype, lengths, seed,
                           device="cpu"):
    """Inputs of ``ops.paged_attention`` for holding the kernel against
    the plain version: ``q [B, KH*G, Dh]`` and pools ``[KH, P, bs, Dh]``
    drawn from ``seed`` on ``device``; tables a seeded permutation of the
    pool (``P >= B * NB``) with ``-1`` past each length, as a paged cache
    leaves them (a row of length 0 keeps its first entry)."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((B, KH * G, Dh), generator=g, device=device).to(dtype)
    kp = torch.randn((KH, P, bs, Dh), generator=g, device=device).to(dtype)
    vp = torch.randn((KH, P, bs, Dh), generator=g, device=device).to(dtype)
    lengths = torch.as_tensor(lengths, device=device).long()
    tables = torch.randperm(P, generator=g, device=device)[:B * NB]
    tables = tables.reshape(B, NB)
    used = torch.clamp(-(-lengths // bs), min=1)
    tables[torch.arange(NB, device=device)[None, :] >= used[:, None]] = -1
    return q, kp, vp, tables.to(torch.int32), lengths.to(torch.int32)


def pt_walk_ref(upper, leaf_tier, leaf_entries, vb):
    """Two-level radix walk.

    ``upper`` is one table row ``i32[max_leaf]`` or a batch of rows
    ``i32[R, max_leaf]``; ``leaf_tier i32[n_leaf]``, ``leaf_entries
    i32[n_leaf, F]``, ``vb i32[N]`` -> ``(tier, slot)``, each ``i32[N]``
    or ``i32[R, N]``.  ``tier`` is the tier of the *leaf page* the walk
    reads.  A walk through an unallocated (negative) upper entry gives
    ``(-1, -1)``.  Out-of-range reads follow JAX's gathers: the upper
    index ``floor(v / F)`` counts from the end when negative and is then
    clamped into the row, the entry is ``v mod F`` (never negative), and
    a leaf id past the table is clamped to its last page.
    """
    n_leaf, fanout = leaf_entries.shape
    vb = vb.long()
    rows = upper.long().reshape(-1, upper.shape[-1])
    max_leaf = rows.shape[1]
    leaf_idx = torch.div(vb, fanout, rounding_mode="floor")
    leaf_idx = torch.where(leaf_idx < 0, leaf_idx + max_leaf, leaf_idx)
    leaf_id = rows[:, leaf_idx.clamp(0, max_leaf - 1)]            # [R, N]
    valid = leaf_id >= 0
    safe = torch.where(valid, leaf_id, 0).clamp(max=n_leaf - 1)
    tier = leaf_tier.long()[safe]
    slot = leaf_entries.long()[safe, (vb % fanout).expand_as(safe)]
    tier = torch.where(valid, tier, -1).to(torch.int32)
    slot = torch.where(valid, slot, -1).to(torch.int32)
    if upper.dim() == 1:
        return tier[0], slot[0]
    return tier, slot


def pt_walk_rows_any_ref(upper, rows, leaf_tier, leaf_entries, vb, tier):
    """``flags i32[R]``: 1 where the walk (:func:`pt_walk_ref`) of row
    ``rows[r]`` of ``upper i32[n_rows, max_leaf]`` reads a leaf page of
    tier ``tier`` for some query of ``vb``, else 0.  A row id follows
    JAX's gathers as the walk's indices do: counted from the end once
    when negative, then clamped into the table."""
    n_rows = upper.shape[0]
    r = rows.long()
    r = torch.where(r < 0, r + n_rows, r).clamp(0, n_rows - 1)
    walked, _ = pt_walk_ref(upper[r], leaf_tier, leaf_entries, vb)
    return (walked == tier).any(dim=1).to(torch.int32)


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
