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


# How far the 16-bit kernel may stray from the f32 answer on its own
# inputs, per row: the largest error of a row of Dh outputs over the row's
# rms.  A long row's outputs average thousands of positions and are small
# (about 0.02 at 8192 tokens of N(0, 1) values), so an absolute limit the
# size of the JAX tests' would let a wrong merge through; one chunk of a
# sequence left out moves a row by over half its rms.  The limits are about
# three times the rounding of P and of the output that the tests measure
# (test_torch_paged_attention.py: bf16 about 0.01, f16 about 0.0015).
ATTN_ROW_TOL = {torch.bfloat16: 3e-2, torch.float16: 4e-3}


def attention_row_error(got, want):
    """``[..., Dh]`` -> ``[...]``: each row's largest absolute error over
    the rms of ``want``'s row (both taken in f32)."""
    want = want.float()
    rms = want.pow(2).mean(-1).sqrt().clamp(min=1e-30)
    return (got.float() - want).abs().amax(-1) / rms


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


# (B, KH, G, Dh, P, bs, NB) at which the card's checks (chip_smoke.py
# phase [7], tests/test_torch_cuda.py) hold the attention kernel to this
# plain version: tests/test_kernels.py's sweep, G = 5, Dh 32 / 64, groups
# run on larger instances (3 and 7 on 4 and 8 rows for f32, 12 in two
# chunks of 8), head dims between instances (16, 80, 192), and blocks of
# 1, 4 and 12 positions
ATTN_TEST_SHAPES = [
    (1, 1, 1, 128, 8, 8, 2), (2, 2, 4, 128, 16, 16, 4),
    (3, 4, 2, 256, 32, 8, 5), (2, 2, 8, 128, 16, 32, 3),
    (2, 2, 5, 64, 64, 16, 12), (4, 3, 1, 32, 48, 8, 9),
    (2, 2, 3, 64, 16, 16, 4), (3, 1, 7, 128, 24, 8, 6),
    (2, 2, 1, 64, 48, 4, 20), (2, 2, 5, 80, 32, 16, 10),
    (2, 1, 7, 80, 64, 4, 24), (2, 2, 12, 128, 40, 4, 16),
    (2, 1, 5, 192, 32, 16, 12), (3, 1, 12, 192, 48, 4, 12),
    (2, 2, 1, 192, 24, 12, 8), (2, 1, 7, 16, 40, 1, 17)]
# (B, KH, G, Dh, P, bs, NB, lengths): -1 entries past short lengths, and
# rows of length 0 (the oracle's uniform mean of V)
ATTN_FIXED_LENGTHS = [
    (3, 2, 2, 64, 40, 8, 6, [9, 48, 20]), (3, 2, 2, 64, 12, 8, 4, [9, 32, 0]),
    (3, 2, 5, 80, 40, 4, 12, [0, 45, 3]),
    (3, 1, 12, 192, 24, 4, 6, [17, 0, 24])]


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

    Ids outside the pools follow the JAX oracle (``dst.at[ids[:, 1]].set(
    src[ids[:, 0]])``): a negative id counts from the end of its pool once;
    a source is then clamped into ``[0, P_src - 1]``, and a pair whose
    destination is still outside ``[0, P_dst)`` is dropped.
    """
    lead = dst_pool.dim() - 4
    p_src, p_dst = src_pool.shape[lead], dst_pool.shape[lead]
    if ids.shape[0] == 0:
        return dst_pool
    src = ids[:, 0].long()
    dst = ids[:, 1].long()
    src = torch.where(src < 0, src + p_src, src).clamp(0, p_src - 1)
    dst = torch.where(dst < 0, dst + p_dst, dst)
    keep = (dst >= 0) & (dst < p_dst)
    # a dropped pair repeats the first kept one (the same write twice), so
    # dropping waits on nothing on the device; with none kept, the first
    # pair's clamped destination is written with its own block
    first = keep.int().argmax().reshape(1)     # a tensor: no host read
    src = torch.where(keep, src, src[first])
    dst = torch.where(keep, dst, dst[first]).clamp(0, p_dst - 1)
    vals = torch.where(keep.any(), src_pool.index_select(lead, src),
                       dst_pool.index_select(lead, dst[:1]))
    if lead:
        dst_pool[:, dst] = vals
    else:
        dst_pool[dst] = vals
    return dst_pool


def alloc_scan_ref(node_free, node_reclaimable, interleave_ptr, oom_killed,
                   wm, data_policy, pt_policy, need_pt, need_data, n_threads,
                   alloc_nodes, thp):
    """The allocator of one fault step, serially over the threads (the
    body of the JAX package's ``core/alloc.py::alloc_many``): a Python loop
    over the threads, each making its root/top/mid/leaf PT requests and
    then its data request through ``core.alloc.alloc_one``, all lanes at
    once.

    Lanes lead every tensor: ``node_free``, ``node_reclaimable``
    ``i32[L, N]``, ``interleave_ptr`` ``i32[L]``, ``oom_killed``
    ``bool[L]``, ``data_policy`` / ``pt_policy`` ``i32[L]``, ``need_pt``
    ``bool[L, T, 4]``, ``need_data`` ``bool[L, T]``; ``wm`` is ``i32[N]``.
    Thread ``t`` is local to node pair member ``t >= n_threads // 2``;
    interleaving rotates over ``alloc_nodes``; ``thp`` binds the leaf like
    an upper level under BHi.  Returns ``(nodes i32[L, T, 5], slow, ok,
    act bool[L, T, 5], gate bool[L, T], node_free', node_reclaimable',
    interleave_ptr', oom_killed')``.
    """
    # imported here: core.alloc reaches this module through kernels.ops
    from types import SimpleNamespace

    from ..core import alloc
    from ..core.config import INTERLEAVE, PT_BIND_HIGH, PT_FOLLOW_DATA

    L, T = need_data.shape
    N = node_free.shape[1]
    dev = node_free.device
    mc = SimpleNamespace(n_threads=n_threads, n_tiers=N // 2, n_nodes=N,
                         alloc_nodes=tuple(alloc_nodes))
    free, rec = node_free, node_reclaimable
    ptr, oom = interleave_ptr, oom_killed
    is_interleave = (data_policy == INTERLEAVE)[:, None]
    is_bhi = pt_policy == PT_BIND_HIGH
    advances = [is_interleave[:, 0] & (pt_policy == PT_FOLLOW_DATA)] * 4 \
        + [is_interleave[:, 0]]
    # each thread's first-touch order, and the interleave order of every
    # cursor position
    threads = torch.arange(T, dtype=torch.int32, device=dev)
    first_touch = alloc.first_touch_prefs(threads, mc)
    rotations = alloc.interleave_prefs(
        torch.arange(len(mc.alloc_nodes), dtype=torch.int32, device=dev), mc)
    dram = alloc.dram_prefs(threads, mc)
    no_wm = torch.zeros_like(oom_killed)
    # the levels that bind to the DRAM order (core/alloc.py::pt_prefs_for)
    bound = [alloc.pt_bound(pt_policy, upper, thp)
             for upper in alloc.LEVEL_IS_UPPER]
    nodes, slows, oks, acts, gates = [], [], [], [], []
    for t in range(T):
        gate = ~oom                       # thread-entry OOM gate
        for lvl in range(5):
            dprefs = torch.where(is_interleave,
                                 rotations[ptr.remainder(len(mc.alloc_nodes))],
                                 first_touch[t])
            if lvl < 4:
                act = need_pt[:, t, lvl] & gate
                prefs = torch.where(bound[lvl][:, None], dram[t], dprefs)
                if alloc.LEVEL_IS_UPPER[lvl] or thp:
                    # BHi falls back to the data policy when DRAM is
                    # exhausted: the level's order and the data order are
                    # tried side by side, and the fallback selected
                    node, slow, nf, nr, ok = alloc.alloc_one(
                        free, rec, torch.stack([prefs, dprefs]), wm,
                        torch.stack([bound[lvl], no_wm]))
                    use_fb = is_bhi & ~ok[0]
                    node = torch.where(use_fb, node[1], node[0])
                    slow = torch.where(use_fb, slow[1], slow[0])
                    nf = torch.where(use_fb[:, None], nf[1], nf[0])
                    nr = torch.where(use_fb[:, None], nr[1], nr[0])
                    ok = ok[0] | (is_bhi & ok[1])
                else:
                    node, slow, nf, nr, ok = alloc.alloc_one(
                        free, rec, prefs, wm, bound[lvl])
            else:
                act = need_data[:, t] & gate
                node, slow, nf, nr, ok = alloc.alloc_one(free, rec, dprefs,
                                                         wm, False)
            do = act & ok
            free = torch.where(do[:, None], nf, free)
            rec = torch.where(do[:, None], nr, rec)
            ptr = ptr + (do & advances[lvl]).to(torch.int32)
            oom = oom | (act & ~ok)
            nodes.append(node), slows.append(slow)
            oks.append(ok), acts.append(act)
        gates.append(gate)

    def per_request(xs):
        return torch.stack(xs, dim=1).reshape(L, T, 5)

    return (per_request(nodes), per_request(slows), per_request(oks),
            per_request(acts), torch.stack(gates, dim=1), free, rec, ptr, oom)
