"""Plain PyTorch versions of the port's kernels (twins of the JAX
package's ``kernels/ref.py``).

The wrappers in :mod:`.ops` run these for tensors on the CPU; the tests
hold them against the JAX kernels in interpret mode and ``chip_smoke.py``
holds the CUDA kernels against them on the card.  Indices are int32 as in
JAX and are widened to int64 here only.
"""
from __future__ import annotations

import math

import numpy as np
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


def slot_rows(slot_thread, T):
    """``bool[L, T]``: the threads named in each run's slot row
    ``slot_thread i32[L, G]``; an entry outside ``[0, T)`` is a pad."""
    s = slot_thread.long()
    s = torch.where((s >= 0) & (s < T), s, T)
    return torch.zeros((s.shape[0], T + 1), dtype=torch.bool,
                       device=s.device).scatter_(1, s, True)[:, :T]


def alloc_scan_ref(node_free, node_reclaimable, interleave_ptr, oom_killed,
                   wm, data_policy, pt_policy, need_pt, need_data, n_threads,
                   alloc_nodes, thp, slot_thread=None):
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
    an upper level under BHi.  ``slot_thread`` (``i32[L, G]`` or None)
    is the reference's compacted scan: a thread outside its run's slot row
    (:func:`slot_rows`) requests nothing and reports node -1, slow and ok
    False.  Returns ``(nodes i32[L, T, 5], slow, ok, act bool[L, T, 5],
    gate bool[L, T], node_free', node_reclaimable', interleave_ptr',
    oom_killed')``.
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
    if slot_thread is not None:
        in_row = slot_rows(slot_thread, T)
        need_pt = need_pt & in_row[..., None]
        need_data = need_data & in_row
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

    nodes, slows, oks = per_request(nodes), per_request(slows), per_request(oks)
    if slot_thread is not None:
        keep = in_row[..., None]
        nodes = torch.where(keep, nodes, -1)
        slows, oks = slows & keep, oks & keep
    return (nodes, slows, oks, per_request(acts), torch.stack(gates, dim=1),
            free, rec, ptr, oom)


# -- the allocator scan's two-pass algorithm, for the tests -------------------

WARP = 32      # csrc/alloc_scan.cu: the threads of a chunk, one per warp lane


def _int32(x: int) -> int:
    """``x`` wrapped into int32, as the kernel's and PyTorch's adds wrap."""
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def _lowest(x: int) -> int:
    return (x & -x).bit_length() - 1 if x else -1


def _first_touch_first(x: int, local: int) -> int:
    """The first node of bitmask ``x`` in a first-touch order: fastest
    tier first, the thread's own node of each pair first."""
    tiers = (x | (x >> 1)) & 0x55555555
    if not tiers:
        return -1
    p = _lowest(tiers)
    return p + local if x >> (p + local) & 1 else p + 1 - local


def _rotation_first(x: int, a_start: int) -> int:
    """The first node of ``x`` in the interleave order starting at
    allocatable node ``a_start``: the nodes from it up, then the rest."""
    return _lowest((x & ~((1 << a_start) - 1)) or x)


def _pick(fast, slow, reserve, rotate, local, a_start):
    """``core.alloc.alloc_one`` over node bitmasks: ``(node, ok, slow,
    from_reclaim)``."""
    for mask, flags in ((fast, (True, False, False)),
                        (slow, (True, True, False)),
                        (reserve, (True, True, True))):
        n = (_rotation_first(mask, a_start) if rotate
             else _first_touch_first(mask, local))
        if n >= 0:
            return (n, *flags)
    return (-1, False, False, False)


def _request(run, preds, r, local, a_start):
    """Request ``r`` (0-3 the PT levels, 4 the data page) of a thread on
    pair member ``local``, from the predicate bitmasks ``preds``."""
    above, free, reserve = preds
    s = run["alloc_mask"] if run["interleave"] else run["all"]
    data = _pick(above & s, free & s, reserve & s, run["interleave"], local,
                 a_start)
    if r == 4:
        return data
    upper = r < 3 or run["thp"]
    if not (run["bind_all"] or (run["bhi"] and upper)):
        return data
    # bound to the DRAM order (nodes 0 and 1), the watermark ignored
    dram = _pick(free & 3, free & 3, reserve & 3, False, local, 0)
    return data if (not dram[1] and run["bhi"] and upper) else dram


def _preds(free, rec, wm):
    """The node bitmasks of free > wm, free > 0 and reclaimable > 0 (the
    kernel's three ballots)."""
    def bits(xs):
        return sum(1 << i for i, x in enumerate(xs) if x)
    return (bits(f > w for f, w in zip(free, wm)), bits(f > 0 for f in free),
            bits(r > 0 for r in rec))


def alloc_scan_speculative_ref(node_free, node_reclaimable, interleave_ptr,
                               oom_killed, wm, data_policy, pt_policy,
                               need_pt, need_data, n_threads, alloc_nodes,
                               thp, slot_thread=None):
    """The algorithm of ``csrc/alloc_scan.cu``, in plain PyTorch and Python
    over the kernel's values, for the tests (no wrapper runs it).

    Each run takes its threads in chunks of :data:`WARP`, and a chunk in
    passes.  A pass speculates every request from its start on from the
    predicates at that point (free > watermark, free > 0, reclaimable > 0
    per node): the requests that find a page, then the OOM gates (the
    first failing thread), the commits, each request's cursor (an
    exclusive prefix of advancing commits) and only then each pick.  It
    verifies them by finding the first request at which a node's
    decrements of one kind reach the count that makes one of its
    predicates fall, keeps the requests up to it, and the next pass starts
    after it.  Same arguments and outputs as :func:`alloc_scan_ref`, plus
    the number of chunks that took more than one pass (replayed).
    """
    from ..core.config import (INTERLEAVE, PT_BIND_ALL, PT_BIND_HIGH,
                               PT_FOLLOW_DATA)

    L, T = need_data.shape
    N = node_free.shape[1]
    need = torch.cat([need_pt, need_data[..., None]], dim=-1)
    in_row = (slot_rows(slot_thread, T) if slot_thread is not None
              else torch.ones((L, T), dtype=torch.bool))
    need = need & in_row[..., None]
    alloc = sorted({int(a) for a in alloc_nodes})
    wm = wm.tolist()
    never = 1 << 20
    nodes = torch.full((L, T, 5), -1, dtype=torch.int32)
    slow, ok, act = (torch.zeros((L, T, 5), dtype=torch.bool)
                     for _ in range(3))
    gate = torch.zeros((L, T), dtype=torch.bool)
    free_out, rec_out = node_free.clone(), node_reclaimable.clone()
    ptr_out, oom_out = interleave_ptr.clone(), oom_killed.clone()
    replayed = 0
    for l in range(L):
        free, rec = node_free[l].tolist(), node_reclaimable[l].tolist()
        ptr, oom = int(interleave_ptr[l]), bool(oom_killed[l])
        pt, interleave = int(pt_policy[l]), int(data_policy[l]) == INTERLEAVE
        run = dict(all=(1 << N) - 1, alloc_mask=sum(1 << a for a in alloc),
                   interleave=interleave, bhi=pt == PT_BIND_HIGH,
                   bind_all=pt == PT_BIND_ALL, thp=bool(thp))
        advancing = torch.tensor([interleave and (r == 4 or pt == PT_FOLLOW_DATA)
                                  for r in range(5)])
        for t0 in range(0, T, WARP):
            span = min(T - t0, WARP)
            lanes = torch.arange(span)[:, None]
            reqs = torch.arange(5)[None, :]
            k0, r0, g0, passes = 0, 0, not oom, 0
            while k0 < span:
                passes += 1
                region = (lanes > k0) | ((lanes == k0) & (reqs >= r0))
                live = need[l, t0:t0 + span] & region
                # speculate from the predicates at the pass's start
                p = _preds(free, rec, wm)
                okb = torch.tensor([_request(run, p, r, 0, alloc[0])[1]
                                    for r in range(5)])
                fails = (live & ~okb).any(dim=1) & ((lanes[:, 0] != k0) | g0)
                first_fail = int(fails.int().argmax()) if fails.any() else WARP
                g = torch.where(lanes[:, 0] == k0, torch.tensor(g0),
                                ~torch.tensor(oom) & (lanes[:, 0] <= first_fail))
                acts = live & g[:, None]
                commit = acts & okb
                n_adv = (commit & advancing).sum(dim=1)
                before = torch.cumsum(n_adv, 0) - n_adv       # exclusive prefix
                picks = []
                for k in range(span):
                    cursor = _int32(ptr + int(before[k]))
                    row = []
                    for r in range(5):
                        row.append(_request(run, p, r,
                                            int(t0 + k >= n_threads // 2),
                                            alloc[cursor % len(alloc)]))
                        if commit[k, r] and advancing[r]:
                            cursor = _int32(cursor + 1)
                    picks.append(row)
                picked = torch.tensor([[q[0] for q in row] for row in picks])
                from_rec = torch.tensor([[q[3] for q in row] for row in picks])
                # verify: the first request at which a node's decrements of
                # one kind reach the count that makes a predicate fall
                falls = ([min(f - w if f > w else never, f if f > 0 else never)
                          for f, w in zip(free, wm)],
                         [r if r > 0 else never for r in rec])
                fall_at = torch.full((span,), 5)
                for n in sorted(set(picked[commit].tolist())):
                    for kind, of_kind in enumerate(
                            (commit & (picked == n) & ~from_rec,
                             commit & (picked == n) & from_rec)):
                        c = of_kind.sum(dim=1)
                        below = torch.cumsum(c, 0) - c
                        d = falls[kind][n]
                        for k in torch.nonzero((below < d) & (d <= below + c))[:, 0]:
                            r = int(torch.nonzero(of_kind[k])[d - int(below[k]) - 1])
                            fall_at[k] = min(int(fall_at[k]), r)
                kept = region
                next_k, next_r = span, 0
                if (fall_at < 5).any():
                    kf = int(torch.nonzero(fall_at < 5)[0])
                    rf = int(fall_at[kf])
                    kept = region & ((lanes < kf) | ((lanes == kf) & (reqs <= rf)))
                    next_k, next_r = (kf, rf + 1) if rf < 4 else (kf + 1, 0)
                # keep the requests up to the first fall
                taken = commit & kept
                for n, is_rec in zip(picked[taken].tolist(),
                                     from_rec[taken].tolist()):
                    if is_rec:
                        rec[n] = _int32(rec[n] - 1)
                    else:
                        free[n] = _int32(free[n] - 1)
                ptr = _int32(ptr + int((taken & advancing).sum()))
                oom = oom or bool((acts & ~okb & kept).any())
                out = slice(t0, t0 + span)
                nodes[l, out] = torch.where(kept, picked.to(torch.int32),
                                            nodes[l, out])
                slow[l, out] = torch.where(kept, torch.tensor(
                    [[q[2] for q in row] for row in picks]), slow[l, out])
                ok[l, out] = torch.where(kept, okb, ok[l, out])
                act[l, out] = torch.where(kept, acts, act[l, out])
                gate[l, out] = torch.where(kept[:, 0], g, gate[l, out])
                g0 = bool(g[next_k]) if next_r > 0 else not oom
                k0, r0 = next_k, next_r
            replayed += passes > 1
        free_out[l], rec_out[l] = torch.tensor(free), torch.tensor(rec)
        ptr_out[l], oom_out[l] = ptr, oom
    keep = in_row[..., None]
    nodes = torch.where(keep, nodes, -1)
    return (nodes, slow & keep, ok & keep, act, gate, free_out, rec_out,
            ptr_out, oom_out, replayed)


def alloc_scan_cases():
    """Crafted one-run inputs of ``ops.alloc_scan`` for the tests and
    ``chip_smoke.py`` [8]: most cross a predicate inside one chunk (the
    kernel then replays it), a few are built to be speculated.  Each is a
    dict of ``name``, ``machine`` (``MachineConfig`` keyword arguments),
    ``args`` (the nine tensors of one run, on the CPU), ``slot_thread``
    (``i32[1, G]`` or None) and ``replays``, the chunks the kernel replays.
    """
    import numpy as np

    from ..core import alloc
    from ..core.config import MachineConfig

    m2 = dict(n_threads=32, tier_pages_per_node=(600, 2400))  # wm 12, 48
    m3 = dict(n_threads=32, tier_pages_per_node=(600, 0, 2400))
    far = [20000, 20000, 100000, 100000]

    def requests(T, data=(), pt=()):
        """need_pt [T, 4], need_data [T] from thread lists (``pt`` holds
        (level, threads) pairs)."""
        need_pt, need_data = np.zeros((T, 4), bool), np.zeros(T, bool)
        need_data[list(data)] = True
        for lvl, threads in pt:
            need_pt[list(threads), lvl] = True
        return need_pt, need_data

    every = range(32)
    table = [
        # (name, machine, (data, pt) codes, free, reclaimable, requests,
        #  extra, replays)
        ("populate step far from every threshold", m2, (0, 10), far,
         [6, 6, 24, 24], requests(32, [t for t in every if t % 3 != 2],
                                  [(3, (0, 5))]), {}, 0),
        ("DRAM falls to its watermark", m2, (0, 10), [17, 17, 1000, 1000],
         [2] * 4, requests(32, every), {}, 1),
        ("DRAM falls to 0 free (bind-all)", m2, (0, 11), [3, 3, 1000, 1000],
         [100, 100, 0, 0], requests(32, pt=[(3, every)]), {}, 1),
        ("the reserve falls to 0 (bind-all)", m2, (0, 11), [0, 0, 1000, 1000],
         [4, 4, 0, 0], requests(32, pt=[(3, range(6))]), {}, 1),
        ("a failing request latches OOM mid-chunk", m2, (0, 11),
         [1, 1, 1000, 1000], [1, 0, 0, 0],
         requests(32, every, [(3, every)]), {}, 1),
        ("OOM latched mid-chunk, no threshold crossed", m2, (0, 11),
         [0, 0, 1000, 1000], [0] * 4, requests(32, range(16), [(3, (7,))]),
         {}, 0),
        ("interleave wraps over alloc_nodes past an empty tier", m3, (1, 10),
         [15, 15, 0, 0, 51, 1000], [1, 1, 0, 0, 1, 1],
         requests(32, every, [(3, range(0, 32, 4))]), dict(ptr=3), 1),
        ("interleave far from every threshold, the int32 cursor wrapping",
         m3, (1, 10), [1000, 1000, 0, 0, 5000, 5000], [1, 1, 0, 0, 1, 1],
         requests(32, every, [(3, range(0, 32, 4))]),
         dict(ptr=(1 << 31) - 20), 0),
        ("BHi falls back to the data order", m2, (0, 12), [2, 2, 1000, 1000],
         [0] * 4, requests(32, pt=[(2, every)]), {}, 1),
        ("BHi with no DRAM page: every upper page falls back", m2, (0, 12),
         [0, 0, 1000, 1000], [0] * 4,
         requests(32, range(8), [(0, (0,)), (1, (0, 16)), (2, range(0, 32, 3))]),
         {}, 0),
        ("THP binds the leaf to DRAM", dict(m2, page_order=9), (0, 12),
         [3, 3, 1000, 1000], [1, 1, 0, 0], requests(32, pt=[(3, every)]),
         {}, 1),
        ("T = 48: the watermark crossed in the second chunk",
         dict(m2, n_threads=48), (0, 10), [42, 32, 1000, 1000], [0] * 4,
         requests(48, range(48)), {}, 1),
        ("a slot row with pads, crossing", m2, (0, 10), [14, 14, 1000, 1000],
         [0] * 4, requests(32, every),
         dict(slots=[1, 4, 5, 9, 20, 21, 30]), 1),
        ("a slot row with pads, interleave far from every threshold", m2,
         (1, 10), far, [0] * 4, requests(32, every, [(3, every)]),
         dict(slots=[0, 2, 3, 8, 17, 31]), 0),
    ]
    cases = []
    for name, machine, (d, p), free, rec, (need_pt, need_data), extra, n in table:
        mc = MachineConfig(**machine)
        T = mc.n_threads
        args = (torch.tensor([free], dtype=torch.int32),
                torch.tensor([rec], dtype=torch.int32),
                torch.tensor([extra.get("ptr", 0)], dtype=torch.int32),
                torch.tensor([False]), alloc.watermark_pages(mc, "cpu"),
                torch.tensor([d], dtype=torch.int32),
                torch.tensor([p], dtype=torch.int32),
                torch.as_tensor(need_pt[None]), torch.as_tensor(need_data[None]))
        slots = None
        if "slots" in extra:
            row = extra["slots"] + [T] * (16 - len(extra["slots"]))
            slots = torch.tensor([row], dtype=torch.int32)
        cases.append(dict(name=name, machine=machine, args=args,
                          slot_thread=slots, replays=n))
    return cases


def set_magic(sets: int) -> tuple[int, int]:
    """``(magic, shift)`` with ``tag % sets == tag - (tag * magic >> shift)
    * sets`` for every ``0 <= tag < 2^31`` (``csrc/fast_window.cu``'s set
    index, no division on the card): ``shift = 31 + ceil(log2 sets)`` and
    ``magic = ceil(2^shift / sets) < 2^32``, so ``magic * sets - 2^shift
    < sets <= 2^(shift - 31)`` (Granlund and Montgomery, 1994, theorem
    4.2) and the product fits 63 bits."""
    if sets < 1:
        raise ValueError(f"sets must be >= 1, got {sets}")
    shift = 31 + (sets - 1).bit_length()
    return -(-(1 << shift) // sets), shift


def set_index(tag, sets: int):
    """``tag % sets`` for int64 ``tag`` in ``[0, 2^31)`` as the kernel
    computes it (:func:`set_magic`)."""
    magic, shift = set_magic(sets)
    return tag - ((tag * magic) >> shift) * sets


def _probe_sets(tags, lru, tag):
    """(hit, flat entry index) of one ``tag`` per cache of ``[N, sets,
    ways]``: the lowest matching way, else the lowest way of least lru
    (``core/tlbs.py``'s rule, kept here so the plain version stands alone)."""
    N, sets, ways = tags.shape
    row = torch.arange(0, N * sets, sets, device=tag.device) + tag % sets
    set_tags = tags.view(N * sets, ways).index_select(0, row)
    set_lru = lru.view(N * sets, ways).index_select(0, row)
    way_ids = torch.arange(ways, device=tag.device)
    hit_way = torch.where(set_tags == tag[:, None], way_ids, ways).amin(1)
    hit = hit_way < ways
    victim = ((set_lru.long() + 1) * ways + way_ids).amin(1) % ways
    return hit, row * ways + torch.where(hit, hit_way, victim)


def _touch(tags, lru, pos, tag, now, on):
    for arr, val in ((tags, tag), (lru, now)):
        flat = arr.view(-1)
        flat.index_copy_(0, pos, torch.where(on, val, flat.index_select(0, pos)))


def fast_window_rows(va, is_write, thr, oom_killed, nodes, lat, now0,
                     map_shift, radix_bits, llc_hit):
    """The segment's precompute (the JAX package's ``_build_fast_window``
    before its inner scan): placements are constant over an event-free
    segment, so every gather, Bernoulli draw and latency term is taken at
    once over ``[L, R, T]``.  ``llc_hit`` is each run's ``f32[L]``.
    Returns ``(m i32, flags bool[..., 4] (active, leaf / mid / top LLC
    hit), terms f32[..., 4] (leaf read, mid and top read on a miss, data
    cost))``; see :func:`fast_window_ref`."""
    L, R, T = va.shape
    dev = va.device
    data_node, leaf_node, mid_node, top_node = nodes
    read_lat, write_lat = lat
    rb = radix_bits
    llc_hit = llc_hit.view(L, 1, 1)
    m = torch.where(va >= 0, va >> map_shift, 0).clamp(0, data_node.shape[1] - 1)
    active = (va >= 0) & ~oom_killed[:, None, None]

    def node_lat(table, arr, idx):
        node = torch.gather(arr, 1, idx.clamp(max=arr.shape[1] - 1)
                            .reshape(L, -1).long())
        k = (node.long() + 1).clamp(0, table.shape[1] - 1)
        return table.gather(1, k).view(idx.shape)

    from ..core.sim import _site_seed, bern_hash
    # the four draws of sites 1-4 (leaf, mid, top, data) at once
    seeds = torch.tensor([_site_seed(site) for site in (1, 2, 3, 4)],
                         dtype=torch.int64, device=dev)[:, None, None, None]
    now = (int(now0) + torch.arange(R, device=dev))[None, :, None]
    draws = bern_hash(seeds, (
        torch.stack([m, m >> (2 * rb), m >> (3 * rb), m]), now,
        torch.arange(T, device=dev))) < thr.permute(2, 0, 1)[..., None]
    leaf_llc, up1_llc, up2_llc, data_llc = draws.unbind(0)
    leaf_read = torch.where(leaf_llc, llc_hit,
                            node_lat(read_lat, leaf_node, m >> rb))
    mid_read_miss = torch.where(up1_llc, llc_hit,
                                node_lat(read_lat, mid_node, m >> (2 * rb)))
    top_read_miss = torch.where(up2_llc, llc_hit,
                                node_lat(read_lat, top_node, m >> (3 * rb)))
    mem_lat = torch.where(is_write, node_lat(write_lat, data_node, m),
                          node_lat(read_lat, data_node, m))
    data_cost = torch.where(active, torch.where(data_llc, llc_hit, mem_lat),
                            0.0)
    flags = torch.stack([active, leaf_llc, up1_llc, up2_llc], -1)
    terms = torch.stack([leaf_read, mid_read_miss, top_read_miss, data_cost], -1)
    return m.to(torch.int32), flags, terms


def fast_window_ref(va, is_write, thr, oom_killed, nodes, lat, caches, acc,
                    counters, hot, row_counts, now0, map_shift, radix_bits,
                    thp, costs):
    """An event-free segment of steps, ``L`` runs of ``T`` simulated
    threads over ``R`` rows (the plain version of ``csrc/fast_window.cu``;
    the JAX package's ``_build_fast_window``): the precompute
    (:func:`fast_window_rows`), then the TLB and page-walk-cache chain row
    by row, the hotness counts and the counters.

    ``va i32[L, R, T]`` and ``is_write bool[L, R, T]`` the segment's trace
    rows; ``thr i64[L, R, 4]`` the draws' thresholds of sites 1-4 (leaf,
    mid, top, data) per row; ``oom_killed bool[L]``; ``nodes`` the
    ``i32[L, n]`` placements of data, leaf, mid and top pages; ``lat`` each
    run's ``f32[L, n_nodes + 1]`` read and write latencies at ``node + 1``;
    ``caches`` the (tags, lru) pairs ``i32[L, T, sets, ways]`` of the L1
    dTLB, STLB, PDE and PDPTE caches; ``acc`` the f32 ``[L, T]``
    accumulators of total, walk, stall and data-memory cycles;
    ``counters`` the i32 ``[L]`` counts of L1 hits, STLB hits, walks and
    walk reads; ``hot`` the i32 ``[L, n_map]`` access and write counts;
    ``row_counts`` three i32 ``[L, R]`` views to which each row's L1 hits,
    STLB hits and walks since the call, summed over threads, are added;
    row r is stamped ``now0 + r``; ``costs`` each run's ``f32[L, 4]``
    (llc_hit, stlb_hit, cpu_work, data_stall_frac).  Node ids index
    ``lat`` clamped to its length, and page ids the placements clamped to
    theirs.  Every tensor but the returned one is updated in place.
    Returns ``cum f32[L, R, 4, T]``: the four accumulators after each row,
    per thread."""
    L, R, T = va.shape
    N = L * T
    dev = va.device
    # each run's costs, one row per (run, thread)
    llc_hit, stlb_hit, cpu_work, frac = costs.repeat_interleave(T, 0).unbind(1)
    m_all, flags, terms = fast_window_rows(va, is_write, thr, oom_killed,
                                           nodes, lat, now0, map_shift,
                                           radix_bits, costs[:, 0])
    views = [(t.view(N, *t.shape[2:]), r.view(N, *r.shape[2:]))
             for t, r in caches]
    (l1, l1r), (stlb, stlbr), (pde, pder), (pdpte, pdpter) = views
    ct, cwk, cst, cdm = (a.view(N) for a in acc)
    cum = torch.empty((L, R, 4, T), dtype=torch.float32, device=dev)
    per_row = torch.empty((L, R, 3), dtype=torch.int32, device=dev)
    cnt = torch.zeros((4, N), dtype=torch.int32, device=dev)
    for r in range(R):
        now = int(now0) + r
        m_r = m_all[:, r].reshape(N)
        act, leaf_llc, up1, up2 = flags[:, r].reshape(N, 4).unbind(1)
        lread, mread, tread, dcost = terms[:, r].reshape(N, 4).unbind(1)
        leaf, mid = m_r >> radix_bits, m_r >> (2 * radix_bits)
        hit1, k1 = _probe_sets(l1, l1r, m_r)
        hit2, k2 = _probe_sets(stlb, stlbr, m_r)
        pde_hit, k3 = _probe_sets(pde, pder, leaf)
        pdpte_hit, k4 = _probe_sets(pdpte, pdpter, mid)
        walkn = act & ~hit1 & ~hit2
        mid_read = torch.where(pde_hit, 0.0, mread)
        full = ~pde_hit & ~pdpte_hit
        top_read = torch.where(full & (not thp), tread, 0.0)
        root_read = torch.where(full, llc_hit, 0.0)
        walk_cost = torch.where(walkn, lread + mid_read + top_read + root_read,
                                0.0)
        reads = (~leaf_llc).int() + (~pde_hit & ~up1).int() \
            + (full & ~up2 & (not thp)).int()
        walk_reads = torch.where(walkn, reads, 0)
        tlb_penalty = torch.where(act & ~hit1, stlb_hit, 0.0)
        stall = walk_cost + frac * dcost
        total = torch.where(act, cpu_work, 0.0) + tlb_penalty + stall
        _touch(l1, l1r, k1, m_r, now, act)
        _touch(stlb, stlbr, k2, m_r, now, act & ~hit1)
        _touch(pde, pder, k3, leaf, now, walkn)
        _touch(pdpte, pdpter, k4, mid, now, walkn)
        ct += total
        cwk += walk_cost
        cst += stall
        cdm += dcost
        cnt += torch.stack([(act & hit1).int(), (act & ~hit1 & hit2).int(),
                            walkn.int(), walk_reads.int()])
        cum[:, r] = torch.stack([ct, cwk, cst, cdm]).view(4, L, T) \
            .transpose(0, 1)
        per_row[:, r] = cnt[:3].view(3, L, T).sum(2, dtype=torch.int32).T
    for c, k in zip(counters, cnt.view(4, L, T).sum(2, dtype=torch.int32)):
        c += k
    for rc, k in zip(row_counts, per_row.unbind(2)):
        rc += k
    # integer adds commute, so one scatter-add for the segment
    n_map = hot[0].shape[1]
    idx = (m_all.long() + n_map * torch.arange(L, device=dev)[:, None, None]
           ).reshape(-1)
    hot[0].view(-1).index_add_(0, idx, flags[..., 0].reshape(-1).int())
    hot[1].view(-1).index_add_(0, idx, (flags[..., 0] & is_write)
                               .reshape(-1).int())
    return cum


# the costs ``fast_window_inputs`` gives every run unless told otherwise:
# CostConfig()'s (llc_hit, stlb_hit, cpu_work, data_stall_frac)
FAST_WINDOW_COSTS = (40.0, 10.0, 60.0, 0.6)


def fast_window_inputs(mc, L, R, T, seed, *, inactive=0.1, oom=False,
                       costs=None, step_major=False, device="cpu"):
    """Drawn arguments of ``ops.fast_window`` on machine ``mc``'s geometry:
    ``(args, kw)``, ``ops.fast_window(*args, **kw)``.  Granules come from
    a hot set of 16 (so every cache hits) and the whole map (so each
    misses); placements are drawn over the nodes and -1; each run draws
    its own latency tables; cache tags sit in their sets, a fifth of the
    ways are empty, and lru stamps share a few values (ties); ``inactive``
    rows have ``va = -1``; ``oom`` makes the state OOM-killed (every row
    inactive); ``costs`` is one (llc_hit, stlb_hit, cpu_work,
    data_stall_frac) per run (``FAST_WINDOW_COSTS`` for each by default);
    ``step_major`` lays the trace rows out as the engine keeps them,
    ``[R, L, ...]`` tables seen through transposed views.  The row counts
    are three columns of one ``[R, 9]`` table per run, as the timeline's."""
    g = torch.Generator().manual_seed(seed)
    rb, n_map = mc.radix_bits, mc.n_map
    hot = torch.randint(0, n_map, (16,), generator=g)

    def granules(shape):
        pick = torch.rand(shape, generator=g) < 0.7
        return torch.where(pick, hot[torch.randint(0, 16, shape, generator=g)],
                           torch.randint(0, n_map, shape, generator=g))

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32)

    m = granules((L, R, T))
    offset = torch.randint(0, 1 << mc.map_shift, (L, R, T), generator=g)
    live = torch.rand((L, R, T), generator=g) >= inactive
    va = torch.where(live, (m << mc.map_shift) + offset, -1).to(torch.int32)
    is_write = torch.rand((L, R, T), generator=g) < 0.4
    p = torch.tensor([0.3, 0.35, 0.35])
    thr = torch.empty((L, R, 4), dtype=torch.int64)
    thr[..., :3] = (p * (1 << 24)).long()
    thr[..., 3] = (torch.rand((L, R), generator=g) * (1 << 24)).long()
    oom_killed = torch.full((L,), bool(oom))
    nodes = [ints(-1, mc.n_nodes, (L, n)) for n in (
        n_map, mc.n_leaf_pages, mc.n_mid_pages, mc.n_top_pages)]
    lat = [(torch.rand((L, mc.n_nodes + 1), generator=g) * 600)
           .to(torch.float32) for _ in range(2)]
    now0 = 1000 + seed
    caches = []
    for sets, ways, shift in ((mc.l1_tlb_sets, mc.l1_tlb_ways, 0),
                              (mc.stlb_sets, mc.stlb_ways, 0),
                              (1, mc.pde_pwc_entries, rb),
                              (1, mc.pdpte_pwc_entries, 2 * rb)):
        shape = (L, T, sets, ways)
        cand = granules(shape) >> shift
        tags = cand // sets * sets + torch.arange(sets)[:, None]
        empty = torch.rand(shape, generator=g) < 0.2
        tags = torch.where(empty, -1, tags).to(torch.int32)
        lru = now0 - 1 - torch.randint(0, 6, shape, generator=g)
        lru = torch.where(empty, -1, lru).to(torch.int32)
        caches.append((tags, lru))
    acc = [(torch.rand((L, T), generator=g) * 1e6).to(torch.float32)
           for _ in range(4)]
    counters = [ints(0, 1 << 20, (L,)) for _ in range(4)]
    hot_counts = [ints(0, 100, (L, n_map)) for _ in range(2)]
    table = ints(0, 1 << 20, (L, R, 9))
    cost_rows = torch.tensor([FAST_WINDOW_COSTS] * L if costs is None
                             else [tuple(c) for c in costs], dtype=torch.float32)
    if step_major:
        va, is_write, thr = (x.transpose(0, 1).contiguous()
                             for x in (va, is_write, thr))
    args = [va, is_write, thr, oom_killed, nodes, lat, caches, acc, counters,
            hot_counts, table, cost_rows]
    args = _to_device(args, device)
    cost_rows, table = args.pop(), args.pop()
    if step_major:
        args[:3] = (x.transpose(0, 1) for x in args[:3])
    args.append([table[..., c] for c in (7, 8, 4)])
    kw = dict(now0=now0, map_shift=mc.map_shift, radix_bits=rb,
              thp=mc.page_order > 0, costs=cost_rows)
    return args, kw


def _to_device(obj, device):
    """A copy of a nest of lists of tensors on ``device``."""
    if isinstance(obj, (list, tuple)):
        return [_to_device(x, device) for x in obj]
    return obj.to(device).clone()
