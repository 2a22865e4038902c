"""Public wrappers of the port's kernels (twin of the JAX package's
``kernels/ops.py``).

Each wrapper checks device, dtype, shape and contiguity, then dispatches
on where the tensors lie: on a CUDA device it launches the hand-written
kernel (and raises if the launch fails), on the CPU it runs the plain
version in :mod:`.ref`.  There is no other route and no fallback.
"""
from __future__ import annotations

import math

import torch

from . import alloc_scan as _alloc_scan
from . import block_copy as _block_copy
from . import fast_window as _fast_window
from . import paged_attention as _paged_attention
from . import pt_walk as _pt_walk
from . import ref


def _check(cond: bool, name: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _same_device(name: str, *tensors) -> torch.device:
    dev = tensors[0].device
    _check(all(t.device == dev for t in tensors), name,
           f"tensors lie on different devices: {[str(t.device) for t in tensors]}")
    _check(dev.type in ("cuda", "cpu"), name, f"unsupported device {dev}")
    return dev


def _check_walk(name, upper, leaf_tier, leaf_entries, vb, *more):
    """The rules both walks share; returns the tensors' device."""
    dev = _same_device(name, upper, leaf_tier, leaf_entries, vb, *more)
    for t in (upper, leaf_tier, leaf_entries, vb, *more):
        _check(t.dtype == torch.int32, name, f"needs int32, got {t.dtype}")
    for t in (upper, leaf_tier, vb, *more):
        _check(t.is_contiguous(), name, "needs contiguous tensors")
    _check(leaf_entries.dim() == 2, name, "leaf_entries must be [n_leaf, F]")
    _check(leaf_tier.shape == leaf_entries.shape[:1], name,
           "leaf_tier must be [n_leaf] like leaf_entries")
    _check(vb.dim() == 1, name, "vb must be [N]")
    _check(upper.shape[-1] > 0 and leaf_entries.shape[0] > 0, name,
           "the upper row and the leaf table must not be empty")
    return dev


def pt_walk(upper, leaf_tier, leaf_entries, vb):
    """Walk the two-level table (see ``ref.pt_walk_ref``).

    ``upper`` is one row ``i32[max_leaf]`` -> outputs ``i32[N]``, or a
    batch of rows ``i32[R, max_leaf]`` -> ``i32[R, N]`` in one launch.
    ``leaf_entries`` may be a strided view (e.g. the slot column of a
    ``[n_leaf, F, 2]`` table); the other tensors must be contiguous.
    """
    name = "pt_walk"
    dev = _check_walk(name, upper, leaf_tier, leaf_entries, vb)
    _check(upper.dim() in (1, 2), name, f"upper must be 1-D or 2-D, got {tuple(upper.shape)}")
    if dev.type == "cpu":
        return ref.pt_walk_ref(upper, leaf_tier, leaf_entries, vb)
    tier, slot = _pt_walk.pt_walk_cuda(upper.reshape(-1, upper.shape[-1]),
                                       leaf_tier, leaf_entries, vb)
    if upper.dim() == 1:
        return tier[0], slot[0]
    return tier, slot


def pt_walk_rows_any(upper, rows, leaf_tier, leaf_entries, vb, tier: int):
    """``flags i32[R]``: ``flags[r] == 1`` where a walk of row ``rows[r]``
    of ``upper`` (``i32[n_rows, max_leaf]``) for the queries ``vb`` reads
    a leaf page of tier ``tier``, else 0 (see
    ``ref.pt_walk_rows_any_ref``).  The gather of the rows, the walk and
    the reduction are one launch, which writes no ``(tier, slot)``."""
    name = "pt_walk_rows_any"
    dev = _check_walk(name, upper, leaf_tier, leaf_entries, vb, rows)
    _check(upper.dim() == 2, name, f"upper must be [n_rows, max_leaf], got "
           f"{tuple(upper.shape)}")
    _check(rows.dim() == 1, name, f"rows must be [R], got {tuple(rows.shape)}")
    _check(upper.shape[0] > 0, name, "the upper table must not be empty")
    if dev.type == "cpu":
        return ref.pt_walk_rows_any_ref(upper, rows, leaf_tier, leaf_entries,
                                        vb, tier)
    return _pt_walk.pt_walk_cuda(upper, leaf_tier, leaf_entries, vb,
                                 rows=rows, flag_tier=int(tier))


MAX_POOL_PAIRS = _block_copy.MAX_PAIRS


def block_copy_pools(pairs, ids, *, name: str = "block_copy_pools"):
    """For every ``(src_pool, dst_pool)`` of ``pairs``: ``dst_pool[...,
    ids[m,1]] = src_pool[..., ids[m,0]]`` in place, all pairs in one
    launch; returns the destination pools.

    Pools are ``[P, bs, KH, Dh]`` or ``[G, P, bs, KH, Dh]`` (one launch
    for all groups); a pair's two pools may differ in ``P`` only, and
    every pair has the shapes and dtype of the first.  No source may be a
    destination, and no destination repeats.  A block's size in bytes and
    every pool's base address must be multiples of 16.  ``ids`` is
    ``i32[M, 2]`` (src, dst), shared by the pairs.  Ids outside the pools
    follow the JAX oracle: a negative id counts from the end of its pool
    once, a source is then clamped into ``[0, P_src - 1]``, and a pair
    whose destination is still outside ``[0, P_dst)`` is dropped.  Where
    two pairs name one destination, which one is written last is
    undefined.  At most ``MAX_POOL_PAIRS`` pairs (2: a migration's K and
    V pools).
    """
    pairs = tuple(pairs)
    _check(1 <= len(pairs) <= MAX_POOL_PAIRS, name,
           f"takes 1 to {MAX_POOL_PAIRS} pool pairs, got {len(pairs)}")
    src0, dst0 = pairs[0]
    dev = _same_device(name, ids, *(t for pair in pairs for t in pair))
    _check(ids.dtype == torch.int32 and ids.dim() == 2 and ids.shape[1] == 2,
           name, f"ids must be int32 [M, 2], got {ids.dtype} {tuple(ids.shape)}")
    _check(ids.is_contiguous(), name, "needs contiguous tensors")
    for src_pool, dst_pool in pairs:
        _check(src_pool.dtype == dst_pool.dtype, name,
               f"pool dtypes differ: {src_pool.dtype} vs {dst_pool.dtype}")
        _check(src_pool.dim() == dst_pool.dim() and src_pool.dim() in (4, 5),
               name, "pools must both be [P, bs, KH, Dh] or both [G, P, bs, KH, Dh]")
        lead = src_pool.dim() - 4
        _check(src_pool.shape[:lead] == dst_pool.shape[:lead]
               and src_pool.shape[lead + 1:] == dst_pool.shape[lead + 1:], name,
               f"pools differ beyond P: {tuple(src_pool.shape)} vs "
               f"{tuple(dst_pool.shape)}")
        _check(src_pool.shape == src0.shape and dst_pool.shape == dst0.shape
               and src_pool.dtype == src0.dtype, name,
               "every pair must have the shapes and dtype of the first")
        _check(src_pool.is_contiguous() and dst_pool.is_contiguous(), name,
               "needs contiguous tensors")
        block_bytes = (math.prod(src_pool.shape[lead + 1:])
                       * src_pool.element_size())
        _check(block_bytes % 16 == 0, name,
               f"a block of {block_bytes} B is not a multiple of 16 B")
        _check(src_pool.data_ptr() % 16 == 0 and dst_pool.data_ptr() % 16 == 0,
               name, "pools must start on a 16-byte boundary")
    srcs = {s.data_ptr() for s, _ in pairs}
    dsts = [d.data_ptr() for _, d in pairs]
    _check(srcs.isdisjoint(dsts), name,
           "source and destination must be different pools")
    _check(len(set(dsts)) == len(dsts), name, "a destination pool repeats")
    if dev.type == "cpu":
        return tuple(ref.block_copy_ref(s, d, ids) for s, d in pairs)
    if src0.dim() == 4:
        _block_copy.block_copy_cuda([(s[None], d[None]) for s, d in pairs], ids)
    else:
        _block_copy.block_copy_cuda(pairs, ids)
    return tuple(d for _, d in pairs)


def block_copy(src_pool, dst_pool, ids):
    """``dst_pool[..., ids[m,1]] = src_pool[..., ids[m,0]]`` in place;
    returns ``dst_pool``.  The one-pair case of :func:`block_copy_pools`
    (same rules, same kernel)."""
    return block_copy_pools(((src_pool, dst_pool),), ids, name="block_copy")[0]


def paged_attention(q, k_pool, v_pool, tables, lengths):
    """Decode attention over paged KV pools, in the JAX package's public
    layout: ``q [B, H, Dh]`` with ``H = KH * G``, pools ``[KH, P, bs,
    Dh]``, ``tables i32[B, NB]``, ``lengths i32[B]`` -> ``[B, H, Dh]``.
    Query head ``h`` reads KV head ``h // G``.  See
    ``ref.paged_attention_ref`` for the edge semantics (``-1`` entries,
    ``lengths == 0``).  Both routes take float32, bfloat16 and float16,
    any head dim that is a multiple of 16 up to 256 and any block size
    of at least 1; they refuse float64 and every other head dim
    (``paged_attention.check_args``).  On the card a call is one launch
    whose splits merge through arrival counters kept per (device,
    stream): calls on one stream follow each other, and calls on two
    streams never share counters."""
    _check(q.dim() == 3, "paged_attention", f"q must be [B, H, Dh], got "
           f"{tuple(q.shape)}")
    B, H, Dh = q.shape
    KH = k_pool.shape[0] if k_pool.dim() == 4 else 0
    _check(KH > 0 and H % KH == 0, "paged_attention",
           f"{H} query heads do not group over the pools' KV heads "
           f"{tuple(k_pool.shape)}")
    qk = q.reshape(B, KH, H // KH, Dh)
    if q.device.type == "cpu":
        _paged_attention.check_args(qk, k_pool, v_pool, tables, lengths)
        out = ref.paged_attention_ref(qk, k_pool, v_pool, tables, lengths)
    else:
        out = _paged_attention.paged_attention_cuda(qk, k_pool, v_pool,
                                                    tables, lengths)
    return out.reshape(B, H, Dh)


MAX_ALLOC_NODES = 16      # csrc/alloc_scan.cu: node i's counts in warp lane i
# csrc/fast_window.cu stages a thread's four caches (tag and stamp, 8 B an
# entry) in at most 216 KiB of shared memory
MAX_STAGED_ENTRIES = 216 * 1024 // 8


def alloc_scan(node_free, node_reclaimable, interleave_ptr, oom_killed, wm,
               data_policy, pt_policy, need_pt, need_data, *, n_threads: int,
               alloc_nodes, thp: bool, slot_thread=None):
    """The allocator of one fault step, serially over the threads, for
    ``L`` runs at once (see ``ref.alloc_scan_ref`` for the semantics).

    ``node_free``, ``node_reclaimable`` ``i32[L, N]``; ``interleave_ptr``
    ``i32[L]``; ``oom_killed`` ``bool[L]``; ``wm`` ``i32[N]``;
    ``data_policy``, ``pt_policy`` ``i32[L]``; ``need_pt`` ``bool[L, T,
    4]``; ``need_data`` ``bool[L, T]``; the machine's ``n_threads``, its
    allocatable nodes (ascending, as ``MachineConfig.alloc_nodes``) and its
    THP flag; ``slot_thread`` (``i32[L, G]`` or None) each run's slot row,
    the reference's compacted scan (a thread outside it requests nothing
    and reports node -1, slow and ok False; an entry outside ``[0, T)`` is
    a pad).  ``N`` is even (two nodes per tier) and at most
    ``MAX_ALLOC_NODES``.  Returns ``(nodes i32[L, T, 5], slow, ok, act
    bool[L, T, 5], gate bool[L, T], node_free', node_reclaimable',
    interleave_ptr', oom_killed')``; the inputs are not written.  On the
    card the kernel also counts the chunks it replayed
    (``alloc_scan.replays()``)."""
    name = "alloc_scan"
    tensors = (node_free, node_reclaimable, interleave_ptr, oom_killed, wm,
               data_policy, pt_policy, need_pt, need_data)
    dev = _same_device(name, *tensors,
                       *(() if slot_thread is None else (slot_thread,)))
    for t in tensors:
        _check(t.is_contiguous(), name, "needs contiguous tensors")
    for t in (oom_killed, need_pt, need_data):
        _check(t.dtype == torch.bool, name, f"needs bool masks, got {t.dtype}")
    for t in (node_free, node_reclaimable, interleave_ptr, wm, data_policy,
              pt_policy):
        _check(t.dtype == torch.int32, name, f"needs int32, got {t.dtype}")
    _check(need_data.dim() == 2, name, "need_data must be [L, T]")
    L, T = need_data.shape
    N = wm.shape[0] if wm.dim() == 1 else -1
    _check(2 <= N <= MAX_ALLOC_NODES and N % 2 == 0, name,
           f"wm must be [N] with N even and at most {MAX_ALLOC_NODES}")
    _check(node_free.shape == (L, N) and node_reclaimable.shape == (L, N),
           name, "node_free and node_reclaimable must be [L, N]")
    for t in (interleave_ptr, oom_killed, data_policy, pt_policy):
        _check(t.shape == (L,), name, "the per-lane carry and codes must be [L]")
    _check(need_pt.shape == (L, T, 4), name, "need_pt must be [L, T, 4]")
    if slot_thread is not None:
        _check(slot_thread.dtype == torch.int32 and slot_thread.dim() == 2
               and slot_thread.shape[0] == L and slot_thread.is_contiguous(),
               name, "slot_thread must be a contiguous i32[L, G]")
    alloc_nodes = tuple(int(a) for a in alloc_nodes)
    _check(len(alloc_nodes) > 0 and all(0 <= a < N for a in alloc_nodes)
           and alloc_nodes == tuple(sorted(set(alloc_nodes))), name,
           f"allocatable nodes {alloc_nodes} must be ascending in [0, {N})")
    if dev.type == "cpu":
        return ref.alloc_scan_ref(*tensors, n_threads, alloc_nodes, bool(thp),
                                  slot_thread)
    mask = sum(1 << a for a in alloc_nodes)
    return _alloc_scan.alloc_scan_cuda(*tensors, slot_thread, n_threads, mask,
                                       bool(thp))


def fast_window(va, is_write, thr, oom_killed, nodes, lat, caches, acc,
                counters, hot, row_counts, *, now0: int, map_shift: int,
                radix_bits: int, thp: bool, costs):
    """An event-free segment of steps in one launch, for ``L`` runs of
    ``T`` simulated threads over ``R`` rows: the precompute (granules,
    placements, Bernoulli draws, latency terms), the TLB and page-walk-cache
    chain, the hotness counts and the integer counters (see
    ``ref.fast_window_ref`` for the semantics and layouts).

    ``va`` ``i32[L, R, T]``; ``is_write`` ``bool[L, R, T]`` with ``va``'s
    strides; ``thr`` ``i64[L, R, 4]`` (the three may be windows of larger
    tables: each needs unit stride along its last axis only);
    ``oom_killed`` ``bool[L]``; ``nodes`` four ``i32[L, n]`` (data, leaf,
    mid, top); ``lat`` two ``f32[L, K]`` (each run's read and write
    latencies at ``node + 1``); ``caches`` four ``(tags, lru)`` pairs
    ``i32[L, T, sets, ways]`` (L1 dTLB, STLB, PDE and PDPTE; the walk
    caches have one set; any number of ways); ``acc`` four ``f32[L, T]``;
    ``counters`` four ``i32[L]``; ``hot`` two ``i32[L, n_map]``;
    ``row_counts`` three ``i32[L, R]`` views of one stride (they may be
    columns of a table); ``costs`` ``f32[L, 4]``, each run's (llc_hit,
    stlb_hit, cpu_work, data_stall_frac).  The caches' stamps are below
    ``now0``.  The kernel stages a thread's four caches in shared memory:
    together at most ``MAX_STAGED_ENTRIES`` (27,648) entries, each array
    counted padded to a multiple of 4 (a 1,536-entry STLB stages 12 KB).
    Updates every tensor after ``lat`` in place and returns ``cum f32[L,
    R, 4, T]``."""
    name = "fast_window"
    nodes, lat, acc, counters, hot, row_counts = (
        tuple(x) for x in (nodes, lat, acc, counters, hot, row_counts))
    caches = tuple(tuple(pair) for pair in caches)
    _check(len(nodes) == 4 and len(lat) == 2 and len(caches) == 4
           and all(len(p) == 2 for p in caches) and len(acc) == 4
           and len(counters) == 4 and len(hot) == 2 and len(row_counts) == 3,
           name, "takes four placements, two latency tables, four (tags, "
           "lru) pairs, four accumulators, four counters, two hotness "
           "counts and three row counts")
    flat = [t for pair in caches for t in pair]
    dev = _same_device(name, va, is_write, thr, oom_killed, *nodes, *lat,
                       costs, *flat, *acc, *counters, *hot, *row_counts)
    _check(va.dtype == torch.int32 and va.dim() == 3 and va.stride(2) == 1,
           name, f"va must be int32 [L, R, T] with unit stride along T, got "
           f"{va.dtype} {tuple(va.shape)}")
    L, R, T = va.shape
    _check(is_write.dtype == torch.bool and is_write.shape == (L, R, T)
           and is_write.stride() == va.stride(), name,
           "is_write must be bool [L, R, T] with va's strides")
    _check(thr.dtype == torch.int64 and thr.shape == (L, R, 4)
           and thr.stride(2) == 1, name,
           "thr must be int64 [L, R, 4] with unit stride along its last axis")
    _check(oom_killed.dtype == torch.bool and oom_killed.shape == (L,), name,
           "oom_killed must be bool [L]")
    for t in nodes:
        _check(t.dtype == torch.int32 and t.dim() == 2 and t.shape[0] == L
               and t.shape[1] > 0, name, "the placements must be int32 [L, n]")
    for t in lat:
        _check(t.dtype == torch.float32 and t.shape == lat[0].shape
               and t.dim() == 2 and t.shape[0] == L and t.shape[1] > 0, name,
               "the latency tables must be float32 [L, K]")
    _check(torch.is_tensor(costs) and costs.dtype == torch.float32
           and costs.shape == (L, 4), name, "costs must be float32 [L, 4]")
    for tags, lru in caches:
        _check(tags.dtype == torch.int32 and lru.dtype == torch.int32
               and tags.dim() == 4 and tags.shape == lru.shape
               and tags.shape[:2] == (L, T) and tags.numel() > 0, name,
               "each cache must be an int32 (tags, lru) pair [L, T, sets, ways]")
    for tags, _ in caches[2:]:
        _check(tags.shape[2] == 1, name, "the walk caches have one set")
    staged = sum(-(-tags.shape[2] * tags.shape[3] // 4) * 4 for tags, _ in caches)
    _check(staged <= MAX_STAGED_ENTRIES, name,
           f"a thread's caches hold {staged} entries (padded), more than the "
           f"{MAX_STAGED_ENTRIES} the kernel stages in shared memory")
    for a in acc:
        _check(a.dtype == torch.float32 and a.shape == (L, T), name,
               "the accumulators must be float32 [L, T]")
    for c in counters:
        _check(c.dtype == torch.int32 and c.shape == (L,), name,
               "the counters must be int32 [L]")
    for h in hot:
        _check(h.dtype == torch.int32 and h.shape == nodes[0].shape, name,
               "the hotness counts must be int32 [L, n_map]")
    for rc in row_counts:
        _check(rc.dtype == torch.int32 and rc.shape == (L, R)
               and rc.stride() == row_counts[0].stride(), name,
               "the row counts must be int32 [L, R] views of one stride")
    for t in (oom_killed, *nodes, *lat, costs, *flat, *acc, *counters, *hot):
        _check(t.is_contiguous(), name, "needs contiguous tensors")
    _check(0 <= int(radix_bits) <= 15 and 0 <= int(map_shift) <= 30, name,
           "radix_bits must be in [0, 15] and map_shift in [0, 30]")
    # the kernel ranks a set's ways by ways * (lru + 2) + way in 32 bits
    max_ways = max(tags.shape[3] for tags, _ in caches)
    _check(0 <= int(now0) and (int(now0) + R + 3) * max_ways < 1 << 32, name,
           f"step stamps up to {int(now0) + R} do not fit the kernel's "
           f"32-bit way ranking at {max_ways} ways")
    if dev.type == "cpu":
        return ref.fast_window_ref(va, is_write, thr, oom_killed, nodes, lat,
                                   caches, acc, counters, hot, row_counts,
                                   now0, map_shift, radix_bits, thp, costs)
    return _fast_window.fast_window_cuda(
        va, is_write, thr, oom_killed, nodes, lat, caches, acc, counters, hot,
        row_counts, now0, map_shift, radix_bits, thp, costs)


def launch_counts() -> dict:
    """Calls that launched each kernel since the last
    :func:`reset_launches` (one ``paged_attention``, ``alloc_scan`` or
    ``fast_window`` call is one launch; ``pt_walk_rows_any`` counts as a
    ``pt_walk`` launch, ``block_copy_pools`` as one ``block_copy`` launch
    whatever its number of pairs)."""
    return {"pt_walk": _pt_walk.launches, "block_copy": _block_copy.launches,
            "paged_attention": _paged_attention.launches,
            "alloc_scan": _alloc_scan.launches,
            "fast_window": _fast_window.launches}


def reset_launches() -> None:
    """Set every launch count to 0, and the allocator kernel's device count
    of replayed chunks."""
    _alloc_scan.reset()
    _pt_walk.launches = 0
    _block_copy.launches = 0
    _paged_attention.launches = 0
    _fast_window.launches = 0
