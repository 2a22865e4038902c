"""Tiered paged KV cache with a Radiant-managed two-level block table
(twin of the JAX package's ``memsys/tiered_kv.py``).

Two block pools per attention group, HOT and COLD (a second device buffer,
as in the reference), and a two-level table: the *upper* level (sequence
-> leaf page id) never moves, *leaf pages* of ``FANOUT`` (tier, slot)
entries carry a tier of their own.  Radiant invariant (Algorithm 1): a
leaf page is HOT iff at least one block it maps is hot.

:class:`TieredKV` is a dataclass of tensors on one device.  The ops
update it **in place** (that saves copying the pools on every token) and
return it.  Their bookkeeping is the reference's masked tensor code
step for step, so it runs on the device without reading values back;
``migrate_sequence`` and ``release_sequence`` read the sequence length
once to bound their loop.  The data path of a migration is the
``block_copy`` kernel, one launch for its K and V pools
(:func:`repro_torch.kernels.ops.block_copy_pools`).

Where JAX silently clamps an out-of-range read or drops an out-of-range
write, PyTorch raises, so the reference's behaviour is matched on purpose:
``_pop`` on an empty list reads the last entry (JAX wraps index -1);
``_push`` onto a full list writes nothing (JAX drops the scatter) but
still advances the top where selected; reads of the hot pool by a cold
slot id are clamped as JAX clamps gathers.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops

I32 = torch.int32
HOT, COLD = 0, 1
FANOUT = 64          # block-table entries per leaf page

STAT_BLK_PROMOTE, STAT_BLK_DEMOTE, STAT_LEAF_PROMOTE, STAT_LEAF_DEMOTE, \
    STAT_LEAF_ALREADY, STAT_FALLBACK = range(6)


@dataclasses.dataclass
class TieredKV:
    # pools: [G, n_blocks, block_size, KH, Dh]
    hot_k: torch.Tensor
    hot_v: torch.Tensor
    cold_k: torch.Tensor
    cold_v: torch.Tensor
    # hierarchical block table
    upper: torch.Tensor              # i32[n_seqs, max_leaf] -> leaf page id
    leaf_tier_slot: torch.Tensor     # i32[n_leaf, FANOUT, 2] (tier, slot)
    leaf_tier: torch.Tensor          # i32[n_leaf] tier of the leaf page
    leaf_hot_children: torch.Tensor  # i32[n_leaf]
    # allocators (stack free lists); the tops are 0-d tensors
    hot_free: torch.Tensor
    hot_free_top: torch.Tensor
    cold_free: torch.Tensor
    cold_free_top: torch.Tensor
    leaf_free: torch.Tensor
    leaf_free_top: torch.Tensor
    seq_len: torch.Tensor            # i32[n_seqs] tokens written
    stats: torch.Tensor              # i32[6], the STAT_* counters


FIELDS = tuple(f.name for f in dataclasses.fields(TieredKV))
POOLS = ("hot_k", "hot_v", "cold_k", "cold_v")


def init(n_groups: int, n_hot: int, n_cold: int, block_size: int,
         kv_heads: int, head_dim: int, n_seqs: int, max_seq: int,
         dtype=torch.bfloat16, device=None) -> TieredKV:
    dev = resolve_device(device)
    max_blocks = -(-max_seq // block_size)
    max_leaf = -(-max_blocks // FANOUT)
    n_leaf = n_seqs * max_leaf            # worst case: no sharing

    def pool(n):
        return torch.zeros((n_groups, n, block_size, kv_heads, head_dim),
                           dtype=dtype, device=dev)

    def full(shape, v):
        return torch.full(shape, v, dtype=I32, device=dev)

    def stack(n):       # free list n-1 .. 0 (pop takes slot 0 first)
        return torch.arange(n - 1, -1, -1, dtype=I32, device=dev)

    return TieredKV(
        hot_k=pool(n_hot), hot_v=pool(n_hot),
        cold_k=pool(n_cold), cold_v=pool(n_cold),
        upper=full((n_seqs, max_leaf), -1),
        leaf_tier_slot=full((n_leaf, FANOUT, 2), -1),
        leaf_tier=full((n_leaf,), -1),
        leaf_hot_children=full((n_leaf,), 0),
        hot_free=stack(n_hot), hot_free_top=full((), n_hot),
        cold_free=stack(n_cold), cold_free_top=full((), n_cold),
        leaf_free=stack(n_leaf), leaf_free_top=full((), n_leaf),
        seq_len=full((n_seqs,), 0),
        stats=full((6,), 0),
    )


def block_size_of(kv: TieredKV) -> int:
    return kv.hot_k.shape[2]


def from_numpy(arrays: dict, device=None) -> TieredKV:
    """A ``TieredKV`` from numpy arrays keyed by field name, such as the
    fields of the JAX package's ``TieredKV`` (bfloat16 arrays included)."""
    dev = resolve_device(device)

    def tensor(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16).to(dev)
        return torch.from_numpy(a.copy()).to(dev)

    return TieredKV(**{f: tensor(arrays[f]) for f in FIELDS})


def to_numpy(kv: TieredKV) -> dict:
    """Every field as a numpy array; bfloat16 pools come back widened to
    float32 (exact), since numpy has no bfloat16 of its own."""
    def array(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return {f: array(getattr(kv, f)) for f in FIELDS}


# ---------------------------------------------------------------------------
# allocation
# ---------------------------------------------------------------------------
def _pop(free, top):
    """``(free[top - 1], top - 1)``; on an empty list reads the last entry,
    as JAX wraps index -1.  Callers select the result with a mask."""
    top = top - 1
    return free[top.remainder(free.shape[0])], top


def _push(free, top, slot, sel):
    """In place, where ``sel``: ``free[top] = slot; top += 1``.

    The reference computes this scatter on every call and JAX drops it
    when ``top == len(free)`` (a push onto a full list, e.g. releasing an
    all-hot sequence computes a push onto the full cold list).  Here the
    write is masked by ``sel & (top < len)`` and its index clamped, so it
    never reaches memory; ``top`` advances where ``sel``, as in JAX.
    """
    n = free.shape[0]
    i = top.clamp(max=n - 1)
    free[i] = torch.where(sel & (top < n), slot, free[i])
    top += sel


def _add(t, idx, x):
    t[idx] += x.to(t.dtype)


def append_token(kv: TieredKV, seq: int, k: torch.Tensor, v: torch.Tensor
                 ) -> TieredKV:
    """Write one token's KV ([G, KH, Dh]) for sequence ``seq``, in place.

    Allocates a hot block (cold fallback when the hot pool is exhausted)
    and a leaf table page on block / leaf boundaries.  Appending past the
    ``max_seq`` the cache was built for raises.
    """
    bs = block_size_of(kv)
    pos = kv.seq_len[seq].clone()
    blk = pos // bs
    off = pos % bs
    leaf_idx = blk // FANOUT
    entry = blk % FANOUT

    # --- leaf page allocation on first touch (upper level stays pinned) ----
    leaf_id = kv.upper[seq][leaf_idx]
    need_leaf = leaf_id < 0
    new_leaf, leaf_top = _pop(kv.leaf_free, kv.leaf_free_top)
    leaf_id = torch.where(need_leaf, new_leaf, leaf_id)
    kv.upper[seq][leaf_idx] = leaf_id
    kv.leaf_free_top.copy_(torch.where(need_leaf, leaf_top, kv.leaf_free_top))

    # --- block allocation on block boundary --------------------------------
    # (if both pools are exhausted no block is allocated: the reference
    # then writes the token through the stale entry; so does this)
    hot_ok = kv.hot_free_top > 0
    cold_ok = kv.cold_free_top > 0
    need_blk = (off == 0) & (hot_ok | cold_ok)
    hot_slot, hot_top = _pop(kv.hot_free, kv.hot_free_top)
    cold_slot, cold_top = _pop(kv.cold_free, kv.cold_free_top)
    tier = torch.where(hot_ok, HOT, COLD).to(I32)
    slot = torch.where(hot_ok, hot_slot, cold_slot)
    kv.hot_free_top.copy_(torch.where(need_blk & hot_ok, hot_top,
                                      kv.hot_free_top))
    kv.cold_free_top.copy_(torch.where(need_blk & ~hot_ok, cold_top,
                                       kv.cold_free_top))
    old = kv.leaf_tier_slot[leaf_id, entry]
    tier = torch.where(need_blk, tier, old[0])
    slot = torch.where(need_blk, slot, old[1])
    kv.leaf_tier_slot[leaf_id, entry] = torch.stack([tier, slot])
    # a fresh leaf table page follows its first data block's tier
    kv.leaf_tier[leaf_id] = torch.where(need_leaf, tier, kv.leaf_tier[leaf_id])
    _add(kv.leaf_hot_children, leaf_id, need_blk & (tier == HOT))
    _add(kv.stats, STAT_FALLBACK, need_blk & ~hot_ok)

    # --- write the token (masked into whichever pool owns the block) -------
    is_hot = tier == HOT
    hot_idx = torch.where(is_hot, slot, 0)
    cold_idx = torch.where(is_hot, 0, slot)
    for pool, val, idx, sel in ((kv.hot_k, k, hot_idx, is_hot),
                                (kv.hot_v, v, hot_idx, is_hot),
                                (kv.cold_k, k, cold_idx, ~is_hot),
                                (kv.cold_v, v, cold_idx, ~is_hot)):
        pool[:, idx, off] = torch.where(sel, val.to(pool.dtype),
                                        pool[:, idx, off])

    kv.seq_len[seq] += 1
    # beyond the paper, as in the reference: allocation also triggers the
    # leaf page (a hot block under a cold leaf promotes the leaf)
    return _leaf_trigger(kv, leaf_id, need_blk)


# ---------------------------------------------------------------------------
# lookup / gather (the "page walk"; plain tensor code, not the pt_walk
# kernel: the tier here is the *block's*, pt_walk's is the leaf page's)
# ---------------------------------------------------------------------------
def lookup_blocks(kv: TieredKV, seq: int, n_blocks: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Virtual blocks 0..n_blocks-1 of ``seq`` -> (tier, slot), each
    ``i32[n_blocks]``; -1 where the upper entry is unallocated."""
    vb = torch.arange(n_blocks, device=kv.upper.device)
    # JAX clamps the upper read when n_blocks outruns the table
    leaf_ids = kv.upper[seq, (vb // FANOUT).clamp(max=kv.upper.shape[1] - 1)]
    ts = kv.leaf_tier_slot[leaf_ids.clamp(min=0), vb % FANOUT]
    valid = leaf_ids >= 0
    return (torch.where(valid, ts[:, 0], -1).to(I32),
            torch.where(valid, ts[:, 1], -1).to(I32))


def gather_kv(kv: TieredKV, seq: int, n_blocks: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialize [G, n_blocks*bs, KH, Dh] K and V for ``seq``."""
    tier, slot = lookup_blocks(kv, seq, n_blocks)
    safe = slot.clamp(min=0)
    hot = safe.clamp(max=kv.hot_k.shape[1] - 1)
    cold = safe.clamp(max=kv.cold_k.shape[1] - 1)
    is_hot = (tier == HOT)[None, :, None, None, None]
    k = torch.where(is_hot, kv.hot_k[:, hot], kv.cold_k[:, cold])
    v = torch.where(is_hot, kv.hot_v[:, hot], kv.cold_v[:, cold])
    G, nb, bs, KH, Dh = k.shape
    return k.reshape(G, nb * bs, KH, Dh), v.reshape(G, nb * bs, KH, Dh)


# ---------------------------------------------------------------------------
# Radiant migration (data-migration-triggered table migration)
# ---------------------------------------------------------------------------
def _blocks_used(kv: TieredKV, seq: int) -> int:
    """Blocks holding ``seq``'s tokens (one read of the device)."""
    bs = block_size_of(kv)
    return -(-int(kv.seq_len[seq]) // bs)


def migrate_sequence(kv: TieredKV, seq: int, to_tier: int, max_blocks: int,
                     trigger_leaf: bool = True) -> TieredKV:
    """Move every block of ``seq`` to ``to_tier``, in place, applying the
    Radiant trigger to the covering leaf page after each block.

    The bookkeeping runs block by block in the reference's order (blocks
    past the sequence's length are no-ops there and are skipped here).
    The moved ``(src, dst)`` slot pairs are collected and the data moves
    in one ``block_copy_pools`` launch covering both pools (K, V) and all
    groups, or none when nothing moved.  Deferring the copies is exact:
    sources and destinations lie in different pools, so no copy reads a
    slot that an earlier one of the same call wrote.
    """
    if to_tier == HOT:
        free, top, back, back_top = (kv.hot_free, kv.hot_free_top,
                                     kv.cold_free, kv.cold_free_top)
        pools = ((kv.cold_k, kv.hot_k), (kv.cold_v, kv.hot_v))
        stat, delta = STAT_BLK_PROMOTE, 1
    else:
        free, top, back, back_top = (kv.cold_free, kv.cold_free_top,
                                     kv.hot_free, kv.hot_free_top)
        pools = ((kv.hot_k, kv.cold_k), (kv.hot_v, kv.cold_v))
        stat, delta = STAT_BLK_DEMOTE, -1
    pairs, moved = [], []
    for vb in range(min(_blocks_used(kv, seq), max_blocks)):
        leaf_idx, entry = divmod(vb, FANOUT)
        leaf_id = kv.upper[seq, leaf_idx].clone()
        valid = leaf_id >= 0
        leaf_id = leaf_id.clamp(min=0)
        tier, slot = kv.leaf_tier_slot[leaf_id, entry].unbind()
        src = slot.clamp(min=0)
        move = valid & (tier >= 0) & (tier != to_tier) & (top > 0)
        new_slot, new_top = _pop(free, top)
        top.copy_(torch.where(move, new_top, top))
        _push(back, back_top, src, move)
        kv.leaf_tier_slot[leaf_id, entry] = torch.where(
            move, torch.stack([torch.full_like(new_slot, to_tier), new_slot]),
            torch.stack([tier, slot]))
        _add(kv.leaf_hot_children, leaf_id, move * delta)
        _add(kv.stats, stat, move)
        if trigger_leaf:
            _leaf_trigger(kv, leaf_id, valid)
        pairs.append(torch.stack([src, new_slot]))
        moved.append(move)
    if pairs:
        ids = torch.stack(pairs)[torch.stack(moved)]
        if ids.shape[0]:
            ops.block_copy_pools(pools, ids)
    return kv


def release_sequence(kv: TieredKV, seq: int, max_blocks: int) -> TieredKV:
    """Free every block and leaf table page of a finished sequence, in
    place."""
    n_used = _blocks_used(kv, seq)
    lts = kv.leaf_tier_slot
    for vb in range(min(n_used, max_blocks)):
        leaf_idx, entry = divmod(vb, FANOUT)
        leaf_id = kv.upper[seq, leaf_idx].clone()
        valid = leaf_id >= 0
        leaf_id = leaf_id.clamp(min=0)
        tier, slot = lts[leaf_id, entry].unbind()
        slot = slot.clamp(min=0)
        free_hot = valid & (tier == HOT)
        _push(kv.hot_free, kv.hot_free_top, slot, free_hot)
        _push(kv.cold_free, kv.cold_free_top, slot, valid & (tier == COLD))
        lts[leaf_id, entry] = torch.where(valid, -1, lts[leaf_id, entry])
        _add(kv.leaf_hot_children, leaf_id, -free_hot.to(I32))
        # free the leaf page itself once its last entry is cleared
        last_entry = valid & (entry == FANOUT - 1 or vb == n_used - 1)
        _push(kv.leaf_free, kv.leaf_free_top, leaf_id, last_entry)
        kv.leaf_tier[leaf_id] = torch.where(last_entry, -1,
                                            kv.leaf_tier[leaf_id])
        kv.upper[seq, leaf_idx] = torch.where(last_entry, -1,
                                              kv.upper[seq, leaf_idx])
    if max_blocks > 0:
        # the reference clamps after every block; between blocks only
        # decrements happen and nothing reads the counts, so once is equal
        kv.leaf_hot_children.clamp_(min=0)
    kv.seq_len[seq] = 0
    return kv


def _leaf_trigger(kv: TieredKV, leaf_id: torch.Tensor,
                  active: torch.Tensor) -> TieredKV:
    """Algorithm-1 conditions for one leaf table page, in place: promote a
    COLD leaf with a hot child, demote a HOT leaf whose last hot child
    left, count 'already in destination' skips."""
    children_hot = kv.leaf_hot_children[leaf_id] > 0
    cur = kv.leaf_tier[leaf_id]
    want = torch.where(children_hot, HOT, COLD).to(I32)
    do = active & (cur >= 0) & (cur != want)
    already = active & (cur >= 0) & (cur == want)
    kv.leaf_tier[leaf_id] = torch.where(do, want, cur)
    _add(kv.stats, STAT_LEAF_PROMOTE, do & (want == HOT))
    _add(kv.stats, STAT_LEAF_DEMOTE, do & (want == COLD))
    _add(kv.stats, STAT_LEAF_ALREADY, already)
    return kv


def table_invariant_violations(kv: TieredKV) -> torch.Tensor:
    """Number of live leaf pages whose tier disagrees with their children
    (hot children => leaf must be HOT), as a 0-d tensor."""
    alive = kv.leaf_tier >= 0
    should_hot = kv.leaf_hot_children > 0
    bad = alive & ((should_hot & (kv.leaf_tier != HOT))
                   | (~should_hot & (kv.leaf_tier != COLD)))
    return bad.sum().to(I32)
