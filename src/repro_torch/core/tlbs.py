"""Vectorized, per-thread TLB and page-walk-cache (PWC) models (twin of
the JAX package's ``core/tlbs.py``).

Every simulated CPU thread owns a private translation hierarchy (L1 dTLB,
STLB, PDE PWC, PDPTE PWC), each a dense int32 ``[T, sets, ways]`` pair of
tag and LRU arrays with a leading thread axis; a sweep's runs add a lane
axis in front, ``[L, T, sets, ways]``, and every function here takes any
leading axes (a tag per leading index).  LRU is a timestamp (the global
step); empty slots carry -1.

The reference picks a hit with ``argmax(match)`` and a victim with
``argmin(lru)``, both first-index on ties (an empty set ties at -1).  Here
both ties are broken by index explicitly: the hit is the smallest way that
matches, the victim the smallest ``(stamp + 1) * ways + way``.

Updates write in place: the simulator owns its state and consumes every
structure linearly, as the reference's functional updates do.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import torch


@dataclasses.dataclass
class TlbArray:
    """One set-associative, per-thread translation cache."""

    tags: torch.Tensor  # i32[..., T, sets, ways], -1 = invalid
    lru: torch.Tensor   # i32[..., T, sets, ways], -1 = empty, else last-use step


def make_tlb(n_threads: int, sets: int, ways: int, device,
             lanes: Tuple[int, ...] = ()) -> TlbArray:
    shape = (*lanes, n_threads, sets, ways)
    return TlbArray(tags=torch.full(shape, -1, dtype=torch.int32, device=device),
                    lru=torch.full(shape, -1, dtype=torch.int32, device=device))


@functools.lru_cache(maxsize=64)
def _rows_and_ways(shape: Tuple[int, ...], sets: int, ways: int, device):
    """The constants of a probe, made once per geometry (the step loop
    probes the same four caches every step): each leading index's first
    set row in the ``[N * sets, ways]`` view (i64 of ``shape``), and the
    way ids."""
    return (torch.arange(0, math.prod(shape) * sets, sets,
                         device=device).view(shape),
            torch.arange(ways, device=device))


def _probe(tlb: TlbArray, tag: torch.Tensor):
    """(hit bool, way i64, flat i64), each of ``tag``'s shape (one tag per
    leading index of the cache): ``flat`` is each tag's set row in the
    ``[N * sets, ways]`` view."""
    sets, ways = tlb.tags.shape[-2:]
    base, way_ids = _rows_and_ways(tuple(tag.shape), sets, ways, tag.device)
    flat = base + tag % sets
    rows = flat.view(-1)
    set_tags = tlb.tags.reshape(-1, ways).index_select(0, rows)
    set_lru = tlb.lru.reshape(-1, ways).index_select(0, rows)
    hit_way = torch.where(set_tags == tag.reshape(-1, 1), way_ids,
                          ways).amin(1)
    hit = hit_way < ways
    victim = ((set_lru.long() + 1) * ways + way_ids).amin(1) % ways
    shape = tag.shape
    return (hit.view(shape), torch.where(hit, hit_way, victim).view(shape),
            flat)


def lookup(tlb: TlbArray, tag: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized lookup of one tag per thread.

    Returns (hit: bool[T], way_or_victim: i64[T]): the hitting way on a
    hit, else the LRU victim way for a subsequent insert.
    """
    hit, way, _ = _probe(tlb, tag)
    return hit, way


def update(tlb: TlbArray, tag: torch.Tensor, way: torch.Tensor, now,
           active: torch.Tensor) -> TlbArray:
    """Touch-or-insert ``tag`` at ``way`` for threads with ``active`` set
    (in place)."""
    sets, ways = tlb.tags.shape[-2:]
    base, _ = _rows_and_ways(tuple(tag.shape), sets, ways, tag.device)
    return _write(tlb, base + tag % sets, way, tag, now, active)


def _write(tlb: TlbArray, row, way, tag, now, active) -> TlbArray:
    """:func:`update` with each thread's set row (from :func:`_probe`)
    given: one entry per thread, so the writes never collide.  ``take`` and
    ``put_`` read the cache as one flat row, so no view of it is made."""
    pos = row * tlb.tags.shape[-1] + way      # int64, the flat entry
    for arr, val in ((tlb.tags, tag), (tlb.lru, now)):
        arr.put_(pos, torch.where(active, val, arr.take(pos)))
    return tlb


def invalidate_matching(tlb: TlbArray, flushed_lookup: torch.Tensor,
                        shift: int) -> TlbArray:
    """Invalidate every entry whose ``tag >> shift`` indexes a set bit of
    the bool table ``flushed_lookup`` (targeted shootdowns after a
    data-page or leaf-PT-page migration, or a segment free): ``[n]``
    shared by the whole cache, or ``[L, n]``, one row per lane of an
    ``[L, T, sets, ways]`` cache."""
    valid = tlb.tags >= 0
    n = flushed_lookup.shape[-1]
    idx = (tlb.tags >> shift).clamp(0, n - 1).long()
    if flushed_lookup.dim() == 1:
        hit = flushed_lookup[idx]
    else:
        L = flushed_lookup.shape[0]
        hit = flushed_lookup.gather(1, idx.view(L, -1)).view(idx.shape)
    kill = valid & hit
    tlb.tags.masked_fill_(kill, -1)
    tlb.lru.masked_fill_(kill, -1)
    return tlb


def flush_all(tlb: TlbArray) -> TlbArray:
    tlb.tags.fill_(-1)
    tlb.lru.fill_(-1)
    return tlb


def _thread(tlb: TlbArray, thread: int) -> TlbArray:
    """Thread ``thread``'s cache, a view keeping its thread axis (length
    1)."""
    return TlbArray(tags=tlb.tags[..., thread:thread + 1, :, :],
                    lru=tlb.lru[..., thread:thread + 1, :, :])


def update_one(tlb: TlbArray, thread: int, tag: torch.Tensor, now,
               active: torch.Tensor) -> TlbArray:
    """Touch-or-insert ``tag`` in thread ``thread``'s cache where
    ``active`` is set, in place: the hitting way, else the lowest-index way
    of least ``lru`` (used by the sequential fault path).  ``tag`` and
    ``active`` are 0-dim for a ``[T, sets, ways]`` cache, and one per lane
    for an ``[L, T, sets, ways]`` one."""
    one = _thread(tlb, thread)
    shape = one.tags.shape[:-2]
    tag = tag.reshape(shape)
    _, way, row = _probe(one, tag)
    if one.tags.is_contiguous():
        _write(one, row, way, tag, now, active.reshape(shape))
        return tlb
    # a thread of several lanes is a strided view: write through a copy
    local = TlbArray(tags=one.tags.contiguous(), lru=one.lru.contiguous())
    _write(local, row, way, tag, now, active.reshape(shape))
    one.tags.copy_(local.tags)
    one.lru.copy_(local.lru)
    return tlb


def lookup_one(tlb: TlbArray, thread: int, tag: torch.Tensor) -> torch.Tensor:
    """Hit test of ``tag`` in thread ``thread``'s cache (0-dim bool, or one
    per lane); no state change."""
    one = _thread(tlb, thread)
    return _probe(one, tag.reshape(one.tags.shape[:-2]))[0][..., 0]
