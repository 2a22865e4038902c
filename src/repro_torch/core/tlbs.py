"""Vectorized, per-thread TLB and page-walk-cache (PWC) models (twin of
the JAX package's ``core/tlbs.py``).

Every simulated CPU thread owns a private translation hierarchy (L1 dTLB,
STLB, PDE PWC, PDPTE PWC), each a dense int32 ``[T, sets, ways]`` pair of
tag and LRU arrays with a leading thread axis.  LRU is a timestamp (the
global step); empty slots carry -1.

The reference picks a hit with ``argmax(match)`` and a victim with
``argmin(lru)``, both first-index on ties (an empty set ties at -1).  Here
both ties are broken by index explicitly: the hit is the smallest way that
matches, the victim the smallest ``(stamp + 1) * ways + way``.

Updates write in place: the simulator owns its state and consumes every
structure linearly, as the reference's functional updates do.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass
class TlbArray:
    """One set-associative, per-thread translation cache."""

    tags: torch.Tensor  # i32[T, sets, ways], -1 = invalid
    lru: torch.Tensor   # i32[T, sets, ways], -1 = empty, else last-use step


def make_tlb(n_threads: int, sets: int, ways: int, device) -> TlbArray:
    shape = (n_threads, sets, ways)
    return TlbArray(tags=torch.full(shape, -1, dtype=torch.int32, device=device),
                    lru=torch.full(shape, -1, dtype=torch.int32, device=device))


def _probe(tlb: TlbArray, tag: torch.Tensor):
    """(hit bool[T], way i64[T], flat i64[T]): ``flat`` is each thread's
    set row in the ``[T * sets, ways]`` view."""
    T, sets, ways = tlb.tags.shape
    flat = torch.arange(0, T * sets, sets, device=tag.device) + tag % sets
    set_tags = tlb.tags.view(T * sets, ways).index_select(0, flat)
    set_lru = tlb.lru.view(T * sets, ways).index_select(0, flat)
    way_ids = torch.arange(ways, device=tag.device)
    hit_way = torch.where(set_tags == tag[:, None], way_ids, ways).amin(1)
    hit = hit_way < ways
    victim = ((set_lru.long() + 1) * ways + way_ids).amin(1) % ways
    return hit, torch.where(hit, hit_way, victim), flat


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
    T, sets, _ = tlb.tags.shape
    row = torch.arange(0, T * sets, sets, device=tag.device) + tag % sets
    return _write(tlb, row, way, tag, now, active)


def _write(tlb: TlbArray, row, way, tag, now, active) -> TlbArray:
    """:func:`update` with each thread's set row (from :func:`_probe`)
    given: one entry per thread, so the writes never collide."""
    pos = row * tlb.tags.shape[2] + way
    for arr, val in ((tlb.tags, tag), (tlb.lru, now)):
        flat = arr.view(-1)
        flat.index_copy_(0, pos, torch.where(active, val,
                                             flat.index_select(0, pos)))
    return tlb


def invalidate_matching(tlb: TlbArray, flushed_lookup: torch.Tensor,
                        shift: int) -> TlbArray:
    """Invalidate every entry whose ``tag >> shift`` indexes a set bit of
    the bool table ``flushed_lookup`` (targeted shootdowns after a
    data-page or leaf-PT-page migration, or a segment free)."""
    valid = tlb.tags >= 0
    idx = (tlb.tags >> shift).clamp(0, flushed_lookup.shape[0] - 1).long()
    kill = valid & flushed_lookup[idx]
    tlb.tags.masked_fill_(kill, -1)
    tlb.lru.masked_fill_(kill, -1)
    return tlb


def flush_all(tlb: TlbArray) -> TlbArray:
    tlb.tags.fill_(-1)
    tlb.lru.fill_(-1)
    return tlb


def update_one(tlb: TlbArray, thread: int, tag: torch.Tensor, now,
               active: torch.Tensor) -> TlbArray:
    """Touch-or-insert ``tag`` (a 0-dim tensor) in thread ``thread``'s
    cache where ``active`` (0-dim bool) is set, in place: the hitting way,
    else the lowest-index way of least ``lru`` (used by the sequential
    fault path)."""
    one = TlbArray(tags=tlb.tags[thread:thread + 1],
                   lru=tlb.lru[thread:thread + 1])
    tag = tag.reshape(1)
    _, way, row = _probe(one, tag)
    _write(one, row, way, tag, now, active.reshape(1))
    return tlb


def lookup_one(tlb: TlbArray, thread: int, tag: torch.Tensor) -> torch.Tensor:
    """Hit test (0-dim bool) of ``tag`` in thread ``thread``'s cache; no
    state change."""
    one = TlbArray(tags=tlb.tags[thread:thread + 1],
                   lru=tlb.lru[thread:thread + 1])
    return _probe(one, tag.reshape(1))[0][0]
