"""Per-node page allocator with watermarks, slow path, reclaim and OOM
(twin of the JAX package's ``core/alloc.py``).

Mirrors the Linux buddy-allocator behaviours the paper measures: a fast
path above a node's low watermark, a slow path (``alloc_slow`` cycles)
below it, a small reclaimable reserve per node, and OOM when a bound
allocation (PT bind-all) cannot be satisfied from the allowed nodes.

Preferences are length-``n_nodes`` node orders with -1 padding.  The
functions here take tensors with optional leading lane dimensions: a
preference order is ``[..., n_nodes]`` and a policy code or thread id is
``[...]``.  They read only ``n_threads``, ``n_tiers``, ``n_nodes`` and
``alloc_nodes`` of the machine.

:func:`alloc_many`, the serialized allocator of one fault step, runs
through ``kernels.ops.alloc_scan``: the CUDA kernel on the card, the plain
loop over threads of ``kernels.ref.alloc_scan_ref`` (which calls
:func:`alloc_one`) on the CPU.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import ops
from .config import INTERLEAVE, PT_BIND_ALL, PT_BIND_HIGH, MachineConfig

I32 = torch.int32

# Request layout of one page fault, in allocation (= serialization) order:
# root, top and mid PT pages are "upper" levels (BHi-bound); the leaf PT
# page is upper only under THP (the PMD *is* the leaf, paper section 6.6);
# the data page comes last (request index 4).
LEVEL_IS_UPPER = (True, True, True, False)


def watermark_pages(mc: MachineConfig, device) -> torch.Tensor:
    cap = torch.tensor(mc.node_capacity(), dtype=torch.float32, device=device)
    return (cap * mc.low_watermark).to(I32)


def _local(thread: torch.Tensor, mc) -> torch.Tensor:
    return (thread >= mc.n_threads // 2).to(I32)


def first_touch_prefs(thread: torch.Tensor, mc) -> torch.Tensor:
    """Zonelist order for a thread: local then remote node of each tier,
    fastest tier first."""
    local = _local(thread, mc)
    pairs = []
    for t in range(mc.n_tiers):
        pairs += [2 * t + local, 2 * t + 1 - local]
    return torch.stack(pairs, dim=-1)


def interleave_prefs(ptr: torch.Tensor, mc) -> torch.Tensor:
    """Round-robin start node with wrap-around fallback, over the
    *allocatable* nodes only (-1 pads to the machine's n_nodes)."""
    a = len(mc.alloc_nodes)
    ids = torch.arange(mc.n_nodes, device=ptr.device)
    # positions past the allocatable nodes keep their -1
    pos = torch.where(ids < a, (ptr.remainder(a)[..., None] + ids) % a, a)
    # the table lookup as selects: a table copied from the host would wait
    # for the card, and the sequential fault path runs on it sync-free
    out = torch.full_like(pos, -1, dtype=I32)
    for i, node in enumerate(mc.alloc_nodes):
        out = torch.where(pos == i, node, out)
    return out


def dram_prefs(thread: torch.Tensor, mc) -> torch.Tensor:
    """DRAM-only preference (for PT binds); -1 entries are invalid."""
    local = _local(thread, mc)
    pad = [torch.full_like(local, -1)] * (mc.n_nodes - 2)
    return torch.stack([local, 1 - local] + pad, dim=-1)


def alloc_one(node_free: torch.Tensor, node_reclaimable: torch.Tensor,
              prefs: torch.Tensor, wm: torch.Tensor, ignore_wm
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor, torch.Tensor]:
    """Allocate a single page following ``prefs`` (``[..., n_nodes]``, -1 =
    skip) from ``node_free`` / ``node_reclaimable`` (``[..., n_nodes]``,
    broadcasting against ``prefs``).

    Returns (node, slow, new_free, new_reclaimable, ok).  ``node`` is -1 on
    failure.  ``slow`` flags the watermark slow path (or a reclaim).  The
    first acceptable node in preference order wins.  ``ignore_wm`` is a
    Python bool or a bool tensor ``[...]``.
    """
    n = node_free.shape[-1]
    valid = prefs >= 0
    safe = prefs.clamp(min=0).long()    # -1 pads read node 0, masked below
    free_p = node_free.expand(safe.shape).gather(-1, safe)
    rec_p = node_reclaimable.expand(safe.shape).gather(-1, safe)
    if isinstance(ignore_wm, bool):
        wm_p = 0 if ignore_wm else wm[safe]
    else:
        wm_p = torch.where(ignore_wm[..., None], 0, wm[safe])
    # above the watermark (fast), any free page (slow), any reclaimable
    # page (slow, from the reserve): the first preference passing each
    passing = torch.stack([free_p > wm_p, free_p > 0, rec_p > 0]) & valid
    first = torch.where(passing, torch.arange(n, device=prefs.device),
                        n).amin(-1)
    fast_ok, slow_ok, rec_ok = first < n
    pick = safe.expand(passing.shape).gather(
        -1, (first % n).unsqueeze(-1)).squeeze(-1).to(I32)
    node = torch.where(fast_ok, pick[0], torch.where(
        slow_ok, pick[1], torch.where(rec_ok, pick[2], -1)))
    ok = fast_ok | slow_ok | rec_ok
    slow = ok & ~fast_ok
    from_reclaim = ok & ~fast_ok & ~slow_ok

    at_node = torch.arange(n, device=prefs.device) == node[..., None]
    dec = (at_node & (ok & ~from_reclaim)[..., None]).to(I32)
    dec_rec = (at_node & from_reclaim[..., None]).to(I32)
    return node, slow, node_free - dec, node_reclaimable - dec_rec, ok


def data_prefs_for(data_policy: torch.Tensor, thread: torch.Tensor, mc,
                   interleave_ptr: torch.Tensor) -> torch.Tensor:
    """Zonelist for a data-page allocation; both orders are computed and
    selected by the (per-lane) policy code."""
    interleave = (data_policy == INTERLEAVE)[..., None]
    return torch.where(interleave, interleave_prefs(interleave_ptr, mc),
                       first_touch_prefs(thread, mc))


def pt_prefs_for(pt_policy: torch.Tensor, level_is_upper: bool,
                 thread: torch.Tensor, mc, data_prefs: torch.Tensor,
                 thp: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Preference order for a PT page allocation: (prefs, ignore_wm).

    ``level_is_upper`` marks root/top/mid pages (plus the leaf under THP,
    where the PMD *is* the leaf and BHi binds it — paper section 6.6).
    """
    bound = pt_bound(pt_policy, level_is_upper, thp)
    # Linux default: PT pages follow the data-page policy (paper section 3.2).
    prefs = torch.where(bound[..., None], dram_prefs(thread, mc), data_prefs)
    return prefs, bound


def pt_bound(pt_policy: torch.Tensor, level_is_upper: bool,
             thp: bool) -> torch.Tensor:
    """Whether a PT level binds to DRAM (and ignores the watermark):
    bind-all binds every level, BHi the upper ones (the leaf too under
    THP)."""
    return (pt_policy == PT_BIND_ALL) | \
        ((pt_policy == PT_BIND_HIGH) & (level_is_upper or thp))


def _code(value, device, L: int) -> torch.Tensor:
    """A policy code as an i32[L] lane tensor (a fill, not a host copy,
    when it is a Python int)."""
    if torch.is_tensor(value):
        return value.to(device=device, dtype=I32).reshape(L)
    return torch.full((L,), int(value), dtype=I32, device=device)


def alloc_many(node_free, node_reclaimable, interleave_ptr, oom_killed, wm,
               data_policy, pt_policy, mc: MachineConfig, need_pt, need_data,
               slot_thread=None):
    """Batched fault allocator: hand out pages to a whole thread vector.

    Reproduces the sequential thread-order semantics of the fault loop:
    the carry that chains through the threads is ``node_free``,
    ``node_reclaimable``, the interleave cursor and the OOM latch, and each
    thread makes its root/top/mid/leaf PT requests (``need_pt[T, 4]``) and
    its data request (``need_data[T]``) in that order.  A thread whose
    allocation fails latches ``oom`` and every *later* thread is gated,
    but the failing thread's own remaining requests still run.

    Returns ``(nodes[T,5], slow[T,5], ok[T,5], act[T,5], gate[T],
    node_free', node_reclaimable', interleave_ptr', oom')``: ``act`` marks
    requests attempted, ``gate`` threads not OOM-gated on entry; ``ok`` is
    reported for every request.

    ``slot_thread`` (optional ``[G]``, ascending distinct thread ids,
    ``n_threads`` marks a pad slot) is the reference's compacted scan over
    the allocating threads.  A thread without requests is the identity on
    the carry, so it equals the full scan over the threads with the
    requests of threads outside ``slot_thread`` dropped, and the outputs
    of those threads reset (-1 / False), which is how it runs here:
    ``ops.alloc_scan`` takes the slot row, and either way the step is one
    launch on the card.

    ``L`` runs at once (a sweep's lanes) put a lane axis in front of every
    argument but ``wm``: ``need_data[L, T]``, ``need_pt[L, T, 4]``,
    ``node_free[L, N]``, the cursor, latch and policy codes ``[L]``,
    ``slot_thread[L, G]``; the results then carry it too, and the call is
    still one launch.
    """
    dev = node_free.device
    solo = need_data.dim() == 1
    L, T = (1, need_data.shape[0]) if solo else need_data.shape
    if slot_thread is not None:
        slot_thread = slot_thread.to(I32).reshape(L, -1).contiguous()
    out = ops.alloc_scan(
        node_free.reshape(L, -1).contiguous(),
        node_reclaimable.reshape(L, -1).contiguous(),
        interleave_ptr.reshape(L).contiguous(),
        oom_killed.reshape(L).contiguous(), wm,
        _code(data_policy, dev, L), _code(pt_policy, dev, L),
        need_pt.reshape(L, T, 4).contiguous(),
        need_data.reshape(L, T).contiguous(), n_threads=mc.n_threads,
        alloc_nodes=mc.alloc_nodes, thp=mc.page_order > 0,
        slot_thread=slot_thread)
    return tuple(x[0] for x in out) if solo else out
