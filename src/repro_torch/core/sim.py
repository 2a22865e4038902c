"""The tiered-memory simulator (twin of the JAX package's ``core/sim.py``):
the time-blocked engine (``engine="blocked"``, the default) over the
per-step engine (``engine="per_step"``), with the batched or the
sequential fault path (``phase_b``).

One step simulates one memory access per CPU thread:

  Phase 0   process-exit events (segment frees) and the periodic AutoNUMA
            scan (+ Algorithm-1 triggers) — ``migrate.autonuma_scan``.
  Phase A   *vectorized across threads*: accesses to already-mapped pages.
            L1-TLB -> STLB -> hardware walk with PDE/PDPTE page-walk caches;
            per-level walk costs depend on the NUMA node of each PT page;
            data-access cost depends on the data page's node, LLC-filtered.
  Phase B   *batched over threads*: page-fault handling.  The host schedule
            (:func:`fault_schedule`) says who faults and who wins each
            mapping granule; first-thread-wins masks over the missing PT
            entries come from live state; ``alloc.alloc_many`` serializes
            the allocator counters (the ``alloc_scan`` kernel on the card);
            PT placements, TLB fills and cycle and event accounting commit
            vectorized across threads.  ``phase_b="sequential"`` keeps the
            reference's per-thread loop (its differential oracle).

Time-blocked execution (:class:`BlockedRunner`): the trace is cut into
``block``-step windows, classified on the host from the schedule's event
rows (:func:`plan_windows`, the reference's classification field for
field).  An event-free stretch runs as one :func:`fast_window_tile`: the
tile's gathers, draws and latency terms vectorized over ``[rows, T]``,
then the TLB and page-walk-cache chain through its rows in one launch of
the ``fast_window`` kernel; a lone scan tick is hoisted between two fast
segments; other events replay their span, or the window, step by step.
Every branch replays the per-step f32 expression tree in per-step order,
so the blocked engine equals the per-step engine bit for bit.

The host half (traces, schedules, :class:`RunResult`) is numpy, as in the
reference.  The step loop is a Python loop over the trace's steps on the
device: the schedule predicates (a segment frees, the scan fires, some
thread faults) are host numpy, so the loop branches on host values and
never reads the device; the trace rows go to the device once, before the
loop, and the fifteen timeline values of each step are written into a
device buffer that is read once, at the end.

Every f32 expression replays the reference's order of operations.  Sums
over threads and pages are the only reductions whose order differs from
XLA's.  The state is updated in place: the run owns it and consumes each
field linearly, as the reference's functional updates do.  Scatters whose
masked-off rows could collide with a live write route those rows to a
sentinel row that is sliced off; integer adds at in-range indices add 0
where masked off.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import alloc as alloc_mod
from . import migrate as migrate_mod
from . import tlbs
from .config import (CostConfig, MachineConfig, PolicyConfig, INTERLEAVE,
                     PT_BIND_HIGH, PT_FOLLOW_DATA)
from .state import SimState, init_state, is_dram
from ..device import resolve_device
from ..kernels import ops

I32 = torch.int32
F32 = torch.float32

_MIX = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)
_M32 = 0xFFFFFFFF


def _site_seed(site: int) -> int:
    return (0x811C9DC5 + 0x1000193 * site) & _M32


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2^32`` for int64 ``h`` in ``[0, 2^32)``: ``c`` is split
    into 16-bit halves, so no product passes 2^49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def bern_hash(h, keys) -> torch.Tensor:
    """The 24-bit multiplicative hash of ``bern``: ``h`` is the site seed
    (an int or an int64 tensor broadcasting against the keys), each key an
    int or an integer tensor read as uint32."""
    for i, k in enumerate(keys):
        k = k & _M32 if isinstance(k, int) else k.long() & _M32
        h = _mul32(h ^ k, _MIX[i % 4])
    return (h >> 8) & 0xFFFFFF


def bern_threshold(p) -> int:
    """``uint32(float32(p) * 2^24)``, the reference's threshold."""
    return int(np.float32(p) * np.float32(1 << 24))


def bern(p, site: int, *keys) -> torch.Tensor:
    """Deterministic Bernoulli(p) from a multiplicative hash of the keys,
    bit for bit the reference's uint32 wrap-around arithmetic, done in
    int64 masked to 32 bits.  ``p`` is a float or a 0-dim tensor."""
    if torch.is_tensor(p):
        thr = (p.to(F32) * float(1 << 24)).long()
    else:
        thr = bern_threshold(p)
    return bern_hash(_site_seed(site), keys) < thr


@dataclasses.dataclass(frozen=True)
class Trace:
    """A pregenerated access trace (host-side numpy).

    va[s, t]     4-KiB virtual page accessed by thread t at step s (-1 idle)
    is_write     same shape
    free_seg[s]  segment id whose pages are freed at the start of step s (-1)
    llc[s]       data-access LLC hit probability at step s (phase-dependent)
    seg_of_map   segment id per mapping granule (for frees)
    """

    va: np.ndarray
    is_write: np.ndarray
    free_seg: np.ndarray
    llc: np.ndarray
    seg_of_map: np.ndarray
    name: str = "trace"
    populate_steps: int = 0      # steps belonging to the populate/startup phase

    @property
    def n_steps(self) -> int:
        return self.va.shape[0]


def pad_trace(tr: Trace, n_steps: int) -> Trace:
    """Idle-pad a trace to ``n_steps`` (policy sweeps share one shape)."""
    cur = tr.n_steps
    if cur >= n_steps:
        return tr
    pad = n_steps - cur
    return dataclasses.replace(
        tr,
        va=np.concatenate([tr.va, np.full((pad, tr.va.shape[1]), -1, np.int32)]),
        is_write=np.concatenate([tr.is_write,
                                 np.zeros((pad, tr.va.shape[1]), bool)]),
        free_seg=np.concatenate([tr.free_seg, np.full((pad,), -1, np.int32)]),
        llc=np.concatenate([tr.llc, np.zeros((pad,), np.float32)]))


# fault_schedule bit layout (uint8 per (step, thread)):
#   DO      thread touches a page unmapped at step start (fault or wait)
#   WINNER  first DO-thread for its mapping granule -> runs the real fault
#   NEED_*  winner is the first to touch that missing PT entry -> allocates
SCHED_DO = np.uint8(1)
SCHED_WINNER = np.uint8(2)
SCHED_NEED_ROOT = np.uint8(4)
SCHED_NEED_TOP = np.uint8(8)
SCHED_NEED_MID = np.uint8(16)
SCHED_NEED_LEAF = np.uint8(32)

# Digest-keyed, LRU-bounded: the whole benchmark suite holds well under
# the cap, while long-lived processes sweeping many generated traces
# (property tests, trace-content grids) don't accumulate schedules forever.
_SCHED_CACHE: "collections.OrderedDict[Tuple, np.ndarray]" = \
    collections.OrderedDict()
_SCHED_CACHE_MAX = 64


def fault_schedule(tr: Trace, mc: MachineConfig) -> np.ndarray:
    """uint8[steps, threads]: the per-(step, thread) fault schedule.

    Mapped-ness and PT-entry *existence* are policy-independent (placement
    differs across policies, existence does not), so the whole conflict
    structure of phase B is derivable from the trace alone: which threads
    fault, which of them wins each shared mapping granule, and which
    winner allocates each missing root/top/mid/leaf PT entry
    (first-thread-wins, the serialization order of the kernel's zone
    lock).  :func:`fault_step_mask` is just
    ``(schedule & SCHED_DO).any(axis=1)``.

    The batched engine consumes the DO/WINNER bits (masked by phase A's
    live miss set); the NEED bits document the host model's PT-entry
    conflict resolution and anchor its tests, while the engine recomputes
    those first-winner masks from live placement state, which stays exact
    even for a resumed pre-populated state (where a cross-segment free
    may have orphaned a leaf the host model cannot see).

    The host model assumes allocations succeed; past a lane's OOM point
    the bits over-approximate, and the device gates every request on its
    per-thread OOM latch (``alloc_many``'s ``gate``), under which the
    lane is inert anyway.  Results are memoized on a digest of the trace
    contents — figures sharing padded traces pay the host pass once.
    """
    shift, n_map, rb = mc.map_shift, mc.n_map, mc.radix_bits
    n_leaf, n_mid, n_top = mc.n_leaf_pages, mc.n_mid_pages, mc.n_top_pages
    va = np.asarray(tr.va)
    seg = np.asarray(tr.seg_of_map)
    free_seg = np.asarray(tr.free_seg)
    h = hashlib.blake2b(digest_size=16)
    for a in (va, free_seg, seg):
        h.update(np.ascontiguousarray(a))
    key = (h.digest(), va.shape, shift, n_map, rb, n_leaf, n_mid, n_top)
    hit = _SCHED_CACHE.get(key)
    if hit is not None:
        _SCHED_CACHE.move_to_end(key)
        return hit

    leaf_first = (np.arange(n_leaf, dtype=np.int64) << rb) % max(n_map, 1)
    seg_of_leaf = seg[leaf_first]
    mapped = np.zeros(n_map, bool)
    exists = {  # PT-entry existence per level (mid/top/root are never freed)
        "root": np.zeros(1, bool), "top": np.zeros(n_top, bool),
        "mid": np.zeros(n_mid, bool), "leaf": np.zeros(n_leaf, bool),
    }
    S, T = va.shape
    sched = np.zeros((S, T), np.uint8)
    for s in range(S):
        if free_seg[s] >= 0:
            mapped[seg == free_seg[s]] = False
            exists["leaf"][seg_of_leaf == free_seg[s]] = False
        row = va[s]
        act = row >= 0
        if not act.any():
            continue
        m = np.clip(row.astype(np.int64) >> shift, 0, n_map - 1)
        do = act & ~mapped[m]
        if not do.any():
            continue
        sched[s] |= np.where(do, SCHED_DO, np.uint8(0))
        do_t = np.where(do)[0]                       # ascending thread order
        _, first = np.unique(m[do_t], return_index=True)
        wt = np.sort(do_t[first])                    # first thread per granule
        sched[s, wt] |= SCHED_WINNER
        mw = m[wt]
        levels = (
            (SCHED_NEED_ROOT, "root", np.zeros(len(wt), np.int64)),
            (SCHED_NEED_TOP, "top", np.clip(mw >> (3 * rb), 0, n_top - 1)),
            (SCHED_NEED_MID, "mid", np.clip(mw >> (2 * rb), 0, n_mid - 1)),
            (SCHED_NEED_LEAF, "leaf", mw >> rb),
        )
        for bit, lvl, e in levels:
            miss = ~exists[lvl][e]
            if not miss.any():
                continue
            em, tm = e[miss], wt[miss]
            uniq, fidx = np.unique(em, return_index=True)
            sched[s, tm[fidx]] |= bit
            exists[lvl][uniq] = True
        mapped[mw] = True
    _SCHED_CACHE[key] = sched
    while len(_SCHED_CACHE) > _SCHED_CACHE_MAX:
        _SCHED_CACHE.popitem(last=False)
    return sched


def fault_step_mask(tr: Trace, mc: MachineConfig) -> np.ndarray:
    """bool[steps]: does ANY thread touch an unmapped page at step s?

    The step loop skips phase B entirely on fault-free steps.  For a
    simulation resumed from a pre-populated state this is an
    over-approximation (phase B runs and no-ops), never an
    under-approximation.
    """
    return np.asarray((fault_schedule(tr, mc) & SCHED_DO) > 0).any(axis=1)


def scan_step_mask(n_steps: int, period: int, enabled: bool = True,
                   start_step: int = 0) -> np.ndarray:
    """bool[steps]: does the periodic AutoNUMA scan fire at step s?"""
    s = np.arange(start_step, start_step + n_steps)
    return (s > 0) & (s % max(int(period), 1) == 0) & bool(enabled)


def pow2ceil(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor)."""
    p = max(int(floor), 1)
    while p < n:
        p <<= 1
    return p


# Step-window size of the time-blocked engine.  The window count
# ceil(S / block) depends only on the trace shape, never its content.
DEFAULT_BLOCK = 64


def fault_group_bound(sched: np.ndarray) -> int:
    """Max winners (allocating threads) in any single step of a schedule.

    This bounds the conflict-group count of ``alloc.alloc_many``'s
    serialized allocator scan: every thread that touches the allocator in
    a step carries the WINNER bit, and threads without requests commute
    with everything, so the per-step scan depth collapses from
    ``n_threads`` to this bound (each group = one allocating thread plus
    the non-allocating threads behind it).  The engine's winners are a
    subset of the host bits (resume masking), so the bound is safe for
    resumed states too.
    """
    if sched.size == 0:
        return 1
    w = (sched & SCHED_WINNER) > 0
    return max(int(w.sum(axis=1).max()), 1)


@dataclasses.dataclass
class RunResult:
    final_state: SimState          # SimState.to_numpy(): host numpy arrays
    timeline: Dict[str, np.ndarray]
    trace_name: str
    policy_label: str

    def summary(self) -> Dict[str, float]:
        st = self.final_state
        cyc = st.cycles
        # Migration-daemon cycles were already spread into per-thread totals
        # inside the step function; ``migration_cycles`` is informational.
        total = float(np.sum(cyc.total))
        runtime = float(np.max(cyc.total))
        walk = float(np.sum(cyc.walk))
        stall = float(np.sum(cyc.stall))
        c = st.counters
        leaf_nodes = np.asarray(st.leaf_node)
        alive = leaf_nodes >= 0
        data = np.asarray(st.data_node)
        return {
            "runtime_cycles": runtime,
            "total_cycles": total,
            "walk_cycles": walk,
            "stall_cycles": stall,
            "data_mem_cycles": float(np.sum(cyc.data_mem)),
            "fault_cycles": float(np.sum(cyc.fault)),
            "migration_cycles": float(cyc.migration),
            "walk_share": walk / max(total, 1.0),
            "l1_hits": int(c.l1_hits), "stlb_hits": int(c.stlb_hits),
            "walks": int(c.walks), "walk_mem_reads": int(c.walk_mem_reads),
            "faults": int(c.faults),
            "slow_allocs": int(c.slow_allocs),
            "data_migrations": int(c.data_migrations),
            "demotions": int(c.demotions),
            "l4_mig_success": int(c.l4_mig_success),
            "l4_mig_already_dest": int(c.l4_mig_already_dest),
            "l4_mig_in_dram": int(c.l4_mig_in_dram),
            "l4_mig_sibling_guard": int(c.l4_mig_sibling_guard),
            "l4_mig_lock_skip": int(c.l4_mig_lock_skip),
            "oom_killed": bool(st.oom_killed), "oom_step": int(st.oom_step),
            "leaf_pages_dram": int(np.sum(alive & (leaf_nodes < 2))),
            "leaf_pages_nvmm": int(np.sum(alive & (leaf_nodes >= 2))),
            "data_pages_dram": int(np.sum((data >= 0) & (data < 2))),
            "data_pages_nvmm": int(np.sum(data >= 2)),
            # N-tier / policy-family extensions (tier t owns nodes 2t,
            # 2t+1; on the 2-tier machine the per-tier lists reduce to the
            # dram/nvmm pairs above).
            "data_pages_per_tier": [
                int(np.sum((data >= 2 * t) & (data < 2 * t + 2)))
                for t in range(np.asarray(st.node_free).shape[0] // 2)],
            "leaf_pages_per_tier": [
                int(np.sum(alive & (leaf_nodes >= 2 * t)
                           & (leaf_nodes < 2 * t + 2)))
                for t in range(np.asarray(st.node_free).shape[0] // 2)],
            "shadow_pages": int(np.sum(np.asarray(st.shadow_node) >= 0)),
            "nomad_retries": int(c.nomad_retries),
            "nomad_flip_demotions": int(c.nomad_flip_demotions),
            "nomad_shadow_drops": int(c.nomad_shadow_drops),
        }


TIMELINE_KEYS = ("total_cycles", "walk_cycles", "stall_cycles", "faults",
                 "dram_free", "leaf_nvmm", "leaf_dram", "walks",
                 "data_migrations", "l4_mig_success", "migration_cycles",
                 "data_mem_cycles", "fault_cycles", "l1_hits", "stlb_hits")


def seg_of_leaf_table(trace: Trace, mc: MachineConfig, device) -> torch.Tensor:
    """i32[n_leaf]: the segment of each leaf page's first granule."""
    n_leaf = mc.n_leaf_pages
    leaf_first = (np.arange(n_leaf, dtype=np.int64) << mc.radix_bits) \
        % max(mc.n_map, 1)
    return torch.as_tensor(np.asarray(trace.seg_of_map, np.int32)[leaf_first],
                           device=device)


def trace_xs(trace: Trace, mc: MachineConfig, pc: PolicyConfig,
             start_step: int = 0, sched: Optional[np.ndarray] = None,
             device=None):
    """Per-step inputs for one trace, in the reference's order: ``(va,
    is_write, free_seg, llc, sched, do_free, do_scan, has_fault, valid)``.

    The rows the device reads (``va``, ``is_write``, ``sched``) are tensors
    on ``device``; the rest are host numpy arrays, which the step loop
    branches on or turns into Python numbers."""
    dev = resolve_device(device)
    do_free = np.asarray(trace.free_seg) >= 0
    do_scan = scan_step_mask(trace.n_steps, int(pc.autonuma_period),
                             enabled=bool(pc.autonuma), start_step=start_step)
    if sched is None:
        sched = fault_schedule(trace, mc)
    return (torch.as_tensor(np.asarray(trace.va, np.int32), device=dev),
            torch.as_tensor(np.asarray(trace.is_write, bool), device=dev),
            np.asarray(trace.free_seg, np.int32),
            np.asarray(trace.llc, np.float32),
            torch.as_tensor(sched, device=dev), do_free, do_scan,
            (sched & SCHED_DO).any(axis=1), np.ones((trace.n_steps,), bool))


# Timeline columns as the step loop keeps them: the f32 sums, then the
# int32 counts (TIMELINE_KEYS gives the reference's order).
_TL_F32 = ("total_cycles", "walk_cycles", "stall_cycles", "data_mem_cycles",
           "fault_cycles", "migration_cycles")
_TL_I32 = ("faults", "dram_free", "leaf_nvmm", "leaf_dram", "walks",
           "data_migrations", "l4_mig_success", "l1_hits", "stlb_hits")


def _set_where(arr: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """``arr`` with ``arr[idx[i]] = vals[i]`` where ``mask[i]``; the masked
    rows' indices are unique, and the other rows go to a sentinel row past
    the end that is sliced off (the reference drops them out of range)."""
    n = arr.shape[0]
    ext = torch.cat([arr, arr[:1]])
    ext.index_copy_(0, torch.where(mask, idx, n).long(), vals)
    return ext[:n]


class Stepper:
    """One run of the per-step engine in progress.

    :meth:`TieredMemSimulator.run` is ``runner(trace).advance()`` then
    :meth:`result`; stepping in pieces gives the same state (a caller can
    time or profile a window of steps).  Everything the loop reads is put
    on the device here, before the first step.  The blocked engine
    (:class:`BlockedRunner`) drives one of these for its per-step spans.
    """

    def __init__(self, sim: "TieredMemSimulator", trace: Trace,
                 state: Optional[SimState] = None):
        mc, cc, pc = sim.mc, sim.cc, sim.pc
        dev = sim.device
        if trace.va.shape[1] != mc.n_threads:
            raise ValueError(f"trace has {trace.va.shape[1]} threads, machine "
                             f"{mc.n_threads}")
        self.mc, self.cc, self.pc = mc, cc, pc
        self.trace = trace
        self.sequential = sim.phase_b == "sequential"
        T = mc.n_threads
        self.budget = min(int(pc.autonuma_budget), mc.n_map)
        sched = fault_schedule(trace, mc)      # memoized; computed once
        group = min(pow2ceil(fault_group_bound(sched)), T)

        if state is None:
            self.st = init_state(mc, dev)
            self.start = 0
        else:
            self.st = state.to(dev)
            self.start = int(np.asarray(state.step))
        (self.va, self.is_write, self.free_seg, llc, self.sched, self.do_free,
         self.do_scan, self.has_fault, _) = trace_xs(
            trace, mc, pc, start_step=self.start, sched=sched, device=dev)
        S = trace.n_steps

        # allocator conflict-group slots per step: the host winners' prefix
        # count, pad slots = T (alloc.alloc_many's slot_thread)
        win = (sched & SCHED_WINNER) > 0
        slot = np.cumsum(win, axis=1) - 1
        slots = np.full((S, group), T, np.int32)
        rows, cols = np.nonzero(win & (slot < group))
        slots[rows, slot[rows, cols]] = cols
        self.slots = torch.as_tensor(slots, device=dev)

        # bern: the seeds of sites 1-4 (leaf, mid, top, data) and each
        # step's thresholds (the data site's follows the trace's llc)
        self.site_seeds = torch.tensor([[_site_seed(s)] for s in (1, 2, 3, 4)],
                                       dtype=torch.int64, device=dev)
        thr = np.empty((S, 4, 1), np.int64)
        thr[:, 0] = bern_threshold(cc.leaf_llc_hit)
        thr[:, 1:3] = bern_threshold(cc.upper_llc_hit)
        thr[:, 3, 0] = (llc.astype(np.float32) * np.float32(1 << 24)
                        ).astype(np.int64)
        self.thr = torch.as_tensor(thr, device=dev)

        self.tid = torch.arange(T, dtype=I32, device=dev)
        self.wm = alloc_mod.watermark_pages(mc, dev)
        self.tables = migrate_mod.node_tables(cc, mc, dev)
        self.data_policy = torch.full((1,), int(pc.data_policy), dtype=I32,
                                      device=dev)
        self.pt_policy = torch.full((1,), int(pc.pt_policy), dtype=I32,
                                    device=dev)
        self.seg_of_map = torch.as_tensor(np.asarray(trace.seg_of_map,
                                                     np.int32), device=dev)
        self.seg_of_leaf = seg_of_leaf_table(trace, mc, dev)
        leaf_of_map = torch.arange(mc.n_map, device=dev) >> mc.radix_bits
        self.map_has_leaf = leaf_of_map < mc.n_leaf_pages
        self.leaf_of_map = leaf_of_map.clamp(max=mc.n_leaf_pages - 1)
        self.tl_f32 = torch.zeros((S, len(_TL_F32)), dtype=F32, device=dev)
        self.tl_i32 = torch.zeros((S, len(_TL_I32)), dtype=I32, device=dev)
        self.s = 0                          # steps done

    # ------------------------------ phase A --------------------------------
    def phase_a(self, s: int, now: int):
        st, mc, cc = self.st, self.mc, self.cc
        rb = mc.radix_bits
        read_lat, write_lat = self.tables.read, self.tables.write
        va_row, w_row = self.va[s], self.is_write[s]
        m = torch.where(va_row >= 0, va_row >> mc.map_shift, 0).clamp(
            0, mc.n_map - 1)
        data_n = st.data_node.index_select(0, m)
        mapped = data_n >= 0
        active = (va_row >= 0) & ~st.oom_killed
        vec = active & mapped

        hit1, way1, row1 = tlbs._probe(st.l1_tlb, m)
        hit2, way2, row2 = tlbs._probe(st.stlb, m)
        walkn = vec & ~hit1 & ~hit2

        leaf_id, mid_id, top_id = m >> rb, m >> (2 * rb), m >> (3 * rb)
        pde_hit, pde_way, row3 = tlbs._probe(st.pde_pwc, leaf_id)
        pdpte_hit, pdpte_way, row4 = tlbs._probe(st.pdpte_pwc, mid_id)

        leaf_n = st.leaf_node.index_select(0, leaf_id)
        mid_n = st.mid_node.index_select(
            0, mid_id.clamp(max=st.mid_node.shape[0] - 1))
        top_n = st.top_node.index_select(
            0, top_id.clamp(max=st.top_node.shape[0] - 1))

        # the four draws of sites 1-4 (leaf, mid, top, data) at once
        draws = bern_hash(self.site_seeds, (
            torch.stack([m, mid_id, top_id, m]), now, self.tid)) < self.thr[s]
        leaf_llc, up1_llc, up2_llc, data_llc = draws.unbind(0)

        llc_hit = float(cc.llc_hit)
        leaf_read = torch.where(leaf_llc, llc_hit, read_lat[leaf_n.long() + 1])
        mid_read = torch.where(pde_hit, 0.0, torch.where(
            up1_llc, llc_hit, read_lat[mid_n.long() + 1]))
        full = ~pde_hit & ~pdpte_hit
        root_read = torch.where(full, llc_hit, 0.0)
        reads = [~leaf_llc, ~pde_hit & ~up1_llc]
        if mc.page_order > 0:
            # no top level under THP; the reference adds a zero there
            walk = leaf_read + mid_read + root_read
        else:
            top_read = torch.where(full, torch.where(
                up2_llc, llc_hit, read_lat[top_n.long() + 1]), 0.0)
            walk = leaf_read + mid_read + top_read + root_read
            reads.append(full & ~up2_llc)
        walk_cost = torch.where(walkn, walk, 0.0)
        walk_reads = (torch.stack(reads) & walkn).sum(dtype=I32)

        dl = data_n.long() + 1
        mem_lat = torch.where(w_row, write_lat[dl], read_lat[dl])
        data_cost = torch.where(vec, torch.where(data_llc, llc_hit, mem_lat),
                                0.0)

        tlb_penalty = torch.where(vec & ~hit1, float(cc.stlb_hit), 0.0)
        stall = walk_cost + cc.data_stall_frac * data_cost
        total = torch.where(vec, float(cc.cpu_work), 0.0) + tlb_penalty + stall

        tlbs._write(st.l1_tlb, row1, way1, m, now, vec)
        tlbs._write(st.stlb, row2, way2, m, now, vec & ~hit1)
        tlbs._write(st.pde_pwc, row3, pde_way, leaf_id, now, walkn)
        tlbs._write(st.pdpte_pwc, row4, pdpte_way, mid_id, now, walkn)

        st.access_recent.index_add_(0, m, vec.to(I32))
        st.written_recent.index_add_(0, m, (vec & w_row).to(I32))

        cyc = st.cycles
        cyc.total += total
        cyc.walk += walk_cost
        cyc.stall += stall
        cyc.data_mem += data_cost
        c = st.counters
        c.l1_hits += (vec & hit1).sum(dtype=I32)
        c.stlb_hits += (vec & ~hit1 & hit2).sum(dtype=I32)
        c.walks += walkn.sum(dtype=I32)
        c.walk_mem_reads += walk_reads
        return m, active & ~mapped

    # ------------------------------ phase B --------------------------------
    def phase_b(self, s: int, now: int, m: torch.Tensor,
                fault_mask: torch.Tensor):
        """The batched fault engine: first-thread-wins masks from live
        state, the serialized allocator, then vectorized commits."""
        st, mc, cc = self.st, self.mc, self.cc
        T, rb, nn = mc.n_threads, mc.radix_bits, mc.n_nodes
        read_lat, write_lat = self.tables.read, self.tables.write
        sched_row, w_row = self.sched[s], self.is_write[s]
        do = ((sched_row & int(SCHED_DO)) > 0) & fault_mask
        winner = ((sched_row & int(SCHED_WINNER)) > 0) & fault_mask
        tid = self.tid

        leaf_idx = m >> rb
        pt_idx = (torch.zeros_like(m),
                  (m >> (3 * rb)).clamp(max=st.top_node.shape[0] - 1),
                  (m >> (2 * rb)).clamp(max=st.mid_node.shape[0] - 1),
                  leaf_idx)
        pt_arrs = (st.root_node, st.top_node, st.mid_node, st.leaf_node)
        need_cols = []
        for idx, arr in zip(pt_idx, pt_arrs):
            n_e = arr.shape[0]
            cand = winner & (arr.index_select(0, idx) < 0)
            # scatter-min of thread ids per missing entry: the first winner
            first = torch.full((n_e + 1,), T, dtype=I32, device=m.device)
            first.scatter_reduce_(0, torch.where(cand, idx, n_e).long(), tid,
                                  "amin")
            need_cols.append(cand & (first.index_select(0, idx) == tid))
        need_pt = torch.stack(need_cols, dim=-1)                 # bool[T, 4]

        nodes, slow, ok, act, gate, nfree, nrec, ptr, oom = \
            alloc_mod.alloc_many(st.node_free, st.node_reclaimable,
                                 st.interleave_ptr, st.oom_killed, self.wm,
                                 self.data_policy, self.pt_policy, mc,
                                 need_pt, winner, slot_thread=self.slots[s])
        fault = winner & gate          # threads that run the fault handler
        wait = do & ~winner & gate     # an earlier thread mapped m this step
        handled = wait | fault

        # ---- commit PT placements (one first winner per entry) and the
        # data pages ------------------------------------------------------
        commit = act & ok
        st.root_node, st.top_node, st.mid_node, st.leaf_node = (
            _set_where(arr, idx, nodes[:, lvl], commit[:, lvl])
            for lvl, (idx, arr) in enumerate(zip(pt_idx, pt_arrs)))
        node_d, ok_d, commit_d = nodes[:, 4], ok[:, 4], commit[:, 4]
        st.data_node = _set_where(st.data_node, m, node_d, commit_d)
        st.leaf_dram_children.index_add_(
            0, leaf_idx, (commit_d & is_dram(node_d)).to(I32))

        # ---- cost model: the sequential per-thread f32 chains ----------
        alloc_cost = torch.where(slow, float(cc.alloc_slow),
                                 float(cc.alloc_fast))
        zero_cost = cc.zero_lines * write_lat[nodes.long() + 1]
        c = torch.zeros((T,), dtype=F32, device=m.device)
        for lvl in range(4):
            do_l = commit[:, lvl]
            c = c + torch.where(do_l, zero_cost[:, lvl], 0.0) \
                + torch.where(do_l, alloc_cost[:, lvl], 0.0) \
                + torch.where(act[:, lvl] & ~ok[:, lvl], float(cc.oom_scan), 0.0)
        c = c + torch.where(ok_d, zero_cost[:, 4] + alloc_cost[:, 4],
                            float(cc.oom_scan))
        mid_n = st.mid_node.index_select(0, pt_idx[2])   # post-commit
        leaf_n = st.leaf_node.index_select(0, leaf_idx)
        c = c + cc.fault_base + read_lat[mid_n.long() + 1] \
            + write_lat[leaf_n.long() + 1]
        fcost = torch.where(fault, c, 0.0)
        wait_cost = torch.where(wait, cc.fault_base + float(cc.llc_hit), 0.0)
        all_cost = fcost + wait_cost

        # ---- TLB fills: thread-private, so touch-or-insert vectorizes --
        for tlb, tag in ((st.l1_tlb, m), (st.stlb, m),
                         (st.pde_pwc, leaf_idx), (st.pdpte_pwc, m >> (2 * rb))):
            _, way, row = tlbs._probe(tlb, tag)
            tlbs._write(tlb, row, way, tag, now, handled)
        st.access_recent.index_add_(0, m, handled.to(I32))
        st.written_recent.index_add_(0, m, (handled & w_row).to(I32))

        # ---- counters and OOM latch -------------------------------------
        fails = act & ~ok
        pt_commit = commit[:, :4]
        cnt = st.counters
        cnt.pt_allocs.index_add_(0, nodes[:, :4].clamp(0, nn - 1).reshape(-1),
                                 pt_commit.reshape(-1).to(I32))
        cnt.data_allocs.index_add_(0, node_d.clamp(0, nn - 1),
                                   commit_d.to(I32))
        cnt.slow_allocs += (pt_commit & slow[:, :4]).sum(dtype=I32)
        cnt.faults += fault.sum(dtype=I32)
        cnt.oom_kills += fails.sum(dtype=I32)
        cyc = st.cycles
        cyc.total += all_cost
        cyc.fault += all_cost
        cyc.data_mem += torch.where(wait, float(cc.llc_hit), 0.0)
        st.node_free, st.node_reclaimable = nfree, nrec
        st.interleave_ptr, st.oom_killed = ptr, oom
        st.oom_step = torch.where(fails.any() & (st.oom_step < 0), now,
                                  st.oom_step)

    # ------------------------- phase B, sequential --------------------------
    def phase_b_sequential(self, s: int, now: int, m: torch.Tensor,
                           fault_mask: torch.Tensor):
        """The reference's per-thread fault loop (``phase_b_body``), the
        threads in order.  Its ``lax.cond`` on a thread's fault reads
        device state, so here every update is masked by the thread's own
        predicates instead: the loop branches on host values only."""
        st, cc = self.st, self.cc
        rb = self.mc.radix_bits
        llc_hit = float(cc.llc_hit)
        w_row = self.is_write[s]
        cyc = st.cycles
        for t in range(self.mc.n_threads):
            m_t = m[t:t + 1]
            do = fault_mask[t] & ~st.oom_killed
            now_mapped = st.data_node.index_select(0, m_t) >= 0
            wait = do & now_mapped
            fault = do & ~now_mapped
            wait_cost = torch.where(wait, cc.fault_base + llc_hit, 0.0)
            fcost = self._fault_sequential(t, m_t, fault, now)
            handled = wait | fault
            for tlb, tag in ((st.l1_tlb, m_t), (st.stlb, m_t),
                             (st.pde_pwc, m_t >> rb),
                             (st.pdpte_pwc, m_t >> (2 * rb))):
                tlbs.update_one(tlb, t, tag, now, handled)
            st.access_recent.index_add_(0, m_t, handled.to(I32))
            st.written_recent.index_add_(0, m_t, (handled & w_row[t]).to(I32))
            all_cost = fcost + wait_cost
            cyc.total[t:t + 1].add_(all_cost)
            cyc.fault[t:t + 1].add_(all_cost)
            cyc.data_mem[t:t + 1].add_(torch.where(wait, llc_hit, 0.0))

    def _alloc_pt_level(self, t: int, arr: torch.Tensor, idx: torch.Tensor,
                        is_upper: bool, c: torch.Tensor, now: int,
                        gate: torch.Tensor) -> torch.Tensor:
        """One PT level of thread ``t``'s fault (the reference's
        ``_alloc_pt_level``), where ``gate`` (the thread faults) holds;
        updates ``arr`` in place and returns the cost chain ``c``."""
        st, mc, cc = self.st, self.mc, self.cc
        thp = mc.page_order > 0
        tid, dpol, ppol = self.tid[t], self.data_policy[0], self.pt_policy[0]
        old = arr.index_select(0, idx)
        missing = gate & (old < 0)
        # recompute per allocation: the interleave cursor advances with
        # every page handed out
        data_prefs = alloc_mod.data_prefs_for(dpol, tid, mc, st.interleave_ptr)
        prefs, ignore_wm = alloc_mod.pt_prefs_for(ppol, is_upper, tid, mc,
                                                  data_prefs, thp)
        node, slow, nf, nr, ok = alloc_mod.alloc_one(
            st.node_free, st.node_reclaimable, prefs, self.wm, ignore_wm)
        if is_upper or thp:
            # BHi falls back to the data policy when DRAM is exhausted
            node2, slow2, nf2, nr2, ok2 = alloc_mod.alloc_one(
                st.node_free, st.node_reclaimable, data_prefs, self.wm, False)
            is_bhi = ppol == PT_BIND_HIGH
            use_fb = is_bhi & ~ok
            node = torch.where(use_fb, node2, node)
            slow = torch.where(use_fb, slow2, slow)
            nf = torch.where(use_fb, nf2, nf)
            nr = torch.where(use_fb, nr2, nr)
            ok = ok | (is_bhi & ok2)
        node = node.reshape(1)
        oom = missing & ~ok            # bind_all pathology (section 3.5)
        do = missing & ok
        arr.index_copy_(0, idx.long(), torch.where(do, node, old))
        zero_cost = torch.where(
            do, cc.zero_lines * self.tables.write[node.long() + 1], 0.0)
        acost = torch.where(do, torch.where(slow, float(cc.alloc_slow),
                                            float(cc.alloc_fast)), 0.0)
        adv = do & (ppol == PT_FOLLOW_DATA) & (dpol == INTERLEAVE)
        st.node_free = torch.where(do, nf, st.node_free)
        st.node_reclaimable = torch.where(do, nr, st.node_reclaimable)
        st.interleave_ptr = st.interleave_ptr + adv.to(I32).reshape(())
        st.oom_killed = st.oom_killed | oom.reshape(())
        st.oom_step = torch.where(oom.reshape(()) & (st.oom_step < 0), now,
                                  st.oom_step)
        cnt = st.counters
        cnt.pt_allocs.index_add_(0, node.clamp(0, mc.n_nodes - 1),
                                 do.to(I32))
        cnt.slow_allocs += (do & slow).to(I32).reshape(())
        cnt.oom_kills += oom.to(I32).reshape(())
        return c + zero_cost + acost + torch.where(oom, float(cc.oom_scan), 0.0)

    def _fault_sequential(self, t: int, m_t: torch.Tensor,
                          fault: torch.Tensor, now: int) -> torch.Tensor:
        """Thread ``t``'s fault handler (the reference's ``run_fault``),
        masked by ``fault``: the four PT levels, then the data page.
        Returns its cycles (0 where it does not fault)."""
        st, mc, cc = self.st, self.mc, self.cc
        rb = mc.radix_bits
        read_lat, write_lat = self.tables.read, self.tables.write
        c = torch.zeros((1,), dtype=F32, device=m_t.device)
        levels = ((st.root_node, torch.zeros_like(m_t), True),
                  (st.top_node,
                   (m_t >> (3 * rb)).clamp(max=st.top_node.shape[0] - 1), True),
                  (st.mid_node,
                   (m_t >> (2 * rb)).clamp(max=st.mid_node.shape[0] - 1), True),
                  (st.leaf_node, m_t >> rb, False))
        for arr, idx, is_upper in levels:     # each updated in place
            c = self._alloc_pt_level(t, arr, idx, is_upper, c, now, fault)

        dprefs = alloc_mod.data_prefs_for(self.data_policy[0], self.tid[t], mc,
                                          st.interleave_ptr)
        node, slow, nf, nr, ok = alloc_mod.alloc_one(
            st.node_free, st.node_reclaimable, dprefs, self.wm, False)
        node = node.reshape(1)
        done = fault & ok
        oom = fault & ~ok
        st.data_node.index_copy_(0, m_t.long(), torch.where(
            fault, torch.where(ok, node, -1), st.data_node.index_select(0, m_t)))
        leaf_i = m_t >> rb
        st.leaf_dram_children.index_add_(0, leaf_i,
                                         (done & is_dram(node)).to(I32))
        adv = (self.data_policy[0] == INTERLEAVE) & done
        c = c + torch.where(ok, cc.zero_lines * write_lat[node.long() + 1]
                            + torch.where(slow, float(cc.alloc_slow),
                                          float(cc.alloc_fast)),
                            float(cc.oom_scan))
        mid_n = st.mid_node.index_select(
            0, (m_t >> (2 * rb)).clamp(max=st.mid_node.shape[0] - 1))
        leaf_n = st.leaf_node.index_select(0, leaf_i)
        c = c + cc.fault_base + read_lat[mid_n.long() + 1] \
            + write_lat[leaf_n.long() + 1]
        st.node_free = torch.where(done, nf, st.node_free)
        st.node_reclaimable = torch.where(done, nr, st.node_reclaimable)
        st.interleave_ptr = st.interleave_ptr + adv.to(I32).reshape(())
        st.oom_killed = st.oom_killed | oom.reshape(())
        st.oom_step = torch.where(oom.reshape(()) & (st.oom_step < 0), now,
                                  st.oom_step)
        cnt = st.counters
        cnt.data_allocs.index_add_(0, node.clamp(0, mc.n_nodes - 1),
                                   done.to(I32))
        cnt.faults += fault.to(I32).reshape(())
        cnt.oom_kills += oom.to(I32).reshape(())
        return torch.where(fault, c, 0.0)

    # ------------------------------ frees -----------------------------------
    def free_segment(self, fid: int):
        st, nn = self.st, self.mc.n_nodes

        def per_node(node, mask):
            out = torch.zeros((nn,), dtype=I32, device=node.device)
            return out.index_add_(0, node.clamp(0, nn - 1), mask.to(I32))

        in_seg = self.seg_of_map == fid
        mask_map = in_seg & (st.data_node >= 0)
        freed_per_node = per_node(st.data_node, mask_map)
        freed_dram = mask_map & is_dram(st.data_node) & self.map_has_leaf
        ldc = st.leaf_dram_children.index_add(0, self.leaf_of_map,
                                              -freed_dram.to(I32))
        # Nomad shadows of freed granules are released with the segment.
        mask_shadow = in_seg & (st.shadow_node >= 0)
        freed_shadow = per_node(st.shadow_node, mask_shadow)
        mask_leaf = (self.seg_of_leaf == fid) & (st.leaf_node >= 0)
        freed_leaf = per_node(st.leaf_node, mask_leaf)
        st.data_node = torch.where(mask_map, -1, st.data_node)
        st.shadow_node = torch.where(mask_shadow, -1, st.shadow_node)
        st.leaf_node = torch.where(mask_leaf, -1, st.leaf_node)
        tlbs.invalidate_matching(st.l1_tlb, mask_map, 0)
        tlbs.invalidate_matching(st.stlb, mask_map, 0)
        tlbs.invalidate_matching(st.pde_pwc, mask_leaf, 0)
        st.leaf_dram_children = ldc.clamp(min=0)
        st.node_free = st.node_free + freed_per_node + freed_leaf + freed_shadow
        st.access_recent = torch.where(mask_map, 0, st.access_recent)
        st.written_recent = torch.where(mask_map, 0, st.written_recent)

    # ------------------------------ scan tick --------------------------------
    def scan_op(self, s: int):
        """One AutoNUMA/TPP/Nomad scan and its cycle accounting: the
        migration daemon's cycles, scaled, spread over the threads."""
        st, cost = migrate_mod.autonuma_scan(
            self.st, self.mc, self.cc, self.pc, self.wm, self.budget,
            self.va[s], self.is_write[s], self.tables)
        st.cycles.total += cost * self.cc.mig_cost_scale / self.mc.n_threads
        st.cycles.migration += cost

    # ------------------------------ full step --------------------------------
    def advance(self, n_steps: Optional[int] = None) -> "Stepper":
        """Run the next ``n_steps`` steps (all that are left by default)."""
        hi = self.trace.n_steps if n_steps is None else \
            min(self.s + int(n_steps), self.trace.n_steps)
        for s in range(self.s, hi):
            self.step(s)
        self.s = hi
        self.st.step.fill_(self.start + hi)
        return self

    def step(self, s: int):
        """Step ``s`` of the trace: free, scan tick, phase A, phase B (on a
        step with a fault), timeline row."""
        now = self.start + s
        if self.do_free[s]:
            self.free_segment(int(self.free_seg[s]))
        if self.do_scan[s]:
            self.scan_op(s)
        m, fault_mask = self.phase_a(s, now)
        # faults are bursty (populate) or rare (steady state): skip the
        # fault engine entirely on fault-free steps
        if self.has_fault[s]:
            phase_b = self.phase_b_sequential if self.sequential \
                else self.phase_b
            phase_b(s, now, m, fault_mask)
        self._record(s)

    def _record(self, s: int):
        st = self.st
        cyc, c = st.cycles, st.counters
        sums = torch.stack([cyc.total, cyc.walk, cyc.stall, cyc.data_mem,
                            cyc.fault]).sum(1)
        torch.cat([sums, cyc.migration.reshape(1)], out=self.tl_f32[s])
        leaf = st.leaf_node
        torch.stack([c.faults, st.node_free[:2].sum(dtype=I32),
                     (leaf >= 2).sum(dtype=I32),
                     ((leaf >= 0) & (leaf < 2)).sum(dtype=I32), c.walks,
                     c.data_migrations, c.l4_mig_success, c.l1_hits,
                     c.stlb_hits], out=self.tl_i32[s])

    def result(self) -> RunResult:
        """The steps run so far as a :class:`RunResult` (host numpy)."""
        f32, i32 = (t[:self.s].cpu().numpy() for t in (self.tl_f32, self.tl_i32))
        cols = {**{k: f32[:, i] for i, k in enumerate(_TL_F32)},
                **{k: i32[:, i] for i, k in enumerate(_TL_I32)}}
        return RunResult(final_state=self.st.to_numpy(),
                         timeline={k: cols[k].copy() for k in TIMELINE_KEYS},
                         trace_name=self.trace.name,
                         policy_label=self.pc.label())


# --------------------------- time-blocked engine ------------------------------

def _geom_out_rows(geom, block: int) -> int:
    """Rows each window emits in the reference's compiled program
    (``R_out``): every branch pads its segment outputs to one width."""
    r = block
    if geom is not None:
        _, hoist, split = geom
        if hoist is not None:
            r = max(r, hoist[0] + hoist[1])
        if split is not None:
            r = max(r, split[0] + split[1] + split[2])
    return r


def _geom_rows_in(geom, block: int) -> int:
    """Row padding of each window's input tile: ``2 * block`` whenever a
    hoist or split branch exists (its segment slices must never clamp and
    never read the next window's rows)."""
    if geom is not None and (geom[1] is not None or geom[2] is not None):
        return 2 * block
    return block


# Idle-pad fill values for the nine per-step window arrays, in xs order:
# (va, is_write, free_seg, llc, sched, valid, do_free, do_scan,
# has_fault).  sched=0 carries no DO/WINNER bits, fid=-1 frees nothing,
# valid=False gates the step clock.
WINDOW_PAD_FILLS = (-1, False, -1, 0.0, 0, False, False, False, False)


def window_tiles(arrays, n_steps: int, block: int,
                 fills=WINDOW_PAD_FILLS, rows_to: Optional[int] = None):
    """Idle-pad per-step host arrays to a multiple of ``block`` and tile
    them ``[n_windows, rows, ...]``; ``rows_to`` (``WindowPlan.rows_in``)
    also pads every window's row axis past ``block``, per window."""
    n_w = -(-n_steps // block)
    pad = n_w * block - n_steps
    rpad = (rows_to or block) - block
    out = []
    for a, fill in zip(arrays, fills):
        a = np.asarray(a)
        if pad:
            a = np.concatenate(
                [a, np.full((pad,) + a.shape[1:], fill, a.dtype)])
        a = a.reshape((n_w, block) + a.shape[1:])
        if rpad:
            a = np.concatenate(
                [a, np.full((n_w, rpad) + a.shape[2:], fill, a.dtype)],
                axis=1)
        out.append(a)
    return out


# Semantic window kinds.  ``WindowPlan.kind`` stores the reference's
# *branch index* over the kinds its geometry has ([fast] + [full][hoist]
# [split], in that order); :func:`window_kinds` maps it back.
WIN_FAST, WIN_FULL, WIN_HOIST, WIN_SPLIT = range(4)


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """Host-side plan of one blocked run (the reference's, field for
    field).

    ``geom`` is ``None`` when every window is fast, else ``(has_full,
    (Ph, Qh) | None, (Ps, Es, Qs) | None)`` with pow2 segment capacities;
    ``kind`` / ``seg_a`` / ``seg_b`` per window: branch index, event or
    tick start row, suffix start row; ``emit_valid`` (``[n_windows,
    R_out]`` bool) maps the reference's emitted rows back to trace steps;
    ``counts`` is (fast, full, hoist, split)."""
    geom: Optional[tuple]
    kind: np.ndarray
    seg_a: np.ndarray
    seg_b: np.ndarray
    emit_valid: np.ndarray
    rows_in: int
    block: int
    counts: Tuple[int, int, int, int]

    @property
    def n_windows(self) -> int:
        return len(self.kind)


def _q2(n: int) -> int:
    return 0 if n <= 0 else pow2ceil(int(n))


def plan_windows(do_free, do_scan, has_fault, n_steps: int,
                 block: int) -> WindowPlan:
    """Classify each ``block``-step window of a trace and quantize the
    split geometry, as the reference does:

      fast    no event rows at all;
      hoist   no frees or faults and exactly one scan tick at row ``t``:
              fast[0:t), the hoisted scan op, fast[t:block);
      split   a narrow event span (``<= block // 2``): fast prefix,
              per-step replay of the span, fast suffix;
      full    wide spans, and every partial tail window with fault rows.

    Segment capacities are per-class maxima rounded up to powers of two."""
    n_w = -(-n_steps // block)
    pad = n_w * block - n_steps

    def tile(m):
        m = np.asarray(m, bool)
        if pad:
            m = np.concatenate([m, np.zeros(pad, bool)])
        return m.reshape(n_w, block)

    df, ds, hf = tile(do_free), tile(do_scan), tile(has_fault)
    vl = tile(np.ones(n_steps, bool))
    ev = df | ds | hf

    kinds = np.full(n_w, WIN_FAST, np.int32)
    seg_a = np.zeros(n_w, np.int32)
    seg_b = np.zeros(n_w, np.int32)
    hoist_rows, split_rows = [], []
    for w in range(n_w):
        if not ev[w].any():
            continue
        if not (df[w] | hf[w]).any() and int(ds[w].sum()) == 1:
            t = int(np.argmax(ds[w]))
            kinds[w] = WIN_HOIST
            seg_a[w] = seg_b[w] = t
            hoist_rows.append(t)
            continue
        idx = np.flatnonzero(ev[w])
        f, l = int(idx[0]), int(idx[-1])
        if (l - f + 1) > block // 2 or (hf[w].any() and not vl[w].all()):
            kinds[w] = WIN_FULL
        else:
            kinds[w] = WIN_SPLIT
            seg_a[w], seg_b[w] = f, l + 1
            split_rows.append((f, l - f + 1, block - 1 - l))

    has_full = bool((kinds == WIN_FULL).any())
    hoist_g = (_q2(max(hoist_rows)), _q2(block - min(hoist_rows))) \
        if hoist_rows else None
    split_g = (_q2(max(r[0] for r in split_rows)),
               _q2(max(r[1] for r in split_rows)),
               _q2(max(r[2] for r in split_rows))) if split_rows else None
    geom = (has_full, hoist_g, split_g) \
        if (has_full or hoist_g or split_g) else None

    branch = {WIN_FAST: 0}
    for k, present in ((WIN_FULL, has_full),
                       (WIN_HOIST, hoist_g is not None),
                       (WIN_SPLIT, split_g is not None)):
        if present:
            branch[k] = len(branch)
    kind = np.array([branch[int(k)] for k in kinds], np.int32)

    r_out = _geom_out_rows(geom, block)
    rows_in = _geom_rows_in(geom, block)
    emit = np.zeros((n_w, r_out), bool)
    vlx = np.concatenate([vl, np.zeros_like(vl)], axis=1)
    for w in range(n_w):
        k = int(kinds[w])
        if k in (WIN_FAST, WIN_FULL):
            emit[w, :block] = vl[w]
            continue
        a, b = int(seg_a[w]), int(seg_b[w])
        if k == WIN_HOIST:
            ph, qh = hoist_g
            pre = vlx[w, :ph] & (np.arange(ph) < a)
            emit[w, :ph + qh] = np.concatenate([pre, vlx[w, b:b + qh]])
        else:
            ps, es, qs = split_g
            pre = vlx[w, :ps] & (np.arange(ps) < a)
            mid = vlx[w, a:a + es] & (np.arange(es) < (b - a))
            emit[w, :ps + es + qs] = np.concatenate(
                [pre, mid, vlx[w, b:b + qs]])
    assert int(emit.sum()) == n_steps, \
        f"window plan emits {int(emit.sum())} rows for {n_steps} steps"
    return WindowPlan(
        geom=geom, kind=kind, seg_a=seg_a, seg_b=seg_b, emit_valid=emit,
        rows_in=rows_in, block=block,
        counts=tuple(int((kinds == k).sum()) for k in range(4)))


def blocked_xs(trace: Trace, mc: MachineConfig, pc: PolicyConfig,
               start_step: int = 0, block: int = DEFAULT_BLOCK,
               sched: Optional[np.ndarray] = None, device=None):
    """The reference's window-tiled inputs: ``(xs, plan)``, ``xs`` the
    nine per-step arrays tiled ``[n_windows, plan.rows_in, ...]`` plus the
    plan's branch index and segment offsets, as tensors on ``device``.
    :class:`BlockedRunner` reads the per-step rows directly and needs only
    the plan."""
    dev = resolve_device(device)
    S = trace.n_steps
    if sched is None:
        sched = fault_schedule(trace, mc)
    do_free = np.asarray(trace.free_seg) >= 0
    do_scan = scan_step_mask(S, int(pc.autonuma_period),
                             enabled=bool(pc.autonuma),
                             start_step=start_step)
    has_fault = np.asarray((sched & SCHED_DO) > 0).any(axis=1)
    plan = plan_windows(do_free, do_scan, has_fault, S, block)
    tiles = window_tiles(
        (trace.va.astype(np.int32), np.asarray(trace.is_write, bool),
         np.asarray(trace.free_seg, np.int32),
         np.asarray(trace.llc, np.float32), sched, np.ones((S,), bool),
         do_free, do_scan, has_fault),
        S, block, rows_to=plan.rows_in)
    xs = tuple(torch.as_tensor(a, device=dev)
               for a in (*tiles, plan.kind, plan.seg_a, plan.seg_b))
    return xs, plan


def window_kinds(plan: WindowPlan) -> np.ndarray:
    """The semantic kind (``WIN_*``) of each window of ``plan``."""
    order = [WIN_FAST]
    if plan.geom is not None:
        order += [k for k, g in zip((WIN_FULL, WIN_HOIST, WIN_SPLIT),
                                    plan.geom) if g]
    return np.asarray(order, np.int32)[plan.kind]


def window_ops(plan: WindowPlan, n_steps: int):
    """Per window, what the blocked engine runs, in step order:
    ``("fast", a, b)`` the event-free steps ``a..b-1`` in one fast window,
    ``("steps", a, b)`` those steps replayed one by one, ``("scan", s,
    s + 1)`` the scan tick of step ``s`` hoisted before it.  Empty
    segments are left out: they are exact no-ops in the reference."""
    B = plan.block
    out = []
    for w, k in enumerate(window_kinds(plan)):
        lo, hi = w * B, min((w + 1) * B, n_steps)
        a, b = lo + int(plan.seg_a[w]), lo + int(plan.seg_b[w])
        if k == WIN_FAST:
            segs = [("fast", lo, hi)]
        elif k == WIN_FULL:
            segs = [("steps", lo, hi)]
        elif k == WIN_HOIST:
            segs = [("fast", lo, a), ("scan", a, a + 1), ("fast", a, hi)]
        else:
            segs = [("fast", lo, a), ("steps", a, b), ("fast", b, hi)]
        out.append([(op, x, y) for op, x, y in segs if y > x])
    return out


def fast_window_tile(stepper: Stepper, s0: int, s1: int) -> None:
    """Steps ``s0..s1-1`` of ``stepper``'s run, an event-free segment (no
    free, no scan tick, no fault), as the reference's ``fast_window``.

    Placements are constant over such a segment, so one ``ops.fast_window``
    launch does all of it: the gathers, Bernoulli draws (``Stepper``'s site
    seeds and thresholds) and latency terms, the TLB and page-walk-cache
    chain, the hotness counts and the counters.  Mapped-ness needs no
    check: host-mapped is a subset of device-mapped, so every active access
    hits a mapped page.  The timeline rows are the segment's constant
    columns (``_record`` at ``s0``), to which the launch adds each row's
    counts, and the per-row sums over the threads of the kernel's
    accumulators (the same reduction as ``Stepper._record``)."""
    st, mc, cc = stepper.st, stepper.mc, stepper.cc
    stepper._record(s0)
    tl_f, tl_i = stepper.tl_f32[s0:s1], stepper.tl_i32[s0:s1]
    tl_f[1:] = tl_f[0]
    tl_i[1:] = tl_i[0]
    cyc, c = st.cycles, st.counters
    cum = ops.fast_window(
        stepper.va[s0:s1][None], stepper.is_write[s0:s1][None],
        stepper.thr[s0:s1].view(1, s1 - s0, 4), st.oom_killed.view(1),
        [a[None] for a in (st.data_node, st.leaf_node, st.mid_node,
                           st.top_node)],
        (stepper.tables.read, stepper.tables.write),
        [(tlb.tags[None], tlb.lru[None]) for tlb in
         (st.l1_tlb, st.stlb, st.pde_pwc, st.pdpte_pwc)],
        [a[None] for a in (cyc.total, cyc.walk, cyc.stall, cyc.data_mem)],
        [x.view(1) for x in (c.l1_hits, c.stlb_hits, c.walks,
                             c.walk_mem_reads)],
        (st.access_recent[None], st.written_recent[None]),
        [tl_i[:, k][None] for k in (7, 8, 4)],   # l1 hits, stlb hits, walks
        now0=stepper.start + s0, map_shift=mc.map_shift,
        radix_bits=mc.radix_bits, thp=mc.page_order > 0,
        costs=(cc.llc_hit, cc.stlb_hit, cc.cpu_work, cc.data_stall_frac))
    tl_f[:, :4] = cum[0].sum(-1)


class BlockedRunner:
    """One run of the time-blocked engine in progress (the reference's
    ``_build_blocked_body`` and the blocked half of its ``run``).

    The host plan (:func:`plan_windows`) dispatches each window: a fast
    window is one :func:`fast_window_tile`; a full window replays its steps
    through a :class:`Stepper`, with the configured fault path; a hoist
    window runs its fast prefix, the scan tick, its fast suffix; a split
    window its fast prefix, the event span step by step, its fast suffix.
    Only live rows run (the reference masks the others into exact
    no-ops), so the kernel is launched once per non-empty fast segment
    (:attr:`fast_segments`).  :meth:`advance` runs windows, as
    ``Stepper.advance`` runs steps; the timeline comes out in step order.
    :attr:`host_s` sums the host's seconds in each kind of segment (fast,
    scan, steps): the time to issue its work, as the loop never waits on
    the device.
    """

    def __init__(self, sim: "TieredMemSimulator", trace: Trace,
                 state: Optional[SimState] = None):
        self.stepper = Stepper(sim, trace, state)
        S = trace.n_steps
        self.block = min(sim.block, pow2ceil(S))
        stp = self.stepper
        self.plan = plan_windows(stp.do_free, stp.do_scan, stp.has_fault, S,
                                 self.block)
        self.ops = window_ops(self.plan, S)
        self.w = 0                          # windows done
        self.host_s = dict.fromkeys(("fast", "scan", "steps"), 0.0)

    @property
    def fast_segments(self) -> int:
        """Fast segments of the whole run: the kernel launches it makes."""
        return sum(op == "fast" for win in self.ops for op, _, _ in win)

    @property
    def st(self) -> SimState:
        return self.stepper.st

    def advance(self, n_windows: Optional[int] = None) -> "BlockedRunner":
        """Run the next ``n_windows`` windows (all that are left by
        default)."""
        stp = self.stepper
        n_w = self.plan.n_windows
        hi = n_w if n_windows is None else min(self.w + int(n_windows), n_w)
        for win in self.ops[self.w:hi]:
            for op, a, b in win:
                t0 = time.perf_counter()
                if op == "fast":
                    fast_window_tile(stp, a, b)
                elif op == "scan":
                    stp.scan_op(a)
                else:
                    for s in range(a, b):
                        stp.step(s)
                self.host_s[op] += time.perf_counter() - t0
        self.w = hi
        stp.s = min(hi * self.block, stp.trace.n_steps)
        stp.st.step.fill_(stp.start + stp.s)
        return self

    def result(self) -> RunResult:
        """The windows run so far as a :class:`RunResult` (host numpy)."""
        return self.stepper.result()


class TieredMemSimulator:
    """Public facade: configure once, run traces under a policy bundle.

    Keeps the reference's signature and gate.  ``engine="blocked"`` (the
    default) is the time-blocked engine (:class:`BlockedRunner`);
    ``"per_step"`` is the step-at-a-time engine (:class:`Stepper`).
    ``phase_b="batched"`` (default) is the conflict-aware vectorized fault
    path, ``"sequential"`` the per-thread loop it is tested against.  The
    per-step engine and the sequential path are differential oracles and
    need ``debug=True``, as in the reference.  There is no ``telemetry``.
    ``device`` (``None``: the CUDA device) is where the run's state lives
    and its steps run.
    """

    def __init__(self, mc: MachineConfig = MachineConfig(),
                 cc: CostConfig = CostConfig(),
                 pc: PolicyConfig = PolicyConfig(),
                 phase_b: str = "batched",
                 engine: str = "blocked",
                 block: int = DEFAULT_BLOCK,
                 debug: bool = False,
                 device=None):
        if engine not in ("blocked", "per_step") or \
                phase_b not in ("batched", "sequential"):
            raise ValueError(f"unknown engine={engine!r} or phase_b={phase_b!r}")
        if (engine != "blocked" or phase_b != "batched") and not debug:
            raise ValueError(
                f"engine={engine!r} phase_b={phase_b!r} are reference "
                f"(oracle) paths; pass debug=True to run them")
        self.mc, self.cc, self.pc = mc, cc, pc
        self.phase_b = phase_b
        self.engine = engine
        self.block = int(block)
        self.debug = bool(debug)
        self.device = resolve_device(device)

    def runner(self, trace: Trace, state: Optional[SimState] = None):
        """A run of ``trace`` from ``state`` (the empty machine by
        default; a resumed state may hold tensors or numpy arrays) on the
        configured engine: a :class:`BlockedRunner` (``advance`` by
        windows) or a :class:`Stepper` (``advance`` by steps)."""
        if self.engine == "blocked":
            return BlockedRunner(self, trace, state)
        return Stepper(self, trace, state)

    def run(self, trace: Trace, state: Optional[SimState] = None) -> RunResult:
        return self.runner(trace, state).advance().result()
