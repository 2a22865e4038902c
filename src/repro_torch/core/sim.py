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
from .migrate import lane_add_at, lane_lat, lane_take
from .state import SimState, init_state, is_dram
from ..device import resolve_device
from ..kernels import ops
from ..obs import or_null

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
    return torch.as_tensor(_seg_of_leaf(trace, mc), device=device)


def _seg_of_leaf(trace: Trace, mc: MachineConfig) -> np.ndarray:
    leaf_first = (np.arange(mc.n_leaf_pages, dtype=np.int64)
                  << mc.radix_bits) % max(mc.n_map, 1)
    return np.asarray(trace.seg_of_map, np.int32)[leaf_first]


def stack_leaves(objs, device=None):
    """``L`` configs of one dataclass (``CostConfig`` or ``PolicyConfig``)
    as one whose fields are ``[L]`` tensors on ``device``, with the
    reference's dtypes (``sweep._stack_leaves``): integers int32, floats
    float32, flags bool."""
    objs = list(objs)
    dev = resolve_device(device)
    fields = {}
    for f in dataclasses.fields(objs[0]):
        a = np.stack([np.asarray(getattr(o, f.name)) for o in objs])
        if a.dtype.kind in "iu":
            a = a.astype(np.int32)
        elif a.dtype.kind == "f":
            a = a.astype(np.float32)
        fields[f.name] = torch.as_tensor(a, device=dev)
    return type(objs[0])(**fields)


def lane_period(policies) -> int:
    """The scan period the lanes share: that of every lane with AutoNUMA
    on (the schedule is one host predicate for all of them), else the
    first lane's."""
    periods = sorted({int(p.autonuma_period) for p in policies
                      if bool(p.autonuma)})
    if len(periods) > 1:
        raise ValueError(
            f"swept policies must share autonuma_period, got {periods}; the "
            "scan schedule is lane-shared")
    return periods[0] if periods else int(policies[0].autonuma_period)


# Timeline columns as the step loop keeps them: the f32 sums, then the
# int32 counts (TIMELINE_KEYS gives the reference's order).
_TL_F32 = ("total_cycles", "walk_cycles", "stall_cycles", "data_mem_cycles",
           "fault_cycles", "migration_cycles")
_TL_I32 = ("faults", "dram_free", "leaf_nvmm", "leaf_dram", "walks",
           "data_migrations", "l4_mig_success", "l1_hits", "stlb_hits")


def _set_where(arr: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """``arr`` (``[L, n]``) with ``arr[l, idx[l, i]] = vals[l, i]`` where
    ``mask[l, i]``; each lane's masked indices are unique, and the other
    entries go to a sentinel column past the end that is sliced off (the
    reference drops them out of range)."""
    n = arr.shape[-1]
    ext = torch.cat([arr, arr[..., :1]], -1)
    ext.scatter_(-1, torch.where(mask, idx, n).long(), vals)
    return ext[..., :n].contiguous()


class Stepper:
    """``L`` runs of the per-step engine in progress, one lane each (a
    single run is ``L = 1``): lane ``l`` runs ``traces[l]`` under
    ``ccs[l]`` and ``pcs[l]``.

    :meth:`TieredMemSimulator.run` is ``runner(trace).advance()`` then
    :meth:`result`; stepping in pieces gives the same state (a caller can
    time or profile a window of steps).  Everything the loop reads is put
    on the device here, before the first step: the trace rows step-major
    (``[S, L, ...]``; host arrays built once per distinct trace object and
    fanned out to its lanes), every ``CostConfig`` / ``PolicyConfig``
    value as a per-lane tensor (:func:`stack_leaves`).  The loop branches
    only on host values that the lanes share: the union of the lanes'
    frees and faults, and the one scan schedule.  The blocked engine
    (:class:`BlockedRunner`) drives one of these for its per-step spans.

    ``budget`` is the scan's candidate bound (default: the lanes' largest
    ``autonuma_budget``); ``group`` the allocator's slots per step
    (default: the lanes' most winners in a step, a power of two, at most
    ``n_threads``); either may raise its default and not lower it, as the
    reference's sweep checks.  A resumed ``state`` holds the lanes' runs,
    all at one step (one run's fields without a lane axis are ``L = 1``).
    """

    def __init__(self, mc: MachineConfig, ccs, pcs, traces, *,
                 phase_b: str = "batched", device=None,
                 state: Optional[SimState] = None,
                 budget: Optional[int] = None, group: Optional[int] = None):
        self.mc, self.ccs, self.pcs = mc, list(ccs), list(pcs)
        self.traces = list(traces)
        L = self.L = len(self.traces)
        if not (L > 0 and len(self.ccs) == len(self.pcs) == L):
            raise ValueError(f"lane lists disagree: {len(self.ccs)} costs, "
                             f"{len(self.pcs)} policies, {L} traces")
        dev = resolve_device(device)
        T = mc.n_threads
        shape = self.traces[0].va.shape
        for tr in self.traces:
            if tr.va.shape != shape:
                raise ValueError(
                    f"lane traces must share one shape; got {tr.va.shape} "
                    f"vs {shape} — pad_trace() them first")
        if shape[1] != T:
            raise ValueError(f"traces have {shape[1]} threads, machine has "
                             f"{T}")
        period = lane_period(self.pcs)        # raises on mixed periods
        self.sequential = phase_b == "sequential"
        S = self.n_steps = shape[0]
        lane_budget = min(max(int(p.autonuma_budget) for p in self.pcs),
                          mc.n_map)
        if budget is not None and budget < lane_budget:
            raise ValueError(f"budget override {budget} below the lane "
                             f"maximum {lane_budget}; a smaller top_k bound "
                             "changes results")
        self.budget = lane_budget if budget is None else min(int(budget),
                                                             mc.n_map)

        # host arrays once per distinct trace object, fanned out to lanes
        uniq: Dict[int, int] = {}
        uniq_traces = []
        lane_of = np.empty((L,), np.int64)
        for i, tr in enumerate(self.traces):
            j = uniq.setdefault(id(tr), len(uniq_traces))
            if j == len(uniq_traces):
                uniq_traces.append(tr)
            lane_of[i] = j
        scheds = [fault_schedule(tr, mc) for tr in uniq_traces]  # memoized
        lane_group = min(
            pow2ceil(max(fault_group_bound(sc) for sc in scheds)), T)
        if group is not None and group < lane_group and not self.sequential:
            raise ValueError(f"group override {group} below the lane "
                             f"maximum {lane_group}; a smaller conflict-"
                             "group bound drops allocator requests")
        self.group = lane_group if group is None else min(int(group), T)

        def lanes(per_trace, dtype):
            """[S, L, ...]: the per-trace arrays, lane by lane."""
            a = np.stack([np.asarray(x, dtype) for x in per_trace], axis=1)
            return np.ascontiguousarray(a[:, lane_of])

        if state is None:
            self.st = init_state(mc, dev, lanes=L)
            self.start = 0
        else:
            if np.ndim(state.data_node) == 1:       # one run's fields
                state = state.with_lane_axis()
            self.st = state.to(dev)
            steps = np.unique(self.st.step.cpu().numpy())
            if self.st.data_node.shape[0] != L or steps.size != 1:
                raise ValueError("a resumed state holds the lanes' runs, "
                                 "all at one step")
            self.start = int(steps[0])
        free_seg = lanes([tr.free_seg for tr in uniq_traces], np.int32)
        self.do_free = (free_seg >= 0).any(axis=1)
        self.has_fault = np.zeros((S,), bool)
        for sc in scheds:
            self.has_fault |= (sc & SCHED_DO).any(axis=1)
        self.do_scan = scan_step_mask(
            S, period,
            enabled=any(bool(p.autonuma) for p in self.pcs),
            start_step=self.start)
        self.va = torch.as_tensor(lanes([tr.va for tr in uniq_traces],
                                        np.int32), device=dev)
        self.is_write = torch.as_tensor(
            lanes([tr.is_write for tr in uniq_traces], bool), device=dev)
        self.sched = torch.as_tensor(lanes(scheds, np.uint8), device=dev)
        self.fid = torch.as_tensor(free_seg, device=dev)

        # allocator conflict-group slots per step: the host winners' prefix
        # count, pad slots = T (alloc.alloc_many's slot_thread)
        slots = []
        for sc in scheds:
            win = (sc & SCHED_WINNER) > 0
            slot = np.cumsum(win, axis=1) - 1
            row = np.full((S, self.group), T, np.int32)
            rows, cols = np.nonzero(win & (slot < self.group))
            row[rows, slot[rows, cols]] = cols
            slots.append(row)
        self.slots = torch.as_tensor(lanes(slots, np.int32), device=dev)

        # bern: the seeds of sites 1-4 (leaf, mid, top, data) and each
        # step's thresholds per lane (the data site's follows the trace's llc)
        self.site_seeds = torch.tensor([[[_site_seed(s)]] for s in (1, 2, 3, 4)],
                                       dtype=torch.int64, device=dev)
        thr = np.empty((S, L, 4), np.int64)
        thr[:, :, 0] = [bern_threshold(cc.leaf_llc_hit) for cc in self.ccs]
        thr[:, :, 1:3] = np.array([bern_threshold(cc.upper_llc_hit)
                                   for cc in self.ccs])[:, None]
        llc = lanes([tr.llc for tr in uniq_traces], np.float32)
        thr[:, :, 3] = (llc * np.float32(1 << 24)).astype(np.int64)
        self.thr = torch.as_tensor(thr, device=dev)

        # per-lane costs and policies: [L] (the scan), [L, 1] (per thread)
        self.cc = stack_leaves(self.ccs, dev)
        self.pc = stack_leaves(self.pcs, dev)
        self.col = type(self.cc)(**{f.name: getattr(self.cc, f.name)[:, None]
                                    for f in dataclasses.fields(self.cc)})
        col = self.col
        self.llc_hit, self.stlb_hit, self.cpu_work, self.stall_frac = (
            x.to(F32) for x in (col.llc_hit, col.stlb_hit, col.cpu_work,
                                col.data_stall_frac))
        # the integer costs that the fault's f32 chain selects with where
        self.alloc_slow, self.alloc_fast, self.oom_scan = (
            x.to(F32) for x in (col.alloc_slow, col.alloc_fast, col.oom_scan))
        self.wait_cost = col.fault_base + self.llc_hit
        self.window_costs = torch.cat([self.llc_hit, self.stlb_hit,
                                       self.cpu_work, self.stall_frac], 1)
        self.families = migrate_mod.ScanFamilies.of(self.pcs)

        self.tid = torch.arange(T, dtype=I32, device=dev)
        self.wm = alloc_mod.watermark_pages(mc, dev)
        self.tables = migrate_mod.lane_tables(self.ccs, mc, dev)
        self.seg_of_map = torch.as_tensor(
            lanes([tr.seg_of_map for tr in uniq_traces], np.int32).T.copy(),
            device=dev)
        self.seg_of_leaf = torch.as_tensor(
            lanes([_seg_of_leaf(tr, mc) for tr in uniq_traces], np.int32)
            .T.copy(), device=dev)
        leaf_of_map = torch.arange(mc.n_map, device=dev) >> mc.radix_bits
        self.map_has_leaf = leaf_of_map < mc.n_leaf_pages
        self.leaf_of_map = leaf_of_map.clamp(max=mc.n_leaf_pages - 1) \
            .expand(L, -1)
        self.tl_f32 = torch.zeros((S, L, len(_TL_F32)), dtype=F32, device=dev)
        self.tl_i32 = torch.zeros((S, L, len(_TL_I32)), dtype=I32, device=dev)
        self.s = 0                          # steps done

    # ------------------------------ phase A --------------------------------
    def phase_a(self, s: int, now: int):
        st, mc = self.st, self.mc
        rb = mc.radix_bits
        read_lat, write_lat = self.tables.read, self.tables.write
        va_row, w_row = self.va[s], self.is_write[s]          # [L, T]
        m = torch.where(va_row >= 0, va_row >> mc.map_shift, 0).clamp(
            0, mc.n_map - 1)
        data_n = lane_take(st.data_node, m)
        mapped = data_n >= 0
        active = (va_row >= 0) & ~st.oom_killed[:, None]
        vec = active & mapped

        hit1, way1, row1 = tlbs._probe(st.l1_tlb, m)
        hit2, way2, row2 = tlbs._probe(st.stlb, m)
        walkn = vec & ~hit1 & ~hit2

        leaf_id, mid_id, top_id = m >> rb, m >> (2 * rb), m >> (3 * rb)
        pde_hit, pde_way, row3 = tlbs._probe(st.pde_pwc, leaf_id)
        pdpte_hit, pdpte_way, row4 = tlbs._probe(st.pdpte_pwc, mid_id)

        leaf_n = lane_take(st.leaf_node, leaf_id)
        mid_n = lane_take(st.mid_node,
                          mid_id.clamp(max=st.mid_node.shape[1] - 1))
        top_n = lane_take(st.top_node,
                          top_id.clamp(max=st.top_node.shape[1] - 1))

        # the four draws of sites 1-4 (leaf, mid, top, data) at once
        draws = bern_hash(self.site_seeds, (
            torch.stack([m, mid_id, top_id, m]), now, self.tid)) \
            < self.thr[s].T[:, :, None]
        leaf_llc, up1_llc, up2_llc, data_llc = draws.unbind(0)

        llc_hit = self.llc_hit
        leaf_read = torch.where(leaf_llc, llc_hit, lane_lat(read_lat, leaf_n))
        mid_read = torch.where(pde_hit, 0.0, torch.where(
            up1_llc, llc_hit, lane_lat(read_lat, mid_n)))
        full = ~pde_hit & ~pdpte_hit
        root_read = torch.where(full, llc_hit, 0.0)
        reads = [~leaf_llc, ~pde_hit & ~up1_llc]
        if mc.page_order > 0:
            # no top level under THP; the reference adds a zero there
            walk = leaf_read + mid_read + root_read
        else:
            top_read = torch.where(full, torch.where(
                up2_llc, llc_hit, lane_lat(read_lat, top_n)), 0.0)
            walk = leaf_read + mid_read + top_read + root_read
            reads.append(full & ~up2_llc)
        walk_cost = torch.where(walkn, walk, 0.0)
        walk_reads = (torch.stack(reads) & walkn).sum((0, 2), dtype=I32)

        dl = data_n + 1
        mem_lat = torch.where(w_row, lane_take(write_lat, dl),
                              lane_take(read_lat, dl))
        data_cost = torch.where(vec, torch.where(data_llc, llc_hit, mem_lat),
                                0.0)

        tlb_penalty = torch.where(vec & ~hit1, self.stlb_hit, 0.0)
        stall = walk_cost + self.stall_frac * data_cost
        total = torch.where(vec, self.cpu_work, 0.0) + tlb_penalty + stall

        tlbs._write(st.l1_tlb, row1, way1, m, now, vec)
        tlbs._write(st.stlb, row2, way2, m, now, vec & ~hit1)
        tlbs._write(st.pde_pwc, row3, pde_way, leaf_id, now, walkn)
        tlbs._write(st.pdpte_pwc, row4, pdpte_way, mid_id, now, walkn)

        lane_add_at(st.access_recent, m, vec.to(I32))
        lane_add_at(st.written_recent, m, (vec & w_row).to(I32))

        cyc = st.cycles
        cyc.total += total
        cyc.walk += walk_cost
        cyc.stall += stall
        cyc.data_mem += data_cost
        c = st.counters
        c.l1_hits += (vec & hit1).sum(1, dtype=I32)
        c.stlb_hits += (vec & ~hit1 & hit2).sum(1, dtype=I32)
        c.walks += walkn.sum(1, dtype=I32)
        c.walk_mem_reads += walk_reads
        return m, active & ~mapped

    # ------------------------------ phase B --------------------------------
    def phase_b(self, s: int, now: int, m: torch.Tensor,
                fault_mask: torch.Tensor):
        """The batched fault engine: first-thread-wins masks from live
        state, the serialized allocator (one launch for every lane), then
        vectorized commits."""
        st, mc, col = self.st, self.mc, self.col
        T, rb, nn, L = mc.n_threads, mc.radix_bits, mc.n_nodes, self.L
        read_lat, write_lat = self.tables.read, self.tables.write
        sched_row, w_row = self.sched[s], self.is_write[s]    # [L, T]
        do = ((sched_row & int(SCHED_DO)) > 0) & fault_mask
        winner = ((sched_row & int(SCHED_WINNER)) > 0) & fault_mask
        tid = self.tid.expand(L, T)

        leaf_idx = m >> rb
        pt_idx = (torch.zeros_like(m),
                  (m >> (3 * rb)).clamp(max=st.top_node.shape[1] - 1),
                  (m >> (2 * rb)).clamp(max=st.mid_node.shape[1] - 1),
                  leaf_idx)
        pt_arrs = (st.root_node, st.top_node, st.mid_node, st.leaf_node)
        need_cols = []
        for idx, arr in zip(pt_idx, pt_arrs):
            n_e = arr.shape[1]
            il = idx.long()
            cand = winner & (arr.gather(1, il) < 0)
            # scatter-min of thread ids per missing entry: the first winner
            first = torch.full((L, n_e + 1), T, dtype=I32, device=m.device)
            first.scatter_reduce_(1, torch.where(cand, il, n_e), tid, "amin")
            need_cols.append(cand & (first.gather(1, il) == tid))
        need_pt = torch.stack(need_cols, dim=-1)              # bool[L, T, 4]

        nodes, slow, ok, act, gate, nfree, nrec, ptr, oom = \
            alloc_mod.alloc_many(st.node_free, st.node_reclaimable,
                                 st.interleave_ptr, st.oom_killed, self.wm,
                                 self.pc.data_policy, self.pc.pt_policy, mc,
                                 need_pt, winner, slot_thread=self.slots[s])
        fault = winner & gate          # threads that run the fault handler
        wait = do & ~winner & gate     # an earlier thread mapped m this step
        handled = wait | fault

        # ---- commit PT placements (one first winner per entry) and the
        # data pages ------------------------------------------------------
        commit = act & ok
        st.root_node, st.top_node, st.mid_node, st.leaf_node = (
            _set_where(arr, idx, nodes[..., lvl], commit[..., lvl])
            for lvl, (idx, arr) in enumerate(zip(pt_idx, pt_arrs)))
        node_d, ok_d, commit_d = nodes[..., 4], ok[..., 4], commit[..., 4]
        st.data_node = _set_where(st.data_node, m, node_d, commit_d)
        lane_add_at(st.leaf_dram_children, leaf_idx,
                    (commit_d & is_dram(node_d)).to(I32))

        # ---- cost model: the sequential per-thread f32 chains ----------
        alloc_cost = torch.where(slow, self.alloc_slow[..., None],
                                 self.alloc_fast[..., None])
        zero_cost = col.zero_lines[..., None] * lane_lat(write_lat, nodes)
        oom_scan = self.oom_scan
        c = torch.zeros((L, T), dtype=F32, device=m.device)
        for lvl in range(4):
            do_l = commit[..., lvl]
            c = c + torch.where(do_l, zero_cost[..., lvl], 0.0) \
                + torch.where(do_l, alloc_cost[..., lvl], 0.0) \
                + torch.where(act[..., lvl] & ~ok[..., lvl], oom_scan, 0.0)
        c = c + torch.where(ok_d, zero_cost[..., 4] + alloc_cost[..., 4],
                            oom_scan)
        mid_n = lane_take(st.mid_node, pt_idx[2])         # post-commit
        leaf_n = lane_take(st.leaf_node, leaf_idx)
        c = c + col.fault_base + lane_lat(read_lat, mid_n) \
            + lane_lat(write_lat, leaf_n)
        fcost = torch.where(fault, c, 0.0)
        wait_cost = torch.where(wait, self.wait_cost, 0.0)
        all_cost = fcost + wait_cost

        # ---- TLB fills: thread-private, so touch-or-insert vectorizes --
        for tlb, tag in ((st.l1_tlb, m), (st.stlb, m),
                         (st.pde_pwc, leaf_idx), (st.pdpte_pwc, m >> (2 * rb))):
            _, way, row = tlbs._probe(tlb, tag)
            tlbs._write(tlb, row, way, tag, now, handled)
        lane_add_at(st.access_recent, m, handled.to(I32))
        lane_add_at(st.written_recent, m, (handled & w_row).to(I32))

        # ---- counters and OOM latch -------------------------------------
        fails = act & ~ok
        pt_commit = commit[..., :4]
        cnt = st.counters
        lane_add_at(cnt.pt_allocs, nodes[..., :4].clamp(0, nn - 1),
                    pt_commit.to(I32))
        lane_add_at(cnt.data_allocs, node_d.clamp(0, nn - 1),
                    commit_d.to(I32))
        cnt.slow_allocs += (pt_commit & slow[..., :4]).sum((1, 2), dtype=I32)
        cnt.faults += fault.sum(1, dtype=I32)
        cnt.oom_kills += fails.sum((1, 2), dtype=I32)
        cyc = st.cycles
        cyc.total += all_cost
        cyc.fault += all_cost
        cyc.data_mem += torch.where(wait, self.llc_hit, 0.0)
        st.node_free, st.node_reclaimable = nfree, nrec
        st.interleave_ptr, st.oom_killed = ptr, oom
        st.oom_step = torch.where(fails.flatten(1).any(1) & (st.oom_step < 0),
                                  now, st.oom_step)

    # ------------------------- phase B, sequential --------------------------
    def phase_b_sequential(self, s: int, now: int, m: torch.Tensor,
                           fault_mask: torch.Tensor):
        """The reference's per-thread fault loop (``phase_b_body``), the
        threads in order, each thread's work vectorized over the lanes.
        Its ``lax.cond`` on a thread's fault reads device state, so here
        every update is masked by the thread's own predicates instead: the
        loop branches on host values only."""
        st = self.st
        rb = self.mc.radix_bits
        w_row = self.is_write[s]
        cyc = st.cycles
        for t in range(self.mc.n_threads):
            m_t = m[:, t:t + 1]                                 # [L, 1]
            do = fault_mask[:, t:t + 1] & ~st.oom_killed[:, None]
            now_mapped = lane_take(st.data_node, m_t) >= 0
            wait = do & now_mapped
            fault = do & ~now_mapped
            wait_cost = torch.where(wait, self.wait_cost, 0.0)
            fcost = self._fault_sequential(t, m_t, fault, now)
            handled = wait | fault
            for tlb, tag in ((st.l1_tlb, m_t), (st.stlb, m_t),
                             (st.pde_pwc, m_t >> rb),
                             (st.pdpte_pwc, m_t >> (2 * rb))):
                tlbs.update_one(tlb, t, tag, now, handled)
            lane_add_at(st.access_recent, m_t, handled.to(I32))
            lane_add_at(st.written_recent, m_t,
                        (handled & w_row[:, t:t + 1]).to(I32))
            all_cost = fcost + wait_cost
            cyc.total[:, t:t + 1] += all_cost
            cyc.fault[:, t:t + 1] += all_cost
            cyc.data_mem[:, t:t + 1] += torch.where(wait, self.llc_hit, 0.0)

    def _alloc_pt_level(self, t: int, arr: torch.Tensor, idx: torch.Tensor,
                        is_upper: bool, c: torch.Tensor, now: int,
                        gate: torch.Tensor) -> torch.Tensor:
        """One PT level of thread ``t``'s fault (the reference's
        ``_alloc_pt_level``) in every lane, where ``gate`` (``[L, 1]``: the
        thread faults) holds; updates ``arr`` in place and returns the cost
        chain ``c``."""
        st, mc, col = self.st, self.mc, self.col
        L = self.L
        thp = mc.page_order > 0
        tid, dpol, ppol = self.tid[t], self.pc.data_policy, self.pc.pt_policy
        old = lane_take(arr, idx)
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
            nf = torch.where(use_fb[:, None], nf2, nf)
            nr = torch.where(use_fb[:, None], nr2, nr)
            ok = ok | (is_bhi & ok2)
        node, slow, ok = (x.reshape(L, 1) for x in (node, slow, ok))
        oom = missing & ~ok            # bind_all pathology (section 3.5)
        do = missing & ok
        arr.scatter_(1, idx.long(), torch.where(do, node, old))
        zero_cost = torch.where(
            do, col.zero_lines * lane_lat(self.tables.write, node), 0.0)
        acost = torch.where(do, torch.where(slow, self.alloc_slow,
                                            self.alloc_fast), 0.0)
        adv = do & (ppol == PT_FOLLOW_DATA)[:, None] \
            & (dpol == INTERLEAVE)[:, None]
        st.node_free = torch.where(do, nf, st.node_free)
        st.node_reclaimable = torch.where(do, nr, st.node_reclaimable)
        st.interleave_ptr = st.interleave_ptr + adv.to(I32).reshape(L)
        st.oom_killed = st.oom_killed | oom.reshape(L)
        st.oom_step = torch.where(oom.reshape(L) & (st.oom_step < 0), now,
                                  st.oom_step)
        cnt = st.counters
        lane_add_at(cnt.pt_allocs, node.clamp(0, mc.n_nodes - 1), do.to(I32))
        cnt.slow_allocs += (do & slow).to(I32).reshape(L)
        cnt.oom_kills += oom.to(I32).reshape(L)
        return c + zero_cost + acost + torch.where(oom, self.oom_scan, 0.0)

    def _fault_sequential(self, t: int, m_t: torch.Tensor,
                          fault: torch.Tensor, now: int) -> torch.Tensor:
        """Thread ``t``'s fault handler (the reference's ``run_fault``) in
        every lane, masked by ``fault`` (``[L, 1]``): the four PT levels,
        then the data page.  Returns its cycles (0 where it does not
        fault)."""
        st, mc, col = self.st, self.mc, self.col
        L = self.L
        rb = mc.radix_bits
        read_lat, write_lat = self.tables.read, self.tables.write
        dpol = self.pc.data_policy
        c = torch.zeros((L, 1), dtype=F32, device=m_t.device)
        levels = ((st.root_node, torch.zeros_like(m_t), True),
                  (st.top_node,
                   (m_t >> (3 * rb)).clamp(max=st.top_node.shape[1] - 1), True),
                  (st.mid_node,
                   (m_t >> (2 * rb)).clamp(max=st.mid_node.shape[1] - 1), True),
                  (st.leaf_node, m_t >> rb, False))
        for arr, idx, is_upper in levels:     # each updated in place
            c = self._alloc_pt_level(t, arr, idx, is_upper, c, now, fault)

        dprefs = alloc_mod.data_prefs_for(dpol, self.tid[t], mc,
                                          st.interleave_ptr)
        node, slow, nf, nr, ok = alloc_mod.alloc_one(
            st.node_free, st.node_reclaimable, dprefs, self.wm, False)
        node, slow, ok = (x.reshape(L, 1) for x in (node, slow, ok))
        done = fault & ok
        oom = fault & ~ok
        ml = m_t.long()
        st.data_node.scatter_(1, ml, torch.where(
            fault, torch.where(ok, node, -1), lane_take(st.data_node, m_t)))
        leaf_i = m_t >> rb
        lane_add_at(st.leaf_dram_children, leaf_i,
                    (done & is_dram(node)).to(I32))
        adv = (dpol == INTERLEAVE)[:, None] & done
        c = c + torch.where(ok, col.zero_lines * lane_lat(write_lat, node)
                            + torch.where(slow, self.alloc_slow,
                                          self.alloc_fast),
                            self.oom_scan)
        mid_n = lane_take(st.mid_node,
                          (m_t >> (2 * rb)).clamp(max=st.mid_node.shape[1] - 1))
        leaf_n = lane_take(st.leaf_node, leaf_i)
        c = c + col.fault_base + lane_lat(read_lat, mid_n) \
            + lane_lat(write_lat, leaf_n)
        st.node_free = torch.where(done, nf, st.node_free)
        st.node_reclaimable = torch.where(done, nr, st.node_reclaimable)
        st.interleave_ptr = st.interleave_ptr + adv.to(I32).reshape(L)
        st.oom_killed = st.oom_killed | oom.reshape(L)
        st.oom_step = torch.where(oom.reshape(L) & (st.oom_step < 0), now,
                                  st.oom_step)
        cnt = st.counters
        lane_add_at(cnt.data_allocs, node.clamp(0, mc.n_nodes - 1),
                    done.to(I32))
        cnt.faults += fault.to(I32).reshape(L)
        cnt.oom_kills += oom.to(I32).reshape(L)
        return torch.where(fault, c, 0.0)

    # ------------------------------ frees -----------------------------------
    def free_segment(self, fid: torch.Tensor):
        """Each lane's segment ``fid[l]`` (``i32[L]``) exits; a lane whose
        ``fid`` is -1 is unchanged."""
        st, nn, L = self.st, self.mc.n_nodes, self.L

        def per_node(node, mask):
            out = torch.zeros((L, nn), dtype=I32, device=node.device)
            return out.scatter_add_(1, node.clamp(0, nn - 1).long(),
                                    mask.to(I32))

        live = (fid >= 0)[:, None]
        in_seg = (self.seg_of_map == fid[:, None]) & live
        mask_map = in_seg & (st.data_node >= 0)
        freed_per_node = per_node(st.data_node, mask_map)
        freed_dram = mask_map & is_dram(st.data_node) & self.map_has_leaf
        ldc = st.leaf_dram_children.scatter_add(1, self.leaf_of_map,
                                                -freed_dram.to(I32))
        # Nomad shadows of freed granules are released with the segment.
        mask_shadow = in_seg & (st.shadow_node >= 0)
        freed_shadow = per_node(st.shadow_node, mask_shadow)
        mask_leaf = (self.seg_of_leaf == fid[:, None]) & live \
            & (st.leaf_node >= 0)
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
        """One AutoNUMA/TPP/Nomad scan in every lane (a lane with the scan
        off, or OOM-killed, is an exact no-op) and its cycle accounting:
        the migration daemon's cycles, scaled, spread over the threads."""
        st, cost = migrate_mod.autonuma_scan(
            self.st, self.mc, self.cc, self.pc, self.wm, self.budget,
            self.va[s], self.is_write[s], self.tables, self.families)
        st.cycles.total += (cost * self.cc.mig_cost_scale
                            / self.mc.n_threads)[:, None]
        st.cycles.migration += cost

    # ------------------------------ full step --------------------------------
    def advance(self, n_steps: Optional[int] = None) -> "Stepper":
        """Run the next ``n_steps`` steps (all that are left by default)."""
        hi = self.n_steps if n_steps is None else \
            min(self.s + int(n_steps), self.n_steps)
        for s in range(self.s, hi):
            self.step(s)
        self.s = hi
        self.st.step.fill_(self.start + hi)
        return self

    def step(self, s: int):
        """Step ``s`` of the lanes' traces: frees, scan tick, phase A,
        phase B (on a step where some lane faults), timeline row."""
        now = self.start + s
        if self.do_free[s]:
            self.free_segment(self.fid[s])
        if self.do_scan[s]:
            self.scan_op(s)
        m, fault_mask = self.phase_a(s, now)
        # faults are bursty (populate) or rare (steady state): skip the
        # fault engine entirely on steps where no lane faults
        if self.has_fault[s]:
            phase_b = self.phase_b_sequential if self.sequential \
                else self.phase_b
            phase_b(s, now, m, fault_mask)
        self._record(s)

    def _record(self, s: int):
        st = self.st
        cyc, c = st.cycles, st.counters
        sums = torch.stack([cyc.total, cyc.walk, cyc.stall, cyc.data_mem,
                            cyc.fault]).sum(2)
        torch.cat([sums.T, cyc.migration[:, None]], 1, out=self.tl_f32[s])
        leaf = st.leaf_node
        torch.stack([c.faults, st.node_free[:, :2].sum(1, dtype=I32),
                     (leaf >= 2).sum(1, dtype=I32),
                     ((leaf >= 0) & (leaf < 2)).sum(1, dtype=I32), c.walks,
                     c.data_migrations, c.l4_mig_success, c.l1_hits,
                     c.stlb_hits], 1, out=self.tl_i32[s])

    def results(self) -> "list[RunResult]":
        """The steps run so far, a :class:`RunResult` (host numpy) per
        lane."""
        f32, i32 = (t[:self.s].cpu().numpy() for t in (self.tl_f32, self.tl_i32))
        st = self.st.to_numpy()
        out = []
        for lane, (pc, tr) in enumerate(zip(self.pcs, self.traces)):
            cols = {**{k: f32[:, lane, i] for i, k in enumerate(_TL_F32)},
                    **{k: i32[:, lane, i] for i, k in enumerate(_TL_I32)}}
            out.append(RunResult(
                final_state=st.lane(lane),
                timeline={k: cols[k].copy() for k in TIMELINE_KEYS},
                trace_name=tr.name, policy_label=pc.label()))
        return out

    def result(self, lane: int = 0) -> RunResult:
        """Lane ``lane``'s steps run so far as a :class:`RunResult`."""
        return self.results()[lane]


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
    """Steps ``s0..s1-1`` of ``stepper``'s lanes, an event-free segment (no
    lane frees, scans or faults there), as the reference's
    ``fast_window``.

    Placements are constant over such a segment, so one ``ops.fast_window``
    launch does all of it for every lane: the gathers, Bernoulli draws
    (``Stepper``'s site seeds and thresholds) and latency terms with each
    lane's costs, the TLB and page-walk-cache chain, the hotness counts
    and the counters.  Mapped-ness needs no check: host-mapped is a subset
    of device-mapped, so every active access hits a mapped page.  The
    trace rows go in as views of the step-major tables.  The timeline rows
    are the segment's constant columns (``_record`` at ``s0``), to which
    the launch adds each row's counts, and the per-row sums over the
    threads of the kernel's accumulators (the same reduction as
    ``Stepper._record``)."""
    st, mc = stepper.st, stepper.mc
    stepper._record(s0)
    tl_f, tl_i = stepper.tl_f32[s0:s1], stepper.tl_i32[s0:s1]   # [R, L, .]
    tl_f[1:] = tl_f[0]
    tl_i[1:] = tl_i[0]
    cyc, c = st.cycles, st.counters
    cum = ops.fast_window(
        stepper.va[s0:s1].transpose(0, 1),
        stepper.is_write[s0:s1].transpose(0, 1),
        stepper.thr[s0:s1].transpose(0, 1), st.oom_killed,
        (st.data_node, st.leaf_node, st.mid_node, st.top_node),
        (stepper.tables.read, stepper.tables.write),
        [(tlb.tags, tlb.lru) for tlb in
         (st.l1_tlb, st.stlb, st.pde_pwc, st.pdpte_pwc)],
        (cyc.total, cyc.walk, cyc.stall, cyc.data_mem),
        (c.l1_hits, c.stlb_hits, c.walks, c.walk_mem_reads),
        (st.access_recent, st.written_recent),
        [tl_i[:, :, k].T for k in (7, 8, 4)],   # l1 hits, stlb hits, walks
        now0=stepper.start + s0, map_shift=mc.map_shift,
        radix_bits=mc.radix_bits, thp=mc.page_order > 0,
        costs=stepper.window_costs)
    tl_f[:, :, :4] = cum.sum(-1).transpose(0, 1)


class BlockedRunner:
    """``L`` runs of the time-blocked engine in progress (the reference's
    ``_build_blocked_body`` and the blocked half of its ``run`` and
    ``sweep_lanes``), one lane each; a single run is ``L = 1``.

    The host plan (:func:`plan_windows`), made from the lanes' union
    schedule, dispatches each window: a fast window is one
    :func:`fast_window_tile`; a full window replays its steps through a
    :class:`Stepper`, with the configured fault path; a hoist window runs
    its fast prefix, the scan tick, its fast suffix; a split window its
    fast prefix, the event span step by step, its fast suffix.  Only live
    rows run (the reference masks the others into exact no-ops), so the
    kernel is launched once per non-empty fast segment
    (:attr:`fast_segments`), for all lanes.  :meth:`advance` runs windows,
    as ``Stepper.advance`` runs steps; the timeline comes out in step
    order.  :attr:`host_s` sums the host's seconds in each kind of segment
    (fast, scan, steps): the time to issue its work, as the loop never
    waits on the device.  The arguments are :class:`Stepper`'s, and
    ``block`` the window size.
    """

    def __init__(self, mc: MachineConfig, ccs, pcs, traces, *,
                 block: int = DEFAULT_BLOCK, **kw):
        self.stepper = Stepper(mc, ccs, pcs, traces, **kw)
        stp = self.stepper
        S = stp.n_steps
        self.block = min(int(block), pow2ceil(S))
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
        stp.s = min(hi * self.block, stp.n_steps)
        stp.st.step.fill_(stp.start + stp.s)
        return self

    def results(self) -> "list[RunResult]":
        """The windows run so far, a :class:`RunResult` per lane."""
        return self.stepper.results()

    def result(self, lane: int = 0) -> RunResult:
        """Lane ``lane``'s windows run so far (host numpy)."""
        return self.stepper.result(lane)


def _normalize_blocked(budget: int, phase_b: str, group: Optional[int],
                       geom):
    """The reference's canonical compile-key components of a blocked
    geometry: without a full or split window no per-step body runs (the
    fault path and the allocator's group bound are dead), and without any
    window that can scan the candidate bound is dead too."""
    needs_step = geom is not None and (bool(geom[0]) or geom[2] is not None)
    needs_scan = needs_step or (geom is not None and geom[1] is not None)
    if not needs_step:
        phase_b, group = "batched", None
    if not needs_scan:
        budget = 0
    return budget, phase_b, group


class TieredMemSimulator:
    """Public facade: configure once, run traces under a policy bundle.

    Keeps the reference's signature and gate.  ``engine="blocked"`` (the
    default) is the time-blocked engine (:class:`BlockedRunner`);
    ``"per_step"`` is the step-at-a-time engine (:class:`Stepper`); a run
    is one lane of either (``core.sweep`` runs many).
    ``phase_b="batched"`` (default) is the conflict-aware vectorized fault
    path, ``"sequential"`` the per-thread loop it is tested against.  The
    per-step engine and the sequential path are differential oracles and
    need ``debug=True``, as in the reference.

    ``telemetry`` (optional :class:`repro_torch.obs.Telemetry`) records the
    reference's run counters (``sim.runs``, ``sim.windows_*`` or
    ``sim.steps``) and, when tracing, a ``sim.run`` span and one
    ``window.fast`` / ``window.event`` span per window, the run's time
    from its first window to its result on the host spread uniformly over
    the windows, as the reference spreads its compiled scan's.  Every
    hook is host-side and reads no device value: the results, and the
    device work, are the same with telemetry on or off.
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
                 telemetry=None,
                 device=None):
        check_engine(engine, phase_b, debug)
        self.mc, self.cc, self.pc = mc, cc, pc
        self.phase_b = phase_b
        self.engine = engine
        self.block = int(block)
        self.debug = bool(debug)
        self.telemetry = or_null(telemetry)
        self.device = resolve_device(device)

    def runner(self, trace: Trace, state: Optional[SimState] = None):
        """A run of ``trace`` from ``state`` (the empty machine by
        default; a resumed state may hold tensors or numpy arrays) on the
        configured engine: a :class:`BlockedRunner` (``advance`` by
        windows) or a :class:`Stepper` (``advance`` by steps)."""
        kw = dict(phase_b=self.phase_b, device=self.device, state=state)
        lanes = (self.mc, [self.cc], [self.pc], [trace])
        if self.engine == "blocked":
            return BlockedRunner(*lanes, block=self.block, **kw)
        return Stepper(*lanes, **kw)

    def run(self, trace: Trace, state: Optional[SimState] = None) -> RunResult:
        tel = self.telemetry
        run_t0 = tel.now()
        runner = self.runner(trace, state)
        if self.engine == "blocked":
            plan = runner.plan
            if tel.enabled:
                window_counters(tel, "sim", plan)
            dev_t0 = tel.now()
            res = runner.advance().result()
            if dev_t0 is not None:
                window_spans(tel, plan, dev_t0, tel.now())
        else:
            if tel.enabled:
                tel.counter("sim.steps").inc(trace.n_steps)
            res = runner.advance().result()
        if tel.enabled:
            tel.counter("sim.runs", engine=self.engine).inc()
            if run_t0 is not None:
                tel.add_span("sim.run", run_t0, tel.now(), cat="engine",
                             args={"steps": trace.n_steps,
                                   "engine": self.engine,
                                   "trace": trace.name})
        return res


def window_counters(tel, prefix: str, plan: WindowPlan) -> None:
    """The reference's window classification counters of ``plan``:
    ``<prefix>.windows_event`` (every window but the fast ones),
    ``_fast``, ``_hoist`` and ``_split``."""
    n_fast, _, n_hoist, n_split = plan.counts
    tel.counter(f"{prefix}.windows_event").inc(plan.n_windows - n_fast)
    tel.counter(f"{prefix}.windows_fast").inc(n_fast)
    tel.counter(f"{prefix}.windows_hoist").inc(n_hoist)
    tel.counter(f"{prefix}.windows_split").inc(n_split)


def window_spans(tel, plan: WindowPlan, t0: float, t1: float) -> None:
    """One ``window.fast`` / ``window.event`` span per window of ``plan``
    on the engine's track (tid 1), ``t0..t1`` (the time from the first
    window's start to the results on the host) spread uniformly over the
    windows, as the reference spreads its compiled scan's; the
    classification is the plan's (branch 0 is the fast window)."""
    w_dur = (t1 - t0) / max(plan.n_windows, 1)
    for i, k in enumerate(plan.kind):
        tel.add_span("window.event" if k else "window.fast",
                     t0 + i * w_dur, t0 + (i + 1) * w_dur, cat="engine",
                     tid=1, args={"window": i})


def check_engine(engine: str, phase_b: str, debug: bool) -> None:
    """The reference's gate: the per-step engine and the sequential fault
    path are oracle paths and need ``debug=True``."""
    if engine not in ("blocked", "per_step") or \
            phase_b not in ("batched", "sequential"):
        raise ValueError(f"unknown engine={engine!r} or phase_b={phase_b!r}")
    if (engine != "blocked" or phase_b != "batched") and not debug:
        raise ValueError(
            f"engine={engine!r} phase_b={phase_b!r} are reference "
            f"(oracle) paths; pass debug=True to run them")
