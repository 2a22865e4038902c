"""Simulator state: placement arrays, allocator, translation caches, metrics
(twin of the JAX package's ``core/state.py``).

The page-table radix tree is *implicit*: for mapping granule ``m`` the PT
pages touched by a walk are leaf ``m >> radix_bits``, mid
``m >> 2*radix_bits``, top ``m >> 3*radix_bits`` and root ``0``, so one
int32 "NUMA node or -1" array per level encodes the whole tree.

Every field is a tensor on one device, with the reference's dtypes (int32,
float32, bool) and shapes.  The engine holds ``L`` runs at once (a sweep's
lanes; a single run is ``L = 1``), so each field has a leading lane axis,
as the reference's vmapped sweep state; :meth:`SimState.lane` gives one
run with the field names, dtypes and shapes of the JAX state after
``jax.device_get``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import tlbs
from .config import MachineConfig
from ..device import resolve_device

I32 = torch.int32
F32 = torch.float32


@dataclasses.dataclass
class Counters:
    """Cumulative event counters (int32; exact at test scales)."""

    l1_hits: torch.Tensor
    stlb_hits: torch.Tensor
    walks: torch.Tensor                 # hardware page walks (both-TLB misses)
    walk_mem_reads: torch.Tensor        # PT-page memory reads issued by walks
    faults: torch.Tensor
    data_allocs: torch.Tensor           # i32[n_nodes]
    pt_allocs: torch.Tensor             # i32[n_nodes]
    slow_allocs: torch.Tensor
    data_migrations: torch.Tensor       # successful data-page migrations
    demotions: torch.Tensor
    l4_mig_success: torch.Tensor        # Table-5 "Successful migration"
    l4_mig_already_dest: torch.Tensor   # Table-5 "Already in destination"
    l4_mig_in_dram: torch.Tensor        # Table-5 "With in DRAM" (same-tier skip)
    l4_mig_sibling_guard: torch.Tensor  # Alg.1 line 18: a child is still in DRAM
    l4_mig_lock_skip: torch.Tensor      # Alg.1/§5.3: PMD try_lock failed
    oom_kills: torch.Tensor
    nomad_retries: torch.Tensor         # Nomad: promotions aborted by a write
    nomad_flip_demotions: torch.Tensor  # Nomad: demotions served by a shadow flip
    nomad_shadow_drops: torch.Tensor    # Nomad: shadows invalidated by a write


def zero_counters(n_nodes: int, device, lanes: int = 1) -> Counters:
    def z(shape=()):
        return torch.zeros((lanes, *shape), dtype=I32, device=device)
    fields = {f.name: z() for f in dataclasses.fields(Counters)}
    fields.update(data_allocs=z((n_nodes,)), pt_allocs=z((n_nodes,)))
    return Counters(**fields)


@dataclasses.dataclass
class Cycles:
    """Cumulative cycle accounting (float32)."""

    total: torch.Tensor      # f32[T] per-thread total cycles
    walk: torch.Tensor       # f32[T] cycles the PMH spent walking
    stall: torch.Tensor      # f32[T] memory-stall cycles (walk + exposed data)
    data_mem: torch.Tensor   # f32[T] raw data-access memory cycles
    fault: torch.Tensor      # f32[T] fault-handler cycles (incl. alloc, zero)
    migration: torch.Tensor  # f32[]  background migration work (all threads)


def zero_cycles(n_threads: int, device, lanes: int = 1) -> Cycles:
    def z(shape):
        return torch.zeros((lanes, *shape), dtype=F32, device=device)
    return Cycles(total=z((n_threads,)), walk=z((n_threads,)),
                  stall=z((n_threads,)), data_mem=z((n_threads,)),
                  fault=z((n_threads,)), migration=z(()))


@dataclasses.dataclass
class SimState:
    # --- placement: NUMA node per page, -1 = unallocated -------------------
    data_node: torch.Tensor           # i32[n_map]
    leaf_node: torch.Tensor           # i32[n_leaf]   PTE pages (PMD under THP)
    mid_node: torch.Tensor            # i32[n_mid]
    top_node: torch.Tensor            # i32[n_top]
    root_node: torch.Tensor           # i32[1]
    leaf_dram_children: torch.Tensor  # i32[n_leaf]  #mapped children on DRAM
    shadow_node: torch.Tensor         # i32[n_map]   Nomad shadow copy (-1)

    # --- allocator ----------------------------------------------------------
    node_free: torch.Tensor           # i32[n_nodes]
    node_reclaimable: torch.Tensor    # i32[n_nodes] page-cache style reserve
    interleave_ptr: torch.Tensor      # i32[] round-robin cursor
    oom_killed: torch.Tensor          # bool[] OOM handler fired
    oom_step: torch.Tensor            # i32[] step at which it fired (-1)

    # --- hotness (AutoNUMA input) -------------------------------------------
    access_recent: torch.Tensor       # i32[n_map], periodically halved
    written_recent: torch.Tensor      # i32[n_map], writes since the last scan

    # --- translation caches -------------------------------------------------
    l1_tlb: tlbs.TlbArray
    stlb: tlbs.TlbArray
    pde_pwc: tlbs.TlbArray
    pdpte_pwc: tlbs.TlbArray

    # --- accounting ----------------------------------------------------------
    cycles: Cycles
    counters: Counters
    step: torch.Tensor                # i32[] global step (LRU timestamp)

    def to_numpy(self) -> "SimState":
        """The same structure with every field a numpy array on the host."""
        return _map_fields(self, lambda t: t.detach().cpu().numpy())

    def lane(self, i: int) -> "SimState":
        """Run ``i`` of a host copy (:meth:`to_numpy`): the field names,
        dtypes and shapes of the JAX state after ``jax.device_get``."""
        return _map_fields(self, lambda a: a[i, ...])

    def to(self, device) -> "SimState":
        """A copy on ``device``; the fields may be tensors or numpy arrays
        (a :attr:`RunResult.final_state`), so a run can resume from one."""
        dev = torch.device(device)
        return _map_fields(self, lambda t: torch.as_tensor(
            np.asarray(t) if not torch.is_tensor(t) else t).to(dev).clone())

    def with_lane_axis(self) -> "SimState":
        """One run's state (a field per run, as :meth:`lane` gives it) as
        ``L = 1``: a lane axis in front of every field (views)."""
        return _map_fields(self, lambda t: t[None])


def _map_fields(obj, fn):
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{f.name: _map_fields(getattr(obj, f.name), fn)
                            for f in dataclasses.fields(obj)})
    return fn(obj)


def init_state(mc: MachineConfig, device=None, lanes: int = 1) -> SimState:
    """The empty machine on ``device`` (``None``: the CUDA device), for
    ``lanes`` runs: every field has a leading lane axis of that length."""
    dev = resolve_device(device)
    L = int(lanes)
    cap = torch.tensor(mc.node_capacity(), dtype=I32, device=dev)
    # f32 product truncated to int32, as the reference rounds it
    reclaim = (cap.to(F32) * mc.reclaimable_frac).to(I32)

    def full(shape, value, dtype=I32):
        return torch.full((L, *shape), value, dtype=dtype, device=dev)

    T = mc.n_threads
    return SimState(
        data_node=full((mc.n_map,), -1),
        leaf_node=full((mc.n_leaf_pages,), -1),
        mid_node=full((mc.n_mid_pages,), -1),
        top_node=full((mc.n_top_pages,), -1),
        root_node=full((1,), -1),
        leaf_dram_children=full((mc.n_leaf_pages,), 0),
        shadow_node=full((mc.n_map,), -1),
        node_free=(cap - reclaim).repeat(L, 1),
        node_reclaimable=reclaim.repeat(L, 1),
        interleave_ptr=full((), 0),
        oom_killed=full((), False, torch.bool),
        oom_step=full((), -1),
        access_recent=full((mc.n_map,), 0),
        written_recent=full((mc.n_map,), 0),
        l1_tlb=tlbs.make_tlb(T, mc.l1_tlb_sets, mc.l1_tlb_ways, dev, (L,)),
        stlb=tlbs.make_tlb(T, mc.stlb_sets, mc.stlb_ways, dev, (L,)),
        pde_pwc=tlbs.make_tlb(T, 1, mc.pde_pwc_entries, dev, (L,)),
        pdpte_pwc=tlbs.make_tlb(T, 1, mc.pdpte_pwc_entries, dev, (L,)),
        cycles=zero_cycles(T, dev, L),
        counters=zero_counters(mc.n_nodes, dev, L),
        step=full((), 0),
    )


def is_dram(node: torch.Tensor) -> torch.Tensor:
    """True for DRAM nodes: tier 0 is always nodes (0, 1)."""
    return (node >= 0) & (node < 2)


def same_tier(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return is_dram(a) == is_dram(b)
