"""Machine / cost / policy configuration for the Radiant tiered-memory simulator
(twin of the JAX package's ``core/config.py``).

Plain frozen dataclasses: policy fields hold Python ints and bools, and no
field is registered with any tracing framework.

The simulated machine mirrors the paper's Table 1: a 2-socket box with two
DRAM-backed NUMA nodes (0, 1) and two NVMM (Optane)-backed no-CPU NUMA nodes
(2, 3).  Capacities are expressed in 4 KiB pages and scaled down from the
paper's 384 GB DRAM / 1.6 TB Optane so that whole-workload simulations run in
seconds on CPU while preserving the ratios that drive the paper's results
(DRAM : total ~= 19%, workload RSS > DRAM, NVMM read latency = 3x DRAM).

The machine generalizes to N tiers (``tier_pages_per_node``): a 2-socket box
always has two NUMA nodes per tier, numbered tier-major — tier 0 (DRAM) is
nodes 0/1, tier 1 the next pair, and so on down to the slowest tier.  The
2-tier DRAM/NVMM default is the degenerate case, and an N-tier machine whose
middle tiers have zero capacity reproduces the 2-tier machine bit-for-bit
(``tests/test_ntier.py``).  Middle tiers use the ``cxl_read``/``cxl_write``
latencies (CXL-attached expansion memory); tier 0 uses the DRAM latencies and
the slowest tier the NVMM ones.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


N_NODES = 4
DRAM_NODES = (0, 1)
NVMM_NODES = (2, 3)
NODES_PER_TIER = 2            # 2-socket box: one node per socket per tier

# Policies are integer codes, the JAX package's.  The data-policy and
# PT-policy namespaces are disjoint so an accidental cross-comparison can
# never be true.

# Data-page placement policies (paper section 2.3 / 6.1).
FIRST_TOUCH = 0
INTERLEAVE = 1

# Page-table placement policies (paper sections 3.5 / 4.2).
PT_FOLLOW_DATA = 10  # Linux default: same policy as data pages
PT_BIND_ALL = 11     # LKML patch [36]: whole page table in DRAM
PT_BIND_HIGH = 12    # Radiant BHi: L1-L3 in DRAM, L4 follows data

# Migration policy families (which algorithm the periodic balancing scan
# runs; ``PolicyConfig.autonuma`` switches the scan itself on/off):
MIG_AUTONUMA = 20  # Linux AutoNUMA: hint-fault promotion, optional exchange
MIG_TPP = 21       # TPP (CXL tiered memory): active/inactive LRU split,
#                    demotion to the next-slower tier ahead of reclaim
MIG_NOMAD = 22     # Nomad: transactional page migration (abort + retry on a
#                    concurrent write) with non-exclusive shadow copies

# Legacy string spellings still accepted by PolicyConfig and kept for
# display purposes.
DATA_POLICY_NAMES = {FIRST_TOUCH: "first_touch", INTERLEAVE: "interleave"}
PT_POLICY_NAMES = {PT_FOLLOW_DATA: "follow_data", PT_BIND_ALL: "bind_all",
                   PT_BIND_HIGH: "bind_high"}
MIG_POLICY_NAMES = {MIG_AUTONUMA: "autonuma", MIG_TPP: "tpp",
                    MIG_NOMAD: "nomad"}
_POLICY_CODES = {name: code
                 for names in (DATA_POLICY_NAMES, PT_POLICY_NAMES,
                               MIG_POLICY_NAMES)
                 for code, name in names.items()}


@dataclasses.dataclass(frozen=True)
class MachineConfig:
    """Physical machine shape (scaled-down paper Table 1)."""

    n_threads: int = 32                # simulated CPUs (paper: 96)
    # Pages per node.  Defaults: DRAM 2*49152 = 96 Ki pages, NVMM 2*204800.
    dram_pages_per_node: int = 49152
    nvmm_pages_per_node: int = 204800
    # N-tier generalization: pages per node of each tier, fastest first
    # (DRAM, CXL..., NVMM).  ``None`` means the classic 2-tier machine
    # built from the two fields above.  Every tier contributes two NUMA
    # nodes (one per socket), numbered tier-major: tier t owns nodes
    # (2t, 2t+1).  A middle tier may have zero capacity — its nodes are
    # never allocatable and the machine behaves bit-identically to one
    # without that tier (guarded by tests/test_ntier.py).
    tier_pages_per_node: Optional[Tuple[int, ...]] = None
    va_pages: int = 1 << 18            # virtual address space, 4 KiB pages
    page_order: int = 0                # 0 => base pages; radix_bits => THP

    # log2 fan-out per page-table level.  Real x86-64 is 9 (512-ary).  The
    # scaled-down benchmark machine uses 6 so that upper-level pages number
    # in the dozens (as they do for terabyte footprints) instead of 1-4 —
    # otherwise the paper's startup/interleave effects, which hinge on *mid-
    # level* page placement, cannot exist at simulation scale.  Structural
    # claims (PT size ratios, 0.18%) are asserted separately at radix 9.
    radix_bits: int = 9

    # TLB hierarchy (per simulated thread).
    l1_tlb_sets: int = 16
    l1_tlb_ways: int = 4
    stlb_sets: int = 128
    stlb_ways: int = 12

    # Page-walk caches (per thread, fully associative).
    pde_pwc_entries: int = 32          # caches L3->L4 pointers (skip L1..L3)
    pdpte_pwc_entries: int = 8         # caches L2->L3 pointers (skip L1..L2)

    # Allocator watermarks, as fractions of a node's capacity.
    low_watermark: float = 0.02        # below this the buddy slow path runs
    reclaimable_frac: float = 0.01     # page-cache style reclaimable reserve

    # PMD try-lock conflict domain, in leaf-page-id right-shift.  On real
    # hardware one PMD page (= lock) covers 512 leaf pages (shift 9), and a
    # 1 TB workload has ~1024 lock domains; the scaled-down simulation has
    # only ~2-8 mid-level pages, which would serialize Algorithm-1 batches
    # far beyond reality.  shift=1 (one lock per 2 leaf pages) restores the
    # real system's conflict *ratio* at simulation scale; set 9 to model the
    # literal lock granularity.
    lock_domain_shift: int = 1

    def __post_init__(self):
        if self.tier_pages_per_node is not None:
            tiers = tuple(int(c) for c in self.tier_pages_per_node)
            if len(tiers) < 2:
                raise ValueError(
                    f"tier_pages_per_node needs >= 2 tiers, got {tiers}")
            if tiers[0] <= 0 or tiers[-1] <= 0:
                raise ValueError(
                    "the fastest and slowest tiers must have capacity; "
                    f"got {tiers}")
            object.__setattr__(self, "tier_pages_per_node", tiers)

    @property
    def tier_capacities(self) -> Tuple[int, ...]:
        """Pages per node of each tier, fastest (DRAM) first."""
        if self.tier_pages_per_node is not None:
            return self.tier_pages_per_node
        return (self.dram_pages_per_node, self.nvmm_pages_per_node)

    @property
    def n_tiers(self) -> int:
        return len(self.tier_capacities)

    @property
    def n_nodes(self) -> int:
        return NODES_PER_TIER * self.n_tiers

    @property
    def tier_of_node(self) -> Tuple[int, ...]:
        """Tier index per NUMA node (node 2t and 2t+1 belong to tier t)."""
        return tuple(t for t in range(self.n_tiers)
                     for _ in range(NODES_PER_TIER))

    @property
    def alloc_nodes(self) -> Tuple[int, ...]:
        """Nodes with nonzero capacity, ascending — the interleave
        rotation runs over these, so zero-capacity middle tiers never
        perturb the round-robin order."""
        caps = self.tier_capacities
        return tuple(n for n in range(self.n_nodes)
                     if caps[n // NODES_PER_TIER] > 0)

    def node_capacity(self) -> Tuple[int, ...]:
        return tuple(self.tier_capacities[t] for t in self.tier_of_node)

    @property
    def map_shift(self) -> int:
        """log2(#base pages per mapping granule): 0 normally, radix for THP."""
        return self.page_order

    @property
    def n_map(self) -> int:
        """Number of mapping granules (== leaf entries) in the VA space."""
        return max(self.va_pages >> self.page_order, 1)

    @property
    def n_leaf_pages(self) -> int:
        """Number of leaf page-table pages (PTE pages; PMD pages for THP)."""
        return max(self.n_map >> self.radix_bits, 1)

    @property
    def n_mid_pages(self) -> int:
        return max(self.n_map >> (2 * self.radix_bits), 1)

    @property
    def n_top_pages(self) -> int:
        return max(self.n_map >> (3 * self.radix_bits), 1)

    @property
    def walk_levels(self) -> int:
        """Memory accesses in a full hardware walk (4 for 4K, 3 for THP)."""
        return 4 if self.page_order == 0 else 3


@dataclasses.dataclass(frozen=True)
class CostConfig:
    """Latency model in CPU cycles (~3 GHz).

    The only paper-anchored constant that matters for the headline results is
    the 3x NVMM:DRAM read ratio ([38], paper section 1); write latency on
    Optane is worse and modeled at 4x.  Everything else is standard x86
    folklore and only shifts absolute numbers, not the policy deltas.
    """

    dram_read: int = 250
    nvmm_read: int = 750               # 3x DRAM (paper observation 2)
    dram_write: int = 250
    nvmm_write: int = 1000             # 4x DRAM
    # Middle (CXL-attached) tiers on an N-tier machine; unused on the
    # classic 2-tier box.  ~1.8x DRAM read matches reported CXL adder.
    cxl_read: int = 450
    cxl_write: int = 500
    llc_hit: int = 40
    stlb_hit: int = 10
    cpu_work: int = 60                 # non-memory work per access (IPC proxy)

    fault_base: int = 600              # trap + handler entry/exit
    alloc_fast: int = 150              # buddy fast path
    alloc_slow: int = 4000             # watermark slow path / reclaim attempt
    zero_lines: int = 16               # charged lines when zeroing a page
    migrate_fixed: int = 1200          # rmap walk, unmap, bookkeeping
    copy_lines: int = 16               # charged lines for the 4 KiB copy
    tlb_flush: int = 450               # local invalidation + IPI shootdown
    oom_scan: int = 200000             # direct reclaim scan before OOM kill

    # Fraction of data-access latency NOT hidden by out-of-order execution.
    # Page walks stall the pipeline fully (the PMH serializes translations).
    data_stall_frac: float = 0.6

    # The simulated access stream subsamples the real one by ~10^3 (a run
    # simulates ~10^6 accesses standing in for ~10^9+), while the AutoNUMA
    # scan cadence is kept realistic relative to DRAM capacity.  Background
    # migration-daemon cycles charged to application threads are therefore
    # scaled by this factor; the full cost is still reported separately as
    # ``migration_cycles``.  Calibrated so migration overhead lands at the
    # paper's observed ~1-5% of total cycles.
    mig_cost_scale: float = 0.05

    # Probability that the leaf PTE *cache line* is already in the LLC
    # (PT entries travel the normal cache hierarchy; 8 entries/line).
    leaf_llc_hit: float = 0.30
    # Same for mid/top-level entries on a PWC miss.  Upper-level pages are
    # fewer but PWC misses imply poor locality, so this stays moderate.
    upper_llc_hit: float = 0.35


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Which paper technique is active (Table 3 conventions).

    ``autonuma_period`` sets the host-side scan schedule and
    ``autonuma_budget`` the size of the scan's candidate lists.
    """

    data_policy: int = FIRST_TOUCH   # FIRST_TOUCH | INTERLEAVE
    pt_policy: int = PT_FOLLOW_DATA  # PT_FOLLOW_DATA | PT_BIND_ALL | PT_BIND_HIGH
    mig: bool = False     # Radiant "Mig": Algorithm-1 L4 migration
    autonuma: bool = True  # data-page balancing (migration source)

    # AutoNUMA-ish scanner.  Threshold 1 = migrate-on-touch, matching NUMA
    # hint-fault behavior; the budget bounds per-scan migrate_pages batches.
    autonuma_period: int = 512         # steps between scans
    autonuma_budget: int = 256         # max data-page promotions per scan
    autonuma_threshold: int = 1   # min recent accesses to be "hot"
    autonuma_exchange: bool = True  # demote cold DRAM pages

    # Which migration algorithm the periodic scan runs (MIG_AUTONUMA |
    # MIG_TPP | MIG_NOMAD).  TPP splits pages into active/inactive by the
    # recent-access count and demotes inactive pages to the *next-slower*
    # tier ahead of reclaim pressure; Nomad migrates transactionally —
    # a promotion aborts (and retries next scan) if the page saw a
    # concurrent write, and committed promotions keep a non-exclusive
    # shadow copy on the source tier that a later demotion can flip to
    # for free.
    mig_policy: int = MIG_AUTONUMA
    # TPP only: extra fraction of tier-0 capacity the demotion path keeps
    # free beyond the low watermark (the "demotion watermark").
    tpp_demote_wm: float = 0.0

    def __post_init__(self):
        # Normalize legacy string spellings and validate the codes.
        for f, valid in (("data_policy", DATA_POLICY_NAMES),
                         ("pt_policy", PT_POLICY_NAMES),
                         ("mig_policy", MIG_POLICY_NAMES)):
            v = getattr(self, f)
            if isinstance(v, str):
                if v not in _POLICY_CODES or _POLICY_CODES[v] not in valid:
                    raise ValueError(f"unknown {f} {v!r}")
                object.__setattr__(self, f, _POLICY_CODES[v])
            elif isinstance(v, int) and v not in valid:
                raise ValueError(
                    f"unknown {f} code {v}; valid: {dict(valid)}")

    def label(self) -> str:
        bits = []
        bits.append("interleave" if self.data_policy == INTERLEAVE else "first-touch")
        if self.pt_policy == PT_BIND_HIGH:
            bits.append("BHi")
        elif self.pt_policy == PT_BIND_ALL:
            bits.append("BindAll")
        if self.mig:
            bits.append("Mig")
        if not self.autonuma:
            bits.append("noAutoNUMA")
        if self.mig_policy == MIG_TPP:
            bits.append("TPP")
        elif self.mig_policy == MIG_NOMAD:
            bits.append("Nomad")
        return "+".join(bits)


def benchmark_machine(thp: bool = False, n_threads: int = 32) -> MachineConfig:
    """The scaled-down paper machine used by the benchmark suite.

    radix 6 (64-ary tables) so mid/top-level pages number in the dozens, as
    they do for the paper's terabyte footprints; DRAM : footprint ratio and
    NVMM latency ratios match Table 1.  ``thp`` switches to huge-page
    mapping granules (3-level walks, paper section 6.6).
    """
    return MachineConfig(n_threads=n_threads, radix_bits=6,
                         va_pages=1 << 18,
                         dram_pages_per_node=49152,
                         nvmm_pages_per_node=204800,
                         page_order=6 if thp else 0)


# Preset policy bundles matching the paper's Table 3 conventions.
def linux_default(data_policy: int = FIRST_TOUCH, autonuma: bool = True) -> PolicyConfig:
    return PolicyConfig(data_policy=data_policy, pt_policy=PT_FOLLOW_DATA,
                        mig=False, autonuma=autonuma)


def bind_all(data_policy: int = FIRST_TOUCH, autonuma: bool = True) -> PolicyConfig:
    return PolicyConfig(data_policy=data_policy, pt_policy=PT_BIND_ALL,
                        mig=False, autonuma=autonuma)


def bhi(data_policy: int = FIRST_TOUCH, autonuma: bool = True) -> PolicyConfig:
    return PolicyConfig(data_policy=data_policy, pt_policy=PT_BIND_HIGH,
                        mig=False, autonuma=autonuma)


def bhi_mig(data_policy: int = FIRST_TOUCH, autonuma: bool = True) -> PolicyConfig:
    return PolicyConfig(data_policy=data_policy, pt_policy=PT_BIND_HIGH,
                        mig=True, autonuma=autonuma)


def tpp(data_policy: int = FIRST_TOUCH, demote_wm: float = 0.02,
        **kw) -> PolicyConfig:
    """TPP-style tiering: active/inactive split + headroom demotion."""
    return PolicyConfig(data_policy=data_policy, pt_policy=PT_FOLLOW_DATA,
                        mig=False, autonuma=True, mig_policy=MIG_TPP,
                        tpp_demote_wm=demote_wm, **kw)


def nomad(data_policy: int = FIRST_TOUCH, **kw) -> PolicyConfig:
    """Nomad-style transactional migration with shadow copies."""
    return PolicyConfig(data_policy=data_policy, pt_policy=PT_FOLLOW_DATA,
                        mig=False, autonuma=True, mig_policy=MIG_NOMAD, **kw)


def cxl_machine(n_threads: int = 32, cxl_pages_per_node: int = 98304,
                thp: bool = False) -> MachineConfig:
    """3-tier DRAM + CXL + NVMM benchmark machine (tier-major nodes 0-5)."""
    return MachineConfig(n_threads=n_threads, radix_bits=6,
                         va_pages=1 << 18,
                         tier_pages_per_node=(49152, cxl_pages_per_node,
                                              204800),
                         page_order=6 if thp else 0)
