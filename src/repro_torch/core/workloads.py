"""Access-trace generators for the paper's workload suite (Table 2), a copy
of the JAX package's ``core/workloads.py`` (numpy only): the same arguments
give the same traces and the same :func:`trace_digest`.

Each generator emits a :class:`~repro_torch.core.sim.Trace` — a ``[steps, threads]``
array of 4-KiB virtual page numbers plus phase metadata.  Footprints are
scaled down from the paper's 600 GB–1 TB (Table 2) but keep the ratios that
drive the results: RSS ≈ 2× DRAM capacity, hot sets ≫ TLB reach, page-level
access patterns matching each application:

  kv_store   Memcached/Redis: sequential heap growth during populate with
             interleaved reads of the growing hash table, then YCSB-zipfian
             (theta=0.99) reads over value pages scattered by a hash
             permutation.
  btree      root/inner/leaf traversal: one lookup = 4 dependent accesses
             through exponentially growing regions (index lookups, [2]).
  hashjoin   build (populate) + uniform random probes ([3]).
  xsbench    uniform random reads of large cross-section tables + a small
             hot index region ([34]).
  bfs        frontier traversal: sequential neighbor runs with power-law
             jump targets (Ligra rMAT, [33]).

All randomness is drawn from a seeded ``numpy.random.Generator`` — traces
are plain input data, shared by the JAX package, its oracle and the port.

Traces are also *spec-addressable*: a :class:`TraceSpec` names a generator,
its parameters and an optional idle-pad length, builds deterministically
for a given machine, and hashes stably — the simulation service
(the JAX package's ``service``) keys admission buckets and its result cache on these
digests, so two queries naming the same workload share one generation
pass, one fault-schedule pass, and one cache line.  :func:`trace_digest`
gives the matching content hash for ad-hoc ``Trace`` objects.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Optional, Tuple

import numpy as np

from .config import MachineConfig
from .sim import Trace, pad_trace




def _zipf_cdf(n: int, theta: float) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = 1.0 / ranks ** theta
    return np.cumsum(w) / np.sum(w)


def _zipf_sample(rng, cdf: np.ndarray, size) -> np.ndarray:
    u = rng.random(size)
    return np.searchsorted(cdf, u).astype(np.int32)


def _populate_rows(rng, footprint: int, T: int, read_mix: float,
                   page_perm: Optional[np.ndarray] = None):
    """Sequential heap growth: thread t faults pages [t*S, (t+1)*S) in order,
    with ``read_mix`` of its steps replaced by reads of already-touched pages
    (hash-table updates during inserts).  Returns (va, is_write)."""
    shard = footprint // T
    steps = shard + int(shard * read_mix)
    va = np.full((steps, T), -1, np.int32)
    wr = np.zeros((steps, T), bool)
    for t in range(T):
        base = t * shard
        seq = np.arange(shard, dtype=np.int32) + base
        n_reads = steps - shard
        read_pos = rng.choice(steps, size=n_reads, replace=False) if n_reads else \
            np.empty((0,), np.int64)
        is_read = np.zeros(steps, bool)
        is_read[read_pos] = True
        col = np.empty(steps, np.int32)
        col[~is_read] = seq
        # reads target a uniformly random already-populated page of this shard
        prog = np.maximum(np.cumsum(~is_read) - 1, 0)
        col[is_read] = base + (rng.random(steps) * np.maximum(prog, 1)
                               ).astype(np.int32)[is_read] % shard
        va[:, t] = col
        wr[:, t] = ~is_read
    if page_perm is not None:
        va = page_perm[va]
    return va, wr


def _finish(mc: MachineConfig, va, wr, name, llc_pop, llc_run,
            populate_steps, seg_of_map=None) -> Trace:
    steps = va.shape[0]
    llc = np.full((steps,), llc_run, np.float32)
    llc[:populate_steps] = llc_pop
    if seg_of_map is None:
        seg_of_map = np.zeros((mc.n_map,), np.int32)
    return Trace(va=va.astype(np.int32), is_write=wr,
                 free_seg=np.full((steps,), -1, np.int32),
                 llc=llc, seg_of_map=seg_of_map, name=name,
                 populate_steps=populate_steps)


def kv_store(mc: MachineConfig, footprint: int, run_steps: int,
             seed: int = 0, theta: float = 0.99, write_frac: float = 0.0,
             name: str = "kv_store") -> Trace:
    """Memcached/Redis under YCSB: populate then zipfian reads."""
    rng = np.random.default_rng(seed)
    T = mc.n_threads
    footprint = min(footprint, mc.va_pages) // T * T
    # hash scatter: hot items land on random pages across the heap
    perm = rng.permutation(footprint).astype(np.int32)
    pva, pwr = _populate_rows(rng, footprint, T, read_mix=0.5)
    cdf = _zipf_cdf(footprint, theta)
    rva = perm[_zipf_sample(rng, cdf, (run_steps, T))]
    rwr = rng.random((run_steps, T)) < write_frac
    va = np.concatenate([pva, rva])
    wr = np.concatenate([pwr, rwr])
    return _finish(mc, va, wr, name, 0.45, 0.50, pva.shape[0])


def hashjoin(mc: MachineConfig, footprint: int, run_steps: int,
             seed: int = 1, name: str = "hashjoin") -> Trace:
    rng = np.random.default_rng(seed)
    T = mc.n_threads
    footprint = min(footprint, mc.va_pages) // T * T
    pva, pwr = _populate_rows(rng, footprint, T, read_mix=0.25)
    rva = rng.integers(0, footprint, (run_steps, T), dtype=np.int32)
    rwr = np.zeros((run_steps, T), bool)
    va = np.concatenate([pva, rva])
    wr = np.concatenate([pwr, rwr])
    return _finish(mc, va, wr, name, 0.35, 0.15, pva.shape[0])


def xsbench(mc: MachineConfig, footprint: int, run_steps: int,
            seed: int = 2, name: str = "xsbench") -> Trace:
    rng = np.random.default_rng(seed)
    T = mc.n_threads
    footprint = min(footprint, mc.va_pages) // T * T
    pva, pwr = _populate_rows(rng, footprint, T, read_mix=0.1)
    hot = max(footprint // 64, 1)           # unionized-energy-grid index
    r = rng.random((run_steps, T))
    idx_hot = rng.integers(0, hot, (run_steps, T), dtype=np.int32)
    idx_cold = rng.integers(hot, footprint, (run_steps, T), dtype=np.int32)
    rva = np.where(r < 0.2, idx_hot, idx_cold).astype(np.int32)
    va = np.concatenate([pva, rva])
    wr = np.concatenate([pwr, np.zeros((run_steps, T), bool)])
    return _finish(mc, va, wr, name, 0.30, 0.10, pva.shape[0])


def btree(mc: MachineConfig, footprint: int, run_steps: int,
          seed: int = 3, name: str = "btree") -> Trace:
    """Index lookups: each lookup walks root -> inner -> inner -> leaf
    regions (region sizes grow ~64x per level, mirroring node fanout)."""
    rng = np.random.default_rng(seed)
    T = mc.n_threads
    footprint = min(footprint, mc.va_pages) // T * T
    pva, pwr = _populate_rows(rng, footprint, T, read_mix=0.0)
    r0 = max(footprint // 32768, 1)
    r1 = max(footprint // 512, 1)
    r2 = max(footprint // 16, 1)
    lookups = run_steps // 4
    lv0 = rng.integers(0, r0, (lookups, T), dtype=np.int32)
    lv1 = r0 + rng.integers(0, r1, (lookups, T), dtype=np.int32)
    lv2 = r0 + r1 + rng.integers(0, r2, (lookups, T), dtype=np.int32)
    lv3 = rng.integers(r0 + r1 + r2, footprint, (lookups, T), dtype=np.int32)
    rva = np.stack([lv0, lv1, lv2, lv3], axis=1).reshape(lookups * 4, T)
    va = np.concatenate([pva, rva])
    wr = np.concatenate([pwr, np.zeros((rva.shape[0], T), bool)])
    return _finish(mc, va, wr, name, 0.40, 0.35, pva.shape[0])


def bfs(mc: MachineConfig, footprint: int, run_steps: int,
        seed: int = 4, run_len: int = 8, name: str = "bfs") -> Trace:
    """Graph traversal: sequential neighbor-list runs with power-law jumps."""
    rng = np.random.default_rng(seed)
    T = mc.n_threads
    footprint = min(footprint, mc.va_pages) // T * T
    pva, pwr = _populate_rows(rng, footprint, T, read_mix=0.0)
    n_jumps = run_steps // run_len + 1
    cdf = _zipf_cdf(footprint, 0.6)
    starts = _zipf_sample(rng, cdf, (n_jumps, T))
    offs = np.arange(run_len, dtype=np.int32)[None, :, None]
    rva = ((starts[:, None, :] + offs) % footprint).reshape(-1, T)[:run_steps]
    va = np.concatenate([pva, rva.astype(np.int32)])
    wr = np.concatenate([pwr, np.zeros((rva.shape[0], T), bool)])
    return _finish(mc, va, wr, name, 0.35, 0.25, pva.shape[0])


ALL_WORKLOADS = {
    "memcached": lambda mc, fp, rs, seed=0, **kw: kv_store(
        mc, fp, rs, seed=seed, name="memcached", **kw),
    "redis": lambda mc, fp, rs, seed=10, **kw: kv_store(
        mc, fp, rs, seed=seed, name="redis", **kw),
    "btree": btree,
    "hashjoin": hashjoin,
    "xsbench": xsbench,
    "bfs": bfs,
}


def trace_digest(tr: Trace) -> str:
    """Stable content hash of a trace (name excluded — two differently
    labelled but identical traces are the same simulation input).

    Memoized on the (immutable-by-convention) Trace object, so a burst of
    queries sharing one trace hashes its arrays once, not once per query.
    """
    cached = getattr(tr, "_content_digest", None)
    if cached is not None:
        return cached
    h = hashlib.blake2b(digest_size=16)
    for a in (np.asarray(tr.va, np.int32), np.asarray(tr.is_write, bool),
              np.asarray(tr.free_seg, np.int32),
              np.asarray(tr.llc, np.float32),
              np.asarray(tr.seg_of_map, np.int32)):
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a))
    h.update(str(int(tr.populate_steps)).encode())
    digest = h.hexdigest()
    object.__setattr__(tr, "_content_digest", digest)   # frozen dataclass
    return digest


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Addressable recipe for a workload trace.

    ``build(mc)`` is deterministic, so a spec (plus the machine) fully
    identifies its trace without materializing it — service queries ship
    specs, brokers build each distinct spec once (LRU-memoized here) and
    key caches on ``digest(mc)``.

    ``workload`` names an ``ALL_WORKLOADS`` generator; ``kwargs`` carries
    extra generator keywords as a sorted tuple of pairs (hashable);
    ``pad_to`` idle-pads the built trace (0 = natural length) so specs can
    land in a shared shape bucket at build time.
    """

    workload: str
    footprint: int
    run_steps: int
    seed: Optional[int] = None          # generator default when None
    pad_to: int = 0
    kwargs: Tuple[Tuple[str, object], ...] = ()

    def __post_init__(self):
        if self.workload not in ALL_WORKLOADS:
            raise ValueError(f"unknown workload {self.workload!r}; known: "
                             f"{sorted(ALL_WORKLOADS)}")
        object.__setattr__(self, "kwargs", tuple(sorted(self.kwargs)))

    def build(self, mc: MachineConfig) -> Trace:
        key = (self, mc)
        hit = _SPEC_CACHE.get(key)
        if hit is not None:
            _SPEC_CACHE.move_to_end(key)
            return hit
        kw = dict(self.kwargs)
        if self.seed is not None:
            kw["seed"] = self.seed
        tr = ALL_WORKLOADS[self.workload](mc, self.footprint,
                                          self.run_steps, **kw)
        if self.pad_to:
            tr = pad_trace(tr, self.pad_to)
        _SPEC_CACHE[key] = tr
        while len(_SPEC_CACHE) > _SPEC_CACHE_MAX:
            _SPEC_CACHE.popitem(last=False)
        return tr

    def digest(self, mc: MachineConfig) -> str:
        """Cache key without materializing: hash of the recipe + machine
        shape knobs the generators read."""
        h = hashlib.blake2b(digest_size=16)
        h.update(repr((self.workload, self.footprint, self.run_steps,
                       self.seed, self.pad_to, self.kwargs,
                       mc)).encode())
        return h.hexdigest()


# Generated traces are FOOTPRINT-scale arrays; keep a bounded working set
# (same LRU discipline as sim._SCHED_CACHE / benchmarks.common).
_SPEC_CACHE: "collections.OrderedDict[tuple, Trace]" = \
    collections.OrderedDict()
_SPEC_CACHE_MAX = 32


def multi_tenant(mc: MachineConfig, bench: str, bench_footprint: int,
                 run_steps: int, seed: int = 7) -> Trace:
    """The paper's section 6.3 scenario.

    Segment 0 fills DRAM (fill apps), the benchmark app (segment 1) then
    populates — landing on NVMM — and runs; the fill apps exit mid-run,
    freeing DRAM and letting AutoNUMA promote the benchmark's hot data.
    """
    rng = np.random.default_rng(seed)
    T = mc.n_threads
    dram_total = 2 * mc.dram_pages_per_node
    leaf_granules = 1 << mc.radix_bits   # segment alignment: leaf boundary
    fill_pages = int(dram_total * 0.95) // leaf_granules * leaf_granules
    fill_pages = fill_pages // T * T
    bench_pages = min(bench_footprint, mc.va_pages - fill_pages)
    bench_pages = bench_pages // T * T

    seg_of_map = np.zeros((mc.n_map,), np.int32)
    seg_of_map[fill_pages:] = 1

    # phase 1: fill apps populate + touch their pages (keeps them "hot")
    fva, fwr = _populate_rows(rng, fill_pages, T, read_mix=0.3)
    # phase 2: benchmark populates its own (NVMM-bound) segment
    gen = ALL_WORKLOADS[bench]
    btr = gen(mc, bench_pages, run_steps)
    bva = np.where(btr.va >= 0, btr.va + fill_pages, -1).astype(np.int32)
    # fill apps exit once the benchmark enters its run phase
    exit_at = fva.shape[0] + btr.populate_steps + run_steps // 8

    va = np.concatenate([fva, bva])
    wr = np.concatenate([fwr, btr.is_write])
    steps = va.shape[0]
    free_seg = np.full((steps,), -1, np.int32)
    if exit_at < steps:
        free_seg[exit_at] = 0
    llc = np.concatenate([np.full((fva.shape[0],), 0.45, np.float32), btr.llc])
    return Trace(va=va, is_write=wr, free_seg=free_seg, llc=llc,
                 seg_of_map=seg_of_map, name=f"mt_{bench}",
                 populate_steps=fva.shape[0] + btr.populate_steps)
