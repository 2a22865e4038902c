"""Pure-Python oracle for the tiered-memory simulator (the port's own copy
of the JAX package's ``core/ref.py``, the same code over the port's
``core`` types; it imports neither JAX nor the JAX package, so a run on
the card can be held to it).

Replicates ``core.sim`` step-for-step at small scales (python loops, numpy
scalars) so tests can compare placement arrays and counters exactly and
cycle totals to float32 rounding.  Every ordering rule of the engine is
mirrored:

  * phase A (mapped accesses) uses the pre-step state for every thread;
  * phase B (faults) runs threads in index order — the serialization
    contract the batched fault engine reproduces: the first thread to
    touch a shared mapping granule (or missing PT entry) allocates it,
    later same-step threads take the cheap "wait" path, and once an
    allocation fails every later thread is OOM-gated.  Because mapped-ness
    and PT-entry existence are policy-independent, that conflict structure
    is exactly ``sim.fault_schedule``'s host-precomputed bits, and
    :meth:`OracleSim.run` *asserts* the equivalence on the fly (pre-OOM,
    when starting from a pristine address space — a chained second run
    is pre-populated, where the schedule over-approximates by design):
    phase A's miss set must equal the schedule's DO bits and the
    real-fault/wait split must equal its WINNER bits;
  * TLB/PWC victim choice: ``argmin`` over LRU stamps with lowest-way
    tie-break, empty slots stamped -1;
  * AutoNUMA ordering via the same composite integer sort keys;
  * Algorithm-1 trigger batches: first-per-leaf evaluates, winners apply,
    later triggers are judged against the post-migration table; try-lock
    conflicts resolve to the earliest batch position per mid-level page.
"""
from __future__ import annotations

import numpy as np

from .config import (CostConfig, MachineConfig, PolicyConfig, INTERLEAVE,
                     MIG_NOMAD, MIG_TPP, PT_BIND_ALL, PT_BIND_HIGH,
                     PT_FOLLOW_DATA)
from .sim import (SCHED_DO, SCHED_WINNER, Trace, fault_schedule)

# (SimState field, OracleSim attribute) of each placement array: data,
# PT pages per level, the nodes' free pages and Nomad's shadow copies
PLACEMENTS = (("data_node", "data_node"), ("leaf_node", "leaf_node"),
              ("mid_node", "mid_node"), ("top_node", "top_node"),
              ("root_node", "root_node"), ("node_free", "free"),
              ("shadow_node", "shadow"))

_MIX = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)
M32 = 0xFFFFFFFF


def bern(p, site, *keys) -> bool:
    h = (0x811C9DC5 + 0x1000193 * site) & M32
    for i, k in enumerate(keys):
        h = ((h ^ (int(k) & M32)) * _MIX[i % 4]) & M32
    h = (h >> 8) & 0xFFFFFF
    thr = int(np.float32(p) * np.float32(1 << 24))
    return h < thr


class _Tlb:
    def __init__(self, sets, ways):
        self.sets, self.ways = sets, ways
        self.tags = np.full((sets, ways), -1, np.int64)
        self.lru = np.full((sets, ways), -1, np.int64)

    def lookup(self, tag):
        s = tag % self.sets
        ways = self.tags[s]
        hits = np.where(ways == tag)[0]
        if len(hits):
            return True, int(hits[0])
        return False, int(np.argmin(self.lru[s]))

    def update(self, tag, way, now):
        s = tag % self.sets
        self.tags[s, way] = tag
        self.lru[s, way] = now

    def invalidate_where(self, pred):
        for s in range(self.sets):
            for w in range(self.ways):
                t = self.tags[s, w]
                if t >= 0 and pred(int(t)):
                    self.tags[s, w] = -1
                    self.lru[s, w] = -1


class OracleSim:
    def __init__(self, mc: MachineConfig, cc: CostConfig, pc: PolicyConfig):
        self.mc, self.cc, self.pc = mc, cc, pc
        T = mc.n_threads
        self.n_map = mc.n_map
        self.n_leaf = mc.n_leaf_pages
        self.rb = mc.radix_bits
        self.n_mid = mc.n_mid_pages
        self.n_top = mc.n_top_pages
        self.thp = mc.page_order > 0
        self.nt = mc.n_tiers
        self.tier_of = mc.tier_of_node
        self.rd_vals = [cc.dram_read] + [cc.cxl_read] * (self.nt - 2) \
            + [cc.nvmm_read]
        self.wr_vals = [cc.dram_write] + [cc.cxl_write] * (self.nt - 2) \
            + [cc.nvmm_write]

        self.data_node = np.full(self.n_map, -1, np.int64)
        self.leaf_node = np.full(self.n_leaf, -1, np.int64)
        self.mid_node = np.full(self.n_mid, -1, np.int64)
        self.top_node = np.full(self.n_top, -1, np.int64)
        self.root_node = np.full(1, -1, np.int64)
        self.ldc = np.zeros(self.n_leaf, np.int64)

        cap = np.array(mc.node_capacity(), np.int64)
        self.reclaimable = (cap.astype(np.float32) * mc.reclaimable_frac
                            ).astype(np.int64)
        self.free = cap - self.reclaimable
        self.wm = (cap.astype(np.float32) * mc.low_watermark).astype(np.int64)
        self.interleave_ptr = 0
        self.oom = False
        self.oom_step = -1
        self.access = np.zeros(self.n_map, np.int64)
        self.shadow = np.full(self.n_map, -1, np.int64)
        self.written = np.zeros(self.n_map, np.int64)

        self.l1 = [_Tlb(mc.l1_tlb_sets, mc.l1_tlb_ways) for _ in range(T)]
        self.stlb = [_Tlb(mc.stlb_sets, mc.stlb_ways) for _ in range(T)]
        self.pde = [_Tlb(1, mc.pde_pwc_entries) for _ in range(T)]
        self.pdpte = [_Tlb(1, mc.pdpte_pwc_entries) for _ in range(T)]

        self.cy_total = np.zeros(T, np.float32)
        self.cy_walk = np.zeros(T, np.float32)
        self.cy_stall = np.zeros(T, np.float32)
        self.cy_data = np.zeros(T, np.float32)
        self.cy_fault = np.zeros(T, np.float32)
        self.cy_mig = np.float32(0)
        self.cnt = dict(l1_hits=0, stlb_hits=0, walks=0, walk_mem_reads=0,
                        faults=0, slow_allocs=0, data_migrations=0,
                        demotions=0, l4_mig_success=0, l4_mig_already_dest=0,
                        l4_mig_in_dram=0, l4_mig_sibling_guard=0,
                        l4_mig_lock_skip=0, oom_kills=0, nomad_retries=0,
                        nomad_flip_demotions=0, nomad_shadow_drops=0)
        self.data_allocs = np.zeros(len(cap), np.int64)
        self.pt_allocs = np.zeros(len(cap), np.int64)
        self.step = 0

    # ---------------- helpers -------------------------------------------------
    def _is_dram(self, n):
        return 0 <= n < 2

    def _tier(self, n):
        """Tier of a node; node -1 (unallocated) maps to the slowest tier,
        mirroring ``migrate.tier_ext``'s node+1 indexing."""
        return self.nt - 1 if n < 0 else int(self.tier_of[n])

    def _rd(self, n):
        return np.float32(self.rd_vals[self._tier(n)])

    def _wr_(self, n):
        return np.float32(self.wr_vals[self._tier(n)])

    def _alloc_one(self, prefs, ignore_wm):
        """Mirror of alloc.alloc_one."""
        cand_fast = cand_slow = cand_rec = None
        for p in prefs:
            if p < 0:
                continue
            wm = 0 if ignore_wm else self.wm[p]
            if cand_fast is None and self.free[p] > wm:
                cand_fast = p
            if cand_slow is None and self.free[p] > 0:
                cand_slow = p
            if cand_rec is None and self.reclaimable[p] > 0:
                cand_rec = p
        if cand_fast is not None:
            self.free[cand_fast] -= 1
            return cand_fast, False
        if cand_slow is not None:
            self.free[cand_slow] -= 1
            return cand_slow, True
        if cand_rec is not None:
            self.reclaimable[cand_rec] -= 1
            return cand_rec, True
        return -1, True

    def _data_prefs(self, t):
        if self.pc.data_policy == INTERLEAVE:
            # round-robin over the *allocatable* nodes only (zero-capacity
            # middle tiers never perturb the rotation)
            alloc = self.mc.alloc_nodes
            a = len(alloc)
            s = self.interleave_ptr % a
            return [alloc[(s + i) % a] for i in range(a)]
        # local then remote node of each tier, fastest tier first
        local = 0 if t < self.mc.n_threads // 2 else 1
        prefs = []
        for tt in range(self.nt):
            prefs += [2 * tt + local, 2 * tt + (1 - local)]
        return prefs

    def _dram_prefs(self, t):
        local = 0 if t < self.mc.n_threads // 2 else 1
        return [local, 1 - local]

    def _alloc_pt(self, t, arr, idx, is_upper):
        """Mirror of sim._alloc_pt_level; returns cycles charged."""
        if arr[idx] >= 0:
            return np.float32(0)
        pc = self.pc
        cost = np.float32(0)
        data_prefs = self._data_prefs(t)
        if pc.pt_policy == PT_BIND_ALL or (
                pc.pt_policy == PT_BIND_HIGH and (is_upper or self.thp)):
            node, slow = self._alloc_one(self._dram_prefs(t), True)
            if node < 0 and pc.pt_policy == PT_BIND_HIGH:
                node, slow = self._alloc_one(data_prefs, False)
        else:
            node, slow = self._alloc_one(data_prefs, False)
        if node < 0:
            self.oom = True
            if self.oom_step < 0:
                self.oom_step = self.step
            self.cnt["oom_kills"] += 1
            return np.float32(self.cc.oom_scan)
        arr[idx] = node
        self.pt_allocs[node] += 1
        if slow:
            self.cnt["slow_allocs"] += 1
        if (pc.pt_policy == PT_FOLLOW_DATA
                and pc.data_policy == INTERLEAVE):
            self.interleave_ptr += 1
        cost += np.float32(self.cc.zero_lines) * self._wr_(node)
        cost += np.float32(self.cc.alloc_slow if slow else self.cc.alloc_fast)
        return cost

    # ---------------- AutoNUMA / TPP / Nomad + Algorithm 1 -------------------
    def _autonuma(self, va_row, w_row):
        """One balancing scan, mirroring ``migrate.autonuma_scan`` exactly.

        ``va_row``/``w_row`` are the current step's access row — Nomad's
        concurrent-write abort condition (unused by the other families).
        """
        mc, cc, pc = self.mc, self.cc, self.pc
        nt = self.nt
        bt = min(int(pc.autonuma_budget), self.n_map)
        idx_bits = max(self.n_map - 1, 1).bit_length()
        nn = 1 << idx_bits
        en_tpp = int(pc.mig_policy) == MIG_TPP
        en_nomad = int(pc.mig_policy) == MIG_NOMAD

        def rank_key(count, i):
            return (min(max(count, 0), 255) << idx_bits) | (nn - 1 - i)

        # (0) Nomad shadow invalidation: a write since the last scan made
        # the shadow stale; drop it and free its page.
        if en_nomad:
            for i in range(self.n_map):
                if self.shadow[i] >= 0 and self.written[i] > 0:
                    self.free[self.shadow[i]] += 1
                    self.shadow[i] = -1
                    self.cnt["nomad_shadow_drops"] += 1

        # (1) hot candidates: same recent-access test in every family
        hot = [(rank_key(self.access[i], i), i) for i in range(self.n_map)
               if self.data_node[i] >= 2
               and self.access[i] >= pc.autonuma_threshold
               and self.access[i] > 0]
        hot.sort(key=lambda kv: -kv[0])
        hot_pages = [i for _, i in hot]
        n_hot = min(len(hot_pages), bt)

        # (2) cold tier-0 victims; TPP narrows to the *inactive* list
        cold = [(rank_key(255 - min(self.access[i], 255), i), i)
                for i in range(self.n_map)
                if self._is_dram(self.data_node[i])
                and (not en_tpp or self.access[i] < pc.autonuma_threshold)]
        cold.sort(key=lambda kv: -kv[0])
        cold_pages = [i for _, i in cold]
        n_victims = min(len(cold_pages), bt)

        excess0 = max(self.free[0] - self.wm[0], 0)
        excess1 = max(self.free[1] - self.wm[1], 0)
        dram_excess = excess0 + excess1
        n_promote_want = min(n_hot, bt)
        need_demote = max(n_promote_want - dram_excess, 0)

        # TPP demotes ahead of reclaim pressure: watermark + headroom
        # fraction of tier-0 capacity, independent of promotion demand.
        cap0 = 2 * mc.tier_capacities[0]
        tpp_extra = int(np.float32(np.float32(pc.tpp_demote_wm) * cap0))
        need_tpp = max(int(self.wm[0]) + int(self.wm[1]) + tpp_extra
                       - (int(self.free[0]) + int(self.free[1])), 0)
        need_eff = max(need_tpp, need_demote) if en_tpp else need_demote

        # demotion destination pair: TPP -> next-slower non-empty tier,
        # AutoNUMA/Nomad -> slowest tier
        caps = mc.tier_capacities
        tpp_t = next(t for t in range(1, nt) if caps[t] > 0)
        dest_a = 2 * tpp_t if en_tpp else 2 * (nt - 1)
        dest_b = dest_a + 1
        cap_a = int(self.free[dest_a])
        cap_b = int(self.free[dest_b])
        room = max(cap_a, 0) + max(cap_b, 0)
        dem_en = True if en_tpp else bool(pc.autonuma_exchange)
        n_demote = min(min(need_eff, n_victims), room) if dem_en else 0
        n_promote = min(n_promote_want, dram_excess + n_demote)

        def split_two(n, ca, cb):
            if ca >= cb:
                return max(min(ca, n), 0)
            return max(n - min(cb, n), 0)

        cost = np.float32(0)
        triggers = []     # (page, dest) in batch order
        migrated = []

        share_a = split_two(n_demote, cap_a, cap_b)
        for k in range(n_demote):
            page = cold_pages[k]
            dest = dest_a if k < share_a else dest_b
            src = self.data_node[page]
            # Nomad flip: a surviving (clean) shadow *becomes* the page —
            # no copy, no new occupancy on the destination.
            flip = en_nomad and self.shadow[page] >= 0
            dest_eff = int(self.shadow[page]) if flip else dest
            self.data_node[page] = dest_eff
            self.free[src] += 1
            if flip:
                self.shadow[page] = -1
                self.cnt["nomad_flip_demotions"] += 1
            else:
                self.free[dest_eff] -= 1
            self.ldc[page >> self.rb] -= 1
            add = np.float32(cc.migrate_fixed + cc.tlb_flush)
            if not flip:
                add = add + np.float32(cc.copy_lines) * \
                    (self._rd(src) + self._wr_(dest_eff))
            cost += add
            self.cnt["demotions"] += 1
            self.cnt["data_migrations"] += 1
            triggers.append((page, dest_eff))
            migrated.append(page)

        # granules written *this step* (Nomad's transactional-abort set)
        conc_w = set()
        for t in range(mc.n_threads):
            va = int(va_row[t])
            if va >= 0 and bool(w_row[t]):
                conc_w.add(min(va >> mc.map_shift, self.n_map - 1))

        excess0b = max(self.free[0] - self.wm[0], 0)
        excess1b = max(self.free[1] - self.wm[1], 0)
        share0 = split_two(n_promote, excess0b, excess1b)
        for k in range(n_promote):
            page = hot_pages[k]
            src = self.data_node[page]
            if en_nomad and page in conc_w:
                # transactional abort: the copy's read half + bookkeeping
                # were already paid; the page retries at a later scan
                cost += np.float32(cc.migrate_fixed) + \
                    np.float32(cc.copy_lines) * self._rd(src)
                self.cnt["nomad_retries"] += 1
                continue
            dest = 0 if k < share0 else 1
            self.data_node[page] = dest
            if en_nomad:
                self.shadow[page] = src   # non-exclusive: keep clean shadow
            else:
                self.free[src] += 1
            self.free[dest] -= 1
            self.ldc[page >> self.rb] += 1
            cost += np.float32(cc.migrate_fixed + cc.tlb_flush) + \
                np.float32(cc.copy_lines) * (self._rd(src) + self._wr_(dest))
            self.cnt["data_migrations"] += 1
            triggers.append((page, dest))
            migrated.append(page)

        mig_set = set(migrated)
        for tlb_list in (self.l1, self.stlb):
            for tlb in tlb_list:
                tlb.invalidate_where(lambda tag: tag in mig_set)
        if en_nomad:
            self.written[:] = 0
        self.access //= 2

        if pc.mig and triggers:
            cost += self._migrate_leaf_batch(triggers)
        return cost

    def _migrate_leaf_batch(self, triggers):
        cc = self.cc
        cost = np.float32(0)
        pre_free = self.free.copy()
        seen_leaf = {}
        first_flags = []
        for pos, (page, dest) in enumerate(triggers):
            leaf = page >> self.rb
            first = leaf not in seen_leaf
            seen_leaf.setdefault(leaf, pos)
            first_flags.append(first)

        # pass 1: firsts evaluate against the pre-batch table
        wants = []
        for pos, (page, dest) in enumerate(triggers):
            if not first_flags[pos]:
                continue
            leaf = page >> self.rb
            l4n = self.leaf_node[leaf]
            if l4n < 0:
                continue
            if l4n == dest:
                self.cnt["l4_mig_already_dest"] += 1
                continue
            if self._tier(l4n) == self._tier(dest):
                self.cnt["l4_mig_in_dram"] += 1
                continue
            if self._tier(dest) > 0 and self.ldc[leaf] > 0:
                self.cnt["l4_mig_sibling_guard"] += 1
                continue
            wants.append(pos)

        locked_mids = set()
        winners = []
        for pos in wants:
            page, dest = triggers[pos]
            mid = (page >> self.rb) >> self.mc.lock_domain_shift
            if mid in locked_mids:
                self.cnt["l4_mig_lock_skip"] += 1
                continue
            locked_mids.add(mid)
            if pre_free[dest] <= 0:
                self.cnt["l4_mig_lock_skip"] += 1
                continue
            winners.append(pos)

        flushed_leaves = set()
        for pos in winners:
            page, dest = triggers[pos]
            leaf = page >> self.rb
            src = self.leaf_node[leaf]
            self.leaf_node[leaf] = dest
            self.free[src] += 1
            self.free[dest] -= 1
            cost += np.float32(cc.migrate_fixed + cc.tlb_flush + cc.alloc_fast) \
                + np.float32(cc.copy_lines) * (self._rd(src) + self._wr_(dest))
            self.cnt["l4_mig_success"] += 1
            flushed_leaves.add(leaf)

        # pass 2: non-first triggers judged against the post-migration table
        for pos, (page, dest) in enumerate(triggers):
            if first_flags[pos]:
                continue
            leaf = page >> self.rb
            new_l4 = self.leaf_node[leaf]
            if new_l4 == dest:
                self.cnt["l4_mig_already_dest"] += 1
            elif self._tier(new_l4) == self._tier(dest):
                self.cnt["l4_mig_in_dram"] += 1
            elif self._tier(dest) > 0 and self.ldc[leaf] > 0:
                self.cnt["l4_mig_sibling_guard"] += 1

        for tlb_list in (self.l1, self.stlb):
            for tlb in tlb_list:
                tlb.invalidate_where(lambda tag: (tag >> self.rb) in flushed_leaves)
        for tlb in self.pde:
            tlb.invalidate_where(lambda tag: tag in flushed_leaves)
        return cost

    # ---------------- step ----------------------------------------------------
    def run(self, trace: Trace):
        mc, cc, pc = self.mc, self.cc, self.pc
        T = mc.n_threads
        shift = mc.map_shift
        seg_of_map = np.asarray(trace.seg_of_map)
        n_leaf = self.n_leaf
        seg_of_leaf = seg_of_map[(np.arange(n_leaf) << self.rb) % max(self.n_map, 1)]
        # The host-precomputed fault schedule must predict this oracle's
        # phase-B behavior exactly until the OOM latch fires (see module
        # docstring); both assertions below enforce that equivalence.
        # They only hold from a pristine address space — a chained
        # second run() (resume-style) starts pre-populated, where the
        # schedule deliberately over-approximates, so skip them then.
        assert_schedule = self.step == 0
        sched = fault_schedule(trace, self.mc)

        for s in range(trace.n_steps):
            oom_at_step_start = self.oom
            fid = int(trace.free_seg[s])
            if fid >= 0:
                self._free_segment(fid, seg_of_map, seg_of_leaf)

            va_row = trace.va[s]
            w_row = trace.is_write[s]
            llc_rate = float(trace.llc[s])

            if pc.autonuma and self.step > 0 \
                    and self.step % pc.autonuma_period == 0 and not self.oom:
                c = self._autonuma(va_row, w_row)
                self.cy_total += c * np.float32(cc.mig_cost_scale) / np.float32(T)
                self.cy_mig += c

            # ---- phase A ------------------------------------------------
            fault_mask = np.zeros(T, bool)
            for t in range(T):
                va = int(va_row[t])
                if va < 0 or self.oom:
                    continue
                m = min(max(va >> shift, 0), self.n_map - 1)
                if self.data_node[m] < 0:
                    fault_mask[t] = True
                    continue
                self._mapped_access(t, m, bool(w_row[t]), llc_rate)
            if assert_schedule and not oom_at_step_start:
                exp_do = (sched[s] & SCHED_DO) > 0
                assert (fault_mask == exp_do).all(), \
                    f"step {s}: fault_schedule DO bits diverge from oracle"
            # ---- phase B ------------------------------------------------
            for t in range(T):
                if not fault_mask[t] or self.oom:
                    continue
                va = int(va_row[t])
                m = min(max(va >> shift, 0), self.n_map - 1)
                assert not assert_schedule or \
                    (self.data_node[m] < 0) == bool(sched[s, t]
                                                    & SCHED_WINNER), \
                    f"step {s} thread {t}: WINNER bit diverges from oracle"
                self._fault(t, m, bool(w_row[t]))
            self.step += 1

    def _mapped_access(self, t, m, is_write, llc_rate):
        cc = self.cc
        now = self.step
        hit1, way1 = self.l1[t].lookup(m)
        hit2, way2 = self.stlb[t].lookup(m)
        walkn = not hit1 and not hit2
        leaf_id, mid_id, top_id = m >> self.rb, m >> (2 * self.rb), m >> (3 * self.rb)
        pde_hit, pde_way = self.pde[t].lookup(leaf_id)
        pdpte_hit, pdpte_way = self.pdpte[t].lookup(mid_id)

        walk_cost = np.float32(0)
        walk_reads = 0
        if walkn:
            leaf_llc = bern(cc.leaf_llc_hit, 1, m, now, t)
            up1 = bern(cc.upper_llc_hit, 2, mid_id, now, t)
            up2 = bern(cc.upper_llc_hit, 3, top_id, now, t)
            leaf_read = np.float32(cc.llc_hit) if leaf_llc \
                else self._rd(self.leaf_node[leaf_id])
            mid_read = np.float32(0)
            if not pde_hit:
                mid_read = np.float32(cc.llc_hit) if up1 \
                    else self._rd(self.mid_node[min(mid_id, self.n_mid - 1)])
            full = not pde_hit and not pdpte_hit
            top_read = np.float32(0)
            if full and not self.thp:
                top_read = np.float32(cc.llc_hit) if up2 \
                    else self._rd(self.top_node[min(top_id, self.n_top - 1)])
            root_read = np.float32(cc.llc_hit) if full else np.float32(0)
            walk_cost = leaf_read + mid_read + top_read + root_read
            walk_reads = int(not leaf_llc) + int(not pde_hit and not up1) \
                + (int(full and not up2) if not self.thp else 0)
            self.cnt["walks"] += 1
            self.cnt["walk_mem_reads"] += walk_reads
        elif hit1:
            self.cnt["l1_hits"] += 1
        else:
            self.cnt["stlb_hits"] += 1

        data_llc = bern(llc_rate, 4, m, now, t)
        node = self.data_node[m]
        mem = self._wr_(node) if is_write else self._rd(node)
        data_cost = np.float32(cc.llc_hit) if data_llc else mem

        tlb_pen = np.float32(cc.stlb_hit) if not hit1 else np.float32(0)
        stall = walk_cost + np.float32(cc.data_stall_frac) * data_cost
        total = np.float32(cc.cpu_work) + tlb_pen + stall

        self.l1[t].update(m, way1, now)
        if not hit1:
            self.stlb[t].update(m, way2, now)
        if walkn:
            self.pde[t].update(leaf_id, pde_way, now)
            self.pdpte[t].update(mid_id, pdpte_way, now)
        self.access[m] += 1
        if is_write:
            self.written[m] += 1
        self.cy_total[t] += total
        self.cy_walk[t] += walk_cost
        self.cy_stall[t] += stall
        self.cy_data[t] += data_cost

    def _fault(self, t, m, is_write=False):
        cc = self.cc
        now = self.step
        if self.data_node[m] >= 0:      # raced with an earlier thread
            cost = np.float32(cc.fault_base) + np.float32(cc.llc_hit)
            self.cy_data[t] += np.float32(cc.llc_hit)
        else:
            cost = np.float32(0)
            cost += self._alloc_pt(t, self.root_node, 0, True)
            cost += self._alloc_pt(t, self.top_node,
                                   min(m >> (3 * self.rb), self.n_top - 1), True)
            cost += self._alloc_pt(t, self.mid_node,
                                   min(m >> (2 * self.rb), self.n_mid - 1), True)
            cost += self._alloc_pt(t, self.leaf_node, m >> self.rb, False)
            node, slow = self._alloc_one(self._data_prefs(t), False)
            if node < 0:
                self.oom = True
                if self.oom_step < 0:
                    self.oom_step = self.step
                self.cnt["oom_kills"] += 1
                cost += np.float32(cc.oom_scan)
            else:
                self.data_node[m] = node
                self.data_allocs[node] += 1
                if self._is_dram(node):
                    self.ldc[m >> self.rb] += 1
                if slow:
                    self.cnt["slow_allocs"] += 1
                if self.pc.data_policy == INTERLEAVE:
                    self.interleave_ptr += 1
                cost += np.float32(cc.zero_lines) * self._wr_(node) + \
                    np.float32(cc.alloc_slow if slow else cc.alloc_fast)
            mid_n = self.mid_node[min(m >> (2 * self.rb), self.n_mid - 1)]
            leaf_n = self.leaf_node[m >> self.rb]
            cost += np.float32(cc.fault_base) + self._rd(mid_n) + self._wr_(leaf_n)
            self.cnt["faults"] += 1

        _, w1 = self.l1[t].lookup(m)
        self.l1[t].update(m, w1, now)
        _, w2 = self.stlb[t].lookup(m)
        self.stlb[t].update(m, w2, now)
        _, w3 = self.pde[t].lookup(m >> self.rb)
        self.pde[t].update(m >> self.rb, w3, now)
        _, w4 = self.pdpte[t].lookup(m >> (2 * self.rb))
        self.pdpte[t].update(m >> (2 * self.rb), w4, now)
        self.access[m] += 1
        if is_write:
            self.written[m] += 1
        self.cy_total[t] += cost
        self.cy_fault[t] += cost

    def _free_segment(self, fid, seg_of_map, seg_of_leaf):
        for i in range(self.n_map):
            if seg_of_map[i] == fid and self.data_node[i] >= 0:
                n = self.data_node[i]
                self.free[n] += 1
                if self._is_dram(n):
                    self.ldc[i >> self.rb] = max(self.ldc[i >> self.rb] - 1, 0)
                self.data_node[i] = -1
                self.access[i] = 0
                self.written[i] = 0
            if seg_of_map[i] == fid and self.shadow[i] >= 0:
                # Nomad shadows of freed granules go with the segment
                self.free[self.shadow[i]] += 1
                self.shadow[i] = -1
        freed_leaves = set()
        for l in range(self.n_leaf):
            if seg_of_leaf[l] == fid and self.leaf_node[l] >= 0:
                self.free[self.leaf_node[l]] += 1
                self.leaf_node[l] = -1
                freed_leaves.add(l)
        freed_maps = set(int(i) for i in np.where(seg_of_map == fid)[0])
        for tlb_list in (self.l1, self.stlb):
            for tlb in tlb_list:
                tlb.invalidate_where(lambda tag: tag in freed_maps)
        for tlb in self.pde:
            tlb.invalidate_where(lambda tag: tag in freed_leaves)

    # ---------------- results ------------------------------------------------
    def summary(self):
        out = dict(self.cnt)
        out.update(
            total_cycles=float(np.sum(self.cy_total)),
            walk_cycles=float(np.sum(self.cy_walk)),
            stall_cycles=float(np.sum(self.cy_stall)),
            data_mem_cycles=float(np.sum(self.cy_data)),
            fault_cycles=float(np.sum(self.cy_fault)),
            migration_cycles=float(self.cy_mig),
            oom_killed=self.oom, oom_step=self.oom_step,
            data_pages_dram=int(np.sum((self.data_node >= 0)
                                       & (self.data_node < 2))),
            data_pages_nvmm=int(np.sum(self.data_node >= 2)),
            leaf_pages_dram=int(np.sum((self.leaf_node >= 0)
                                       & (self.leaf_node < 2))),
            leaf_pages_nvmm=int(np.sum(self.leaf_node >= 2)),
            data_pages_per_tier=[
                int(np.sum((self.data_node >= 2 * t)
                           & (self.data_node < 2 * t + 2)))
                for t in range(self.nt)],
            leaf_pages_per_tier=[
                int(np.sum((self.leaf_node >= 2 * t)
                           & (self.leaf_node < 2 * t + 2)))
                for t in range(self.nt)],
            shadow_pages=int(np.sum(self.shadow >= 0)),
        )
        return out
