"""Data-page balancing (AutoNUMA, TPP, Nomad) and Algorithm-1 leaf-PT
migration (twin of the JAX package's ``core/migrate.py``).

Every ``autonuma_period`` steps a scan promotes the hottest slow-tier data
pages to DRAM and demotes cold DRAM pages to make room; each completed
migration then triggers Algorithm 1 for its leaf PT page, in batch order
(first trigger per leaf evaluates; already-there, same-tier and
sibling-guard skips; the earliest trigger per PMD lock domain wins).  The
three families run through one masked dataflow, as in the reference.

The scan works on ``L`` runs at once (a sweep's lanes; a single run is
``L = 1``): every state field carries a leading lane axis, and every
``CostConfig`` / ``PolicyConfig`` value is a per-lane tensor
(:func:`repro_torch.core.sim.stack_leaves`), so the lanes' switches
(``autonuma``, the family, ``autonuma_exchange``, ``mig``) gate through
masks, as under the reference's vmap.  The host skips a family's work only
where no lane of the call runs it (:class:`ScanFamilies`), which is exact:
the masked work is a no-op.

The reference's functional updates become in-place writes on the state the
scan owns.  Scatters whose indices are unique (top-B candidates) write the
old value back where masked off; scatters whose indices may repeat route
the masked-off rows to a sentinel column that is sliced off.  The f32
cost sums over candidates are a fixed pairwise tree (:func:`tree_sum`),
the same for any lane count on any device.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import tlbs
from .config import MIG_NOMAD, MIG_TPP, CostConfig, MachineConfig, PolicyConfig
from .state import SimState, is_dram

I32 = torch.int32
F32 = torch.float32


def tier_ext(mc: MachineConfig, device) -> torch.Tensor:
    """i32[n_nodes+1] tier per node, indexed by ``node + 1`` so node -1
    (unallocated) maps to the slowest tier."""
    return torch.tensor((mc.n_tiers - 1,) + mc.tier_of_node, dtype=I32,
                        device=device)


def tier_read_lat(cc: CostConfig, mc: MachineConfig, device) -> torch.Tensor:
    """f32[n_tiers] read latency per tier: DRAM, CXL..., NVMM."""
    vals = [cc.dram_read] + [cc.cxl_read] * (mc.n_tiers - 2) + [cc.nvmm_read]
    return torch.tensor(vals, dtype=F32, device=device)


def tier_write_lat(cc: CostConfig, mc: MachineConfig, device) -> torch.Tensor:
    vals = [cc.dram_write] + [cc.cxl_write] * (mc.n_tiers - 2) + [cc.nvmm_write]
    return torch.tensor(vals, dtype=F32, device=device)


class NodeTables(NamedTuple):
    """Per-node tables indexed by ``node + 1`` (node -1, unallocated, reads
    the slowest tier), made once per run on its device."""

    read: torch.Tensor    # f32[n_nodes+1]: tier_read_lat[tier_ext[node + 1]]
    write: torch.Tensor   # f32[n_nodes+1]
    tier: torch.Tensor    # i64[n_nodes+1]: tier_ext


def node_tables(cc: CostConfig, mc: MachineConfig, device) -> NodeTables:
    text = tier_ext(mc, device).long()
    return NodeTables(tier_read_lat(cc, mc, device)[text],
                      tier_write_lat(cc, mc, device)[text], text)


def lane_tables(ccs, mc: MachineConfig, device) -> NodeTables:
    """:func:`node_tables` of each lane's CostConfig: ``read`` and
    ``write`` ``f32[L, n_nodes + 1]``, ``tier`` shared."""
    per_lane = [node_tables(cc, mc, device) for cc in ccs]
    return NodeTables(torch.stack([t.read for t in per_lane]),
                      torch.stack([t.write for t in per_lane]),
                      per_lane[0].tier)


class ScanFamilies(NamedTuple):
    """Which masked parts of a scan some lane of the call runs (host
    values): a Nomad lane, a TPP lane, an Algorithm-1 (``mig``) lane."""

    nomad: bool
    tpp: bool
    mig: bool

    @classmethod
    def of(cls, policies) -> "ScanFamilies":
        policies = list(policies)
        return cls(nomad=any(int(p.mig_policy) == MIG_NOMAD for p in policies),
                   tpp=any(int(p.mig_policy) == MIG_TPP for p in policies),
                   mig=any(bool(p.mig) for p in policies))


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a fixed pairwise tree (the axis padded with
    zeros to a power of two, then halves added): the same order for any
    leading shape, so a lane's sum does not depend on how many lanes run."""
    n = x.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        x = torch.cat([x, x.new_zeros((*x.shape[:-1], p - n))], -1)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _split_two(n: torch.Tensor, cap_a: torch.Tensor, cap_b: torch.Tensor
               ) -> torch.Tensor:
    """How many of ``n`` items go to the first of two nodes: the node with
    more headroom fills first."""
    a_first = cap_a >= cap_b
    share_a = torch.where(a_first, torch.minimum(cap_a, n),
                          n - torch.minimum(cap_b, n))
    return share_a.clamp(min=0)


def _rank_key(count: torch.Tensor, idx_bits: int) -> torch.Tensor:
    """Composite int32 sort key: clipped count then low index tie-break
    (over the last axis)."""
    n = 1 << idx_bits
    idx = torch.arange(count.shape[-1], dtype=I32, device=count.device)
    return (count.clamp(0, 255) << idx_bits) | (n - 1 - idx)


def _top_k_ranked(key: torch.Tensor, B: int, idx_bits: int) -> torch.Tensor:
    """The indices of ``jax.lax.top_k(key, B)`` on ``_rank_key`` keys, in
    its order (the reference's selection, step for step), over the last
    axis: ``key`` ``[n]`` or ``[L, n]`` (a row per lane).

    Keys are distinct except at the shared -1, where ``top_k`` takes the
    lower index first: a binary-searched count cutoff, then the cutoff's
    ties lowest index first (cumsum), the selected indices in index order
    (``searchsorted``, left), and a stable sort by key, descending.
    """
    dev = key.device
    if key.dim() == 1:
        return _top_k_ranked(key[None], B, idx_bits)[0]
    L = key.shape[0]
    if B <= 0:
        return torch.zeros((L, 0), dtype=I32, device=dev)
    bucket = (key >> idx_bits) + 1        # 0 invalid (-1 key), 1.. counts

    # Largest v in [0, 257] with #(bucket >= v) >= B; count_ge is monotone
    # in v and count_ge(0) = n >= B.
    lo = torch.zeros((L, 1), dtype=I32, device=dev)
    hi = torch.full((L, 1), 257, dtype=I32, device=dev)
    for _ in range(9):                    # 2^9 > 258
        mid = (lo + hi + 1) >> 1
        ge = (bucket >= mid).sum(1, keepdim=True) >= B
        lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid - 1)
    vstar = lo

    sel_gt = bucket > vstar               # all of these are in the top-B
    n_gt = sel_gt.sum(1, keepdim=True)
    eq = bucket == vstar                  # ties at the cutoff: lowest
    sel_eq = eq & (eq.cumsum(1) <= B - n_gt)    # index first
    sel = sel_gt | sel_eq                 # exactly B elements a row
    want = torch.arange(1, B + 1, device=dev).expand(L, B).contiguous()
    idxs = torch.searchsorted(sel.cumsum(1), want, side="left")
    order = torch.argsort(-key.gather(1, idxs), dim=1, stable=True)
    return idxs.gather(1, order).to(I32)


def _add_at(idx: torch.Tensor, vals: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """i32[L, n_nodes]: ``vals`` summed per lane at the nodes ``idx``
    (``[L, K]``, clipped)."""
    out = torch.zeros((idx.shape[0], n_nodes), dtype=I32, device=idx.device)
    return out.scatter_add_(1, idx.clamp(0, n_nodes - 1).long(), vals.to(I32))


def lane_take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``arr[l, idx[l, ...]]`` for ``arr`` ``[L, n]`` and an integer
    ``idx`` ``[L, ...]``.  One lane reads its row with ``index_select``,
    which takes the int32 index as it is; more lanes ``gather``, which
    needs an int64 copy of it (one more device op a call)."""
    L = arr.shape[0]
    if L == 1:
        out = arr.index_select(1, idx.reshape(-1))
        return out if idx.dim() == 2 else out.view(idx.shape)
    return arr.gather(1, idx.reshape(L, -1).long()).view(idx.shape)


def lane_add_at(arr: torch.Tensor, idx: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
    """``arr[l, idx[l, ...]] += vals[l, ...]`` in place (integers, so the
    order of the adds is free); one lane through ``index_add_`` with the
    int32 index, as :func:`lane_take`."""
    L = arr.shape[0]
    if vals.dim() != 2:
        vals = vals.reshape(L, -1)
    if L == 1:
        return arr.index_add_(1, idx.reshape(-1), vals)
    return arr.scatter_add_(1, idx.reshape(L, -1).long(), vals)


def lane_lat(table: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
    """Each lane's ``table`` (``[L, n_nodes + 1]``) at ``node + 1``
    (``node`` ``[L, ...]``)."""
    return lane_take(table, node + 1)


def autonuma_scan(st: SimState, mc: MachineConfig, cc: CostConfig,
                  pc: PolicyConfig, wm: torch.Tensor, budget: int,
                  va_row: torch.Tensor, w_row: torch.Tensor,
                  tables: NodeTables, families: ScanFamilies
                  ) -> Tuple[SimState, torch.Tensor]:
    """One balancing scan + (optionally) Algorithm-1 triggers, in place,
    for every lane.

    Runs whichever family each lane's ``pc.mig_policy`` selects (AutoNUMA,
    TPP or Nomad).  ``cc`` and ``pc`` hold per-lane ``[L]`` tensors;
    ``budget`` is the candidate bound B (at least every lane's
    ``autonuma_budget``, clipped to ``n_map``, which gates each lane);
    ``va_row`` / ``w_row`` ``[L, T]`` are the current step's accesses
    (Nomad's concurrent-write abort); ``tables`` the lanes' latency
    tables (``[L, n_nodes + 1]``, :func:`lane_tables`); ``families`` what
    the lanes run.  Returns the state and each lane's migration cycles
    (f32[L]).
    """
    read_lat, write_lat = tables.read, tables.write
    dev = st.data_node.device
    L, n_map = st.data_node.shape
    n_nodes = st.node_free.shape[1]
    rb = mc.radix_bits
    B = min(int(budget), n_map)
    idx_bits = max(n_map - 1, 1).bit_length()
    enabled = pc.autonuma & ~st.oom_killed                     # [L]
    budget_t = pc.autonuma_budget.clamp(max=n_map)
    en_tpp = pc.mig_policy == MIG_TPP
    en_nomad = pc.mig_policy == MIG_NOMAD
    threshold = pc.autonuma_threshold[:, None]

    def col(x):
        return x[:, None]

    # ---- Nomad shadow invalidation ----------------------------------------
    shadow = st.shadow_node
    written = st.written_recent
    if families.nomad:
        drop = col(enabled & en_nomad) & (shadow >= 0) & (written > 0)
        free0 = st.node_free + _add_at(shadow, drop, n_nodes)
        shadow = torch.where(drop, -1, shadow)
        n_drops = drop.sum(1, dtype=I32)
    else:
        free0 = st.node_free
        n_drops = 0

    # ---- hot candidates (promotion) ---------------------------------------
    on_nvmm = st.data_node >= 2
    hot_count = torch.where(on_nvmm & (st.access_recent >= threshold),
                            st.access_recent, 0)
    hot_key = torch.where(hot_count > 0, _rank_key(hot_count, idx_bits), -1)
    hot_pages = _top_k_ranked(hot_key, B, idx_bits).long()
    hot_valid = hot_key.gather(1, hot_pages) > 0
    n_hot = torch.minimum(hot_valid.sum(1, dtype=I32), budget_t)

    # Cold DRAM victims: TPP demotes only inactive pages; AutoNUMA
    # exchange considers every DRAM page, coldest first.
    on_dram = is_dram(st.data_node)
    elig = on_dram
    if families.tpp:
        elig = on_dram & (~col(en_tpp) | (st.access_recent < threshold))
    cold_score = torch.where(elig, 255 - st.access_recent.clamp(0, 255), 0)
    cold_key = torch.where(elig, _rank_key(cold_score, idx_bits), -1)
    cold_pages = _top_k_ranked(cold_key, B, idx_bits).long()
    cold_valid = cold_key.gather(1, cold_pages) >= 0

    excess0 = torch.clamp(free0[:, 0] - wm[0], min=0)
    excess1 = torch.clamp(free0[:, 1] - wm[1], min=0)
    dram_excess = excess0 + excess1

    n_promote_want = torch.minimum(n_hot, budget_t)
    need_demote = torch.clamp(n_promote_want - dram_excess, min=0)
    n_victims = torch.minimum(cold_valid.sum(1, dtype=I32), budget_t)

    # TPP keeps the low watermark plus a headroom fraction of tier 0 free
    cap0 = 2 * mc.tier_capacities[0]
    tpp_extra = (pc.tpp_demote_wm * cap0).to(I32)
    need_tpp = torch.clamp(wm[0] + wm[1] + tpp_extra
                           - (free0[:, 0] + free0[:, 1]), min=0)
    need_eff = torch.where(en_tpp, torch.maximum(need_tpp, need_demote),
                           need_demote)

    # Demotion destination: TPP steps to the next-slower non-empty tier;
    # AutoNUMA/Nomad demote straight to the slowest.
    caps = mc.tier_capacities
    tpp_t = next(t for t in range(1, mc.n_tiers) if caps[t] > 0)
    dest_a = torch.where(en_tpp, 2 * tpp_t, 2 * (mc.n_tiers - 1)).to(I32)
    dest_b = dest_a + 1
    cap_a = free0.gather(1, col(dest_a).long())[:, 0]
    cap_b = free0.gather(1, col(dest_b).long())[:, 0]
    room = cap_a.clamp(min=0) + cap_b.clamp(min=0)
    dem_en = en_tpp | pc.autonuma_exchange
    n_demote = torch.where(enabled & dem_en,
                           torch.minimum(torch.minimum(need_eff, n_victims),
                                         room), 0)
    n_promote = torch.where(enabled, torch.minimum(n_promote_want,
                                                   dram_excess + n_demote), 0)

    # ---- apply demotions ---------------------------------------------------
    k = torch.arange(B, dtype=I32, device=dev)
    dem_mask = k < col(n_demote)
    dem_pages = cold_pages
    share_a = _split_two(n_demote, cap_a, cap_b)
    dem_dest = torch.where(k < col(share_a), col(dest_a), col(dest_b)).to(I32)
    dem_src = st.data_node.gather(1, dem_pages)

    if families.nomad:
        # Nomad flip: a demoted page whose clean shadow survived skips the
        # copy
        shadow_at_dem = shadow.gather(1, dem_pages)
        flip = dem_mask & col(en_nomad) & (shadow_at_dem >= 0)
        dem_dest_eff = torch.where(flip, shadow_at_dem, dem_dest)
    else:
        flip = torch.zeros_like(dem_mask)
        dem_dest_eff = dem_dest

    # candidate pages are distinct: writing back the old value is exact
    data_node = st.data_node.scatter(
        1, dem_pages, torch.where(dem_mask, dem_dest_eff, dem_src))
    free_delta = _add_at(dem_src, dem_mask, n_nodes) \
        - _add_at(dem_dest_eff, dem_mask & ~flip, n_nodes)
    if families.nomad:
        shadow = shadow.scatter(1, dem_pages,
                                torch.where(flip, -1, shadow_at_dem))
    ldc = st.leaf_dram_children.scatter_add(1, dem_pages >> rb,
                                            -dem_mask.to(I32))

    # ---- apply promotions ----------------------------------------------------
    pro_mask = (k < col(n_promote)) & hot_valid
    pro_pages = hot_pages
    excess0b = torch.clamp(free0[:, 0] + free_delta[:, 0] - wm[0], min=0)
    excess1b = torch.clamp(free0[:, 1] + free_delta[:, 1] - wm[1], min=0)
    share0 = _split_two(n_promote, excess0b, excess1b)
    pro_dest = torch.where(k < col(share0), 0, 1).to(I32)
    pro_src = data_node.gather(1, pro_pages)

    if families.nomad:
        # Nomad transactional abort: a page written *this step* fails its
        # promotion and retries at a later scan.  Idle threads and reads go
        # to a sentinel column.
        m_row = (va_row >> mc.map_shift).clamp(0, n_map - 1)
        conc_w = torch.zeros((L, n_map + 1), dtype=torch.bool, device=dev)
        conc_w.scatter_(1, torch.where((va_row >= 0) & w_row, m_row,
                                       n_map).long(), True)
        abort = pro_mask & col(en_nomad) & conc_w.gather(1, pro_pages)
        commit = pro_mask & ~abort
        # committed Nomad promotions keep the source copy as a clean shadow
        keep_shadow = commit & col(en_nomad)
    else:
        abort = torch.zeros_like(pro_mask)
        commit = pro_mask
        keep_shadow = abort

    data_node.scatter_(1, pro_pages, torch.where(commit, pro_dest, pro_src))
    free_delta = free_delta + _add_at(pro_src, commit & ~keep_shadow, n_nodes) \
        - _add_at(pro_dest, commit, n_nodes)
    if families.nomad:
        shadow.scatter_(1, pro_pages, torch.where(
            keep_shadow, pro_src, shadow.gather(1, pro_pages)))
    ldc.scatter_add_(1, pro_pages >> rb, commit.to(I32))

    n_data_migs = dem_mask.sum(1, dtype=I32) + commit.sum(1, dtype=I32)
    fixed = col(cc.migrate_fixed + cc.tlb_flush)
    copy_lines = col(cc.copy_lines)
    costs = torch.stack([
        torch.where(dem_mask, fixed + torch.where(
            flip, 0.0, copy_lines * (lane_lat(read_lat, dem_src)
                                     + lane_lat(write_lat, dem_dest_eff))), 0.0),
        torch.where(commit, fixed + copy_lines * (lane_lat(read_lat, pro_src)
                                                  + lane_lat(write_lat, pro_dest)),
                    0.0),
        # an aborted transactional copy still paid the read half +
        # bookkeeping
        torch.where(abort, col(cc.migrate_fixed)
                    + copy_lines * lane_lat(read_lat, pro_src), 0.0)])
    dem_cost, pro_cost, abort_cost = tree_sum(costs).unbind(0)
    mig_cost = dem_cost + pro_cost + abort_cost

    # TLB shootdown for migrated data pages (others to the sentinel column)
    map_flushed = torch.zeros((L, n_map + 1), dtype=torch.bool, device=dev)
    map_flushed.scatter_(1, torch.where(dem_mask, dem_pages, n_map), True)
    map_flushed.scatter_(1, torch.where(commit, pro_pages, n_map), True)
    tlbs.invalidate_matching(st.l1_tlb, map_flushed[:, :n_map], 0)
    tlbs.invalidate_matching(st.stlb, map_flushed[:, :n_map], 0)

    c = st.counters
    c.data_migrations += n_data_migs
    c.demotions += dem_mask.sum(1, dtype=I32)
    if families.nomad:
        c.nomad_retries += abort.sum(1, dtype=I32)
        c.nomad_flip_demotions += flip.sum(1, dtype=I32)
        c.nomad_shadow_drops += n_drops

    st.data_node, st.leaf_dram_children = data_node, ldc
    st.node_free, st.shadow_node = free0 + free_delta, shadow
    # Nomad's write window resets at its scan tick; hotness decays after
    # the scan (disabled lanes keep their counts)
    if families.nomad:
        st.written_recent = torch.where(col(enabled & en_nomad), 0, written)
    st.access_recent = torch.where(col(enabled), st.access_recent // 2,
                                   st.access_recent)

    # ---- Algorithm-1 triggers ------------------------------------------------
    if not families.mig:          # no lane triggers: an exact no-op
        return st, mig_cost
    trig_pages = torch.cat([dem_pages, pro_pages], 1)
    trig_dest = torch.cat([dem_dest_eff, pro_dest], 1)
    trig_mask = torch.cat([dem_mask, commit], 1) & col(pc.mig)
    st, l4_cost = migrate_leaf_batch(st, mc, cc, trig_pages, trig_dest,
                                     trig_mask, tables)
    return st, mig_cost + l4_cost


def _first_per_group(group: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """bool[L, K]: ``mask`` entries that come first (lowest position) among
    the masked entries of their ``group`` in their row, by a stable sort on
    ``group * K + position`` (masked-off entries last), as the reference
    does."""
    K = group.shape[1]
    pos = torch.arange(K, device=group.device)
    key = torch.where(mask, group.long() * K + pos, torch.iinfo(torch.int64).max)
    order = torch.argsort(key, dim=1, stable=True)
    g = torch.where(mask, group, -1).gather(1, order)
    first = torch.cat([torch.ones_like(g[:, :1], dtype=torch.bool),
                       g[:, 1:] != g[:, :-1]], 1)
    return torch.zeros_like(first).scatter_(1, order, first) & mask


def migrate_leaf_batch(st: SimState, mc: MachineConfig, cc: CostConfig,
                       pages: torch.Tensor, dest: torch.Tensor,
                       mask: torch.Tensor, tables: NodeTables
                       ) -> Tuple[SimState, torch.Tensor]:
    """Vectorized Algorithm 1 over a batch of completed data migrations
    (``pages`` / ``dest`` / ``mask``, ``[L, K]`` in trigger order), in
    place; returns each lane's cycles (f32[L])."""
    read_lat, write_lat = tables.read, tables.write
    dev = pages.device
    L = pages.shape[0]
    leaf = pages >> mc.radix_bits
    lock_dom = leaf >> mc.lock_domain_shift   # PMD try-lock conflict domain
    n_leaf = st.leaf_node.shape[1]
    n_nodes = st.node_free.shape[1]

    # First trigger per leaf page (in batch order) evaluates Algorithm 1.
    is_first = _first_per_group(leaf, mask)

    def tier_of(n):
        return tables.tier[n.long() + 1]

    l4_node = st.leaf_node.gather(1, leaf)
    already_dest = l4_node == dest
    in_same_tier = (tier_of(l4_node) == tier_of(dest)) & ~already_dest
    children_dram = st.leaf_dram_children.gather(1, leaf)
    dest_slower = tier_of(dest) > 0
    sibling_guard = dest_slower & (children_dram > 0)

    want = is_first & (l4_node >= 0) & ~already_dest & ~in_same_tier \
        & ~sibling_guard

    # PMD try_lock: among wants sharing a lock domain, earliest wins.
    lock_ok = _first_per_group(lock_dom, want)
    lock_skip = want & ~lock_ok

    # Destination must have a free page (alloc_pages_node on dest).
    dest_free = st.node_free.gather(1, dest.clamp(0, n_nodes - 1).long())
    can_alloc = dest_free > 0
    winner = lock_ok & can_alloc
    alloc_fail = lock_ok & ~can_alloc

    src = torch.where(winner, l4_node, 0)
    # winners are unique per leaf; non-winners go to a sentinel column, so
    # a repeated leaf id cannot revert a winner's write
    leaf_node = torch.cat([st.leaf_node, st.leaf_node.new_zeros((L, 1))], 1)
    leaf_node.scatter_(1, torch.where(winner, leaf, n_leaf).long(), dest)
    leaf_node = leaf_node[:, :n_leaf].contiguous()

    free_delta = _add_at(src, winner, n_nodes) - _add_at(dest, winner, n_nodes)
    base = (cc.migrate_fixed + cc.tlb_flush + cc.alloc_fast)[:, None]
    cost = tree_sum(torch.where(
        winner, base + cc.copy_lines[:, None] * (lane_lat(read_lat, src)
                                                 + lane_lat(write_lat, dest)),
        0.0))

    # Shoot down translations covered by migrated leaf pages.
    leaf_flushed = torch.zeros((L, n_leaf + 1), dtype=torch.bool, device=dev)
    leaf_flushed.scatter_(1, torch.where(winner, leaf, n_leaf).long(), True)
    leaf_flushed = leaf_flushed[:, :n_leaf]
    tlbs.invalidate_matching(st.l1_tlb, leaf_flushed, mc.radix_bits)
    tlbs.invalidate_matching(st.stlb, leaf_flushed, mc.radix_bits)
    tlbs.invalidate_matching(st.pde_pwc, leaf_flushed, 0)

    # Skip-reason accounting (paper Table 5): first triggers were judged
    # against the pre-batch table, the rest against the post-migration one.
    first_eval = is_first & (l4_node >= 0)
    others = mask & ~is_first & (leaf >= 0)
    new_l4 = leaf_node.gather(1, leaf)
    o_already = others & (new_l4 == dest)
    o_tier = others & ~o_already & (tier_of(new_l4) == tier_of(dest))
    o_sibling = others & ~o_already & ~o_tier & dest_slower & (children_dram > 0)

    def count(x):
        return x.sum(1, dtype=I32)

    c = st.counters
    c.l4_mig_success += count(winner)
    c.l4_mig_already_dest += count(first_eval & already_dest) + count(o_already)
    c.l4_mig_in_dram += count(first_eval & in_same_tier) + count(o_tier)
    c.l4_mig_sibling_guard += count(
        first_eval & ~already_dest & ~in_same_tier & sibling_guard) \
        + count(o_sibling)
    c.l4_mig_lock_skip += count(lock_skip | alloc_fail)

    st.leaf_node = leaf_node
    st.node_free = st.node_free + free_delta
    return st, cost
