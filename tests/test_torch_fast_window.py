"""The fast window (``ops.fast_window``, kernel N1's plain version on the
CPU) at small sizes, every comparison bitwise (integers and f32 alike):

1. ``ref.fast_window_ref`` == the port's earlier two-step path (the eager
   tile precompute of ``fast_window_tile``, then the row loop; kept here
   as the oracle), on drawn segments of ``benchmark_machine()`` and
   ``cxl_machine()`` with THP off and on, L = 1 and 3, R = 1, 7, 64 and
   128, inactive rows and an OOM-killed state;
2. a torch mirror of ``csrc/fast_window.cu``'s order (each cache's chain
   over all rows in turn, passing on the hit bits, then the cost terms
   and the left-to-right sums) == ``ref.fast_window_ref``;
3. the kernel's set index by a magic number (``ref.set_index``) == ``%``
   for every tag in ``[0, 2^31)`` at every set count of the repository's
   machines, and on 10^6 drawn tags at every set count in 1..4096;
4. ``sim.fast_window_tile`` == the JAX package's ``_build_fast_window``
   (jitted on the CPU) on one drawn state: the state and every timeline
   row.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sim as jsim
from repro.core import state as jstate
import repro_torch.core as tc
from repro_torch.core import config as cfg
from repro_torch.core import sim as tsim
from repro_torch.kernels import ops, ref

from test_blocked import tiny_machine
from test_torch_engine import to_port, tsim_fields

MACHINES = {f"{fn}(thp={thp})": (fn, thp)
            for fn in ("benchmark_machine", "cxl_machine")
            for thp in (False, True)}
# caches of more than 32 ways on benchmark_machine()'s geometry: the kernel
# folds a lane's ways lane, lane + 32, ... into its key
MACHINES["wide_machine(thp=False)"] = ("wide_machine", False)
# (L, R, T, oom)
SHAPES = [(1, 1, 4, False), (3, 7, 8, False), (1, 64, 8, False),
          (3, 128, 4, False), (1, 64, 4, True)]


def wide_machine(thp=False):
    return dataclasses.replace(cfg.benchmark_machine(thp=thp), l1_tlb_ways=40,
                               stlb_sets=32, stlb_ways=48, pde_pwc_entries=64,
                               pdpte_pwc_entries=33)


def machine(name):
    fn, thp = MACHINES[name]
    return (wide_machine if fn == "wide_machine" else getattr(cfg, fn))(thp=thp)


# -- the oracle: the two-step path before the fused kernel --------------------

def old_precompute(va, w, thr, oom, nodes, lat, now0, mc, llc_hit):
    """One run's tile precompute as ``fast_window_tile`` took it before
    the kernel did: ``va``, ``w`` ``[R, T]``, ``thr`` ``[R, 4]``."""
    rb = mc.radix_bits
    data_node, leaf_node, mid_node, top_node = nodes
    read_lat, write_lat = lat
    R, T = va.shape
    m = torch.where(va >= 0, va >> mc.map_shift, 0).clamp(0, mc.n_map - 1)
    active = (va >= 0) & ~oom
    now = torch.arange(now0, now0 + R)[:, None]
    leaf_id, mid_id, top_id = m >> rb, m >> (2 * rb), m >> (3 * rb)

    def gather(arr, idx):
        return arr.index_select(0, idx.reshape(-1)).view(idx.shape)

    leaf_n = gather(leaf_node, leaf_id)
    mid_n = gather(mid_node, mid_id.clamp(max=mid_node.shape[0] - 1))
    top_n = gather(top_node, top_id.clamp(max=top_node.shape[0] - 1))
    data_n = gather(data_node, m)
    seeds = torch.tensor([[tsim._site_seed(s)] for s in (1, 2, 3, 4)],
                         dtype=torch.int64)
    draws = tsim.bern_hash(seeds[:, :, None], (
        torch.stack([m, mid_id, top_id, m]), now,
        torch.arange(T, dtype=torch.int32))) < thr.T[:, :, None]
    leaf_llc, up1_llc, up2_llc, data_llc = draws.unbind(0)
    leaf_read = torch.where(leaf_llc, llc_hit, read_lat[leaf_n.long() + 1])
    mid_read_miss = torch.where(up1_llc, llc_hit, read_lat[mid_n.long() + 1])
    top_read_miss = torch.where(up2_llc, llc_hit, read_lat[top_n.long() + 1])
    dl = data_n.long() + 1
    mem_lat = torch.where(w, write_lat[dl], read_lat[dl])
    data_cost = torch.where(active, torch.where(data_llc, llc_hit, mem_lat),
                            0.0)
    return (m, torch.stack([active, leaf_llc, up1_llc, up2_llc], -1),
            torch.stack([leaf_read, mid_read_miss, top_read_miss, data_cost],
                        -1))


def old_row_loop(m, flags, terms, caches, acc, now0, radix_bits, thp, costs):
    """The row loop of the plain version before the fused kernel: ``m i32[L,
    R, T]``, ``flags bool[L, R, T, 4]``, ``terms f32[L, R, T, 4]`` ->
    ``(cum, counts)``, each ``[L, R, 4, T]``; ``costs`` ``f32[L, 4]``."""
    L, R, T = m.shape
    N = L * T
    llc_hit, stlb_hit, cpu_work, frac = costs.repeat_interleave(T, 0).unbind(1)
    views = [(t.view(N, *t.shape[2:]), r.view(N, *r.shape[2:]))
             for t, r in caches]
    (l1, l1r), (stlb, stlbr), (pde, pder), (pdpte, pdpter) = views
    ct, cwk, cst, cdm = (a.view(N) for a in acc)
    cum = torch.empty((L, R, 4, T), dtype=torch.float32)
    counts = torch.empty((L, R, 4, T), dtype=torch.int32)
    cnt = torch.zeros((4, N), dtype=torch.int32)
    for r in range(R):
        now = int(now0) + r
        m_r = m[:, r].reshape(N)
        act, leaf_llc, up1, up2 = flags[:, r].reshape(N, 4).unbind(1)
        lread, mread, tread, dcost = terms[:, r].reshape(N, 4).unbind(1)
        leaf, mid = m_r >> radix_bits, m_r >> (2 * radix_bits)
        hit1, k1 = ref._probe_sets(l1, l1r, m_r)
        hit2, k2 = ref._probe_sets(stlb, stlbr, m_r)
        pde_hit, k3 = ref._probe_sets(pde, pder, leaf)
        pdpte_hit, k4 = ref._probe_sets(pdpte, pdpter, mid)
        walkn = act & ~hit1 & ~hit2
        mid_read = torch.where(pde_hit, 0.0, mread)
        full = ~pde_hit & ~pdpte_hit
        top_read = torch.where(full & (not thp), tread, 0.0)
        root_read = torch.where(full, llc_hit, 0.0)
        walk_cost = torch.where(walkn, lread + mid_read + top_read + root_read,
                                0.0)
        reads = (~leaf_llc).int() + (~pde_hit & ~up1).int() \
            + (full & ~up2 & (not thp)).int()
        walk_reads = torch.where(walkn, reads, 0)
        tlb_penalty = torch.where(act & ~hit1, stlb_hit, 0.0)
        stall = walk_cost + frac * dcost
        total = torch.where(act, cpu_work, 0.0) + tlb_penalty + stall
        ref._touch(l1, l1r, k1, m_r, now, act)
        ref._touch(stlb, stlbr, k2, m_r, now, act & ~hit1)
        ref._touch(pde, pder, k3, leaf, now, walkn)
        ref._touch(pdpte, pdpter, k4, mid, now, walkn)
        ct += total
        cwk += walk_cost
        cst += stall
        cdm += dcost
        cnt += torch.stack([(act & hit1).int(), (act & ~hit1 & hit2).int(),
                            walkn.int(), walk_reads.int()])
        cum[:, r] = torch.stack([ct, cwk, cst, cdm]).view(4, L, T) \
            .transpose(0, 1)
        counts[:, r] = cnt.view(4, L, T).transpose(0, 1)
    return cum, counts


def two_step(mc, args, kw):
    """The oracle on ``ops.fast_window``'s arguments, updating them as the
    fused call does; returns ``cum``."""
    (va, w, thr, oom, nodes, lat, caches, acc, counters, hot,
     row_counts) = args
    L = va.shape[0]
    per_run = [old_precompute(va[i], w[i], thr[i], oom[i],
                              [n[i] for n in nodes], [t[i] for t in lat],
                              kw["now0"], mc, float(kw["costs"][i, 0]))
               for i in range(L)]
    m, flags, terms = (torch.stack(x) for x in zip(*per_run))
    cum, counts = old_row_loop(m, flags, terms, caches, acc, kw["now0"],
                               kw["radix_bits"], kw["thp"], kw["costs"])
    for c, k in zip(counters, counts[:, -1].sum(-1, dtype=torch.int32).T):
        c += k
    for rc, k in zip(row_counts, counts[:, :, :3].sum(-1, dtype=torch.int32)
                     .unbind(2)):
        rc += k
    for i in range(L):
        act = flags[i, ..., 0]
        hot[0][i].index_add_(0, m[i].reshape(-1), act.reshape(-1).int())
        hot[1][i].index_add_(0, m[i].reshape(-1),
                             (act & w[i]).reshape(-1).int())
    return cum


def flat_state(args):
    """Every tensor that ``ops.fast_window`` updates, in order."""
    (_, _, _, _, _, _, caches, acc, counters, hot, row_counts) = args
    return ([t for pair in caches for t in pair] + list(acc) + list(counters)
            + list(hot) + list(row_counts))


def assert_same(got, want, label):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, f"{label}: {i}"
        assert torch.equal(g, w), f"{label}: tensor {i} differs"


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "L{}-R{}-T{}-oom{}"
                         .format(*s))
@pytest.mark.parametrize("name", MACHINES)
def test_plain_version_matches_two_step_path(name, shape):
    mc = machine(name)
    L, R, T, oom = shape
    seed = R + 7 * L + 100 * list(MACHINES).index(name)
    got, kw = ref.fast_window_inputs(mc, L, R, T, seed, oom=oom)
    want, _ = ref.fast_window_inputs(mc, L, R, T, seed, oom=oom)
    cum = ops.fast_window(*got, **kw)
    want_cum = two_step(mc, want, kw)
    assert_same([cum] + flat_state(got), [want_cum] + flat_state(want), name)
    if oom:                                 # nothing counted, nothing hot
        fresh, _ = ref.fast_window_inputs(mc, L, R, T, seed, oom=oom)
        assert_same(got[8] + got[9] + got[10], fresh[8] + fresh[9] + fresh[10],
                    f"{name}: OOM-killed")


# -- a mirror of the kernel's order -------------------------------------------

def mirror_probe(tags, lru, tag, sets):
    """One warp's probe (``csrc/fast_window.cu::chain``) for each of N
    threads: a key per way, the way itself on a match, else ways * (lru +
    2) + way; the least key gives hit, and the entry its owner writes."""
    N, _, ways = tags.shape
    base = ref.set_index(tag.long(), sets) if sets > 1 else torch.zeros_like(
        tag, dtype=torch.int64)
    row = torch.arange(N) * sets + base
    set_tags = tags.view(N * sets, ways)[row]
    set_lru = lru.view(N * sets, ways)[row]
    way = torch.arange(ways)
    key = torch.where(set_tags == tag[:, None], way,
                      ways * (set_lru.long() + 2) + way)
    least = key.amin(1)
    return least < ways, row * ways + key.argmin(1)


def mirror(args, kw):
    """``ops.fast_window`` in the kernel's order; updates ``args`` and
    returns ``cum``."""
    (va, w, thr, oom, nodes, lat, caches, acc, counters, hot,
     row_counts) = args
    L, R, T = va.shape
    N = L * T
    rb, thp = kw["radix_bits"], kw["thp"]
    llc_hit, stlb_hit, cpu_work, frac = kw["costs"].repeat_interleave(
        T, 0).unbind(1)
    m, flags, terms = ref.fast_window_rows(va, w, thr, oom, nodes, lat,
                                           kw["now0"], kw["map_shift"], rb,
                                           kw["costs"][:, 0])
    m_rows = m.permute(1, 0, 2).reshape(R, N)                 # [R, N]
    act, leaf_llc, up1, up2 = flags.permute(3, 1, 0, 2).reshape(4, R, N)
    x = terms.permute(3, 1, 0, 2).reshape(4, R, N)
    hits = []
    for c, (tags, lru) in enumerate(caches):       # one warp per cache
        tags, lru = tags.view(N, *tags.shape[2:]), lru.view(N, *lru.shape[2:])
        hit = torch.empty((R, N), dtype=torch.bool)
        for r in range(R):
            tag = m_rows[r] >> (0 if c < 2 else (c - 1) * rb)
            if c == 0:
                on = act[r]
            elif c == 1:
                on = act[r] & ~hits[0][r]
            else:
                on = act[r] & ~hits[0][r] & ~hits[1][r]
            hit[r], slot = mirror_probe(tags, lru, tag, tags.shape[1])
            for arr, val in ((tags, tag), (lru, torch.full_like(tag, kw["now0"] + r))):
                flat = arr.view(-1)
                flat[slot[on]] = val[on]
        hits.append(hit)
    hit1, hit2, pde_hit, pdpte_hit = hits
    walkn = act & ~hit1 & ~hit2                    # the epilogue, per row
    full = ~pde_hit & ~pdpte_hit
    mid_read = torch.where(pde_hit, 0.0, x[1])
    top_read = torch.where(full & (not thp), x[2], 0.0)
    root_read = torch.where(full, llc_hit, 0.0)
    walk_cost = torch.where(walkn, ((x[0] + mid_read) + top_read) + root_read,
                            0.0)
    reads = torch.where(walkn, (~leaf_llc).int() + (~pde_hit & ~up1).int()
                        + (full & ~up2 & (not thp)).int(), 0)
    tlb_penalty = torch.where(act & ~hit1, stlb_hit, 0.0)
    stall = walk_cost + frac * x[3]
    total = (torch.where(act, cpu_work, 0.0) + tlb_penalty) + stall
    cum = torch.empty((L, R, 4, T), dtype=torch.float32)
    for k, col in enumerate((total, walk_cost, stall, x[3])):
        a = acc[k].view(N)
        for r in range(R):                         # row after row
            a += col[r]
            cum[:, r, k] = a.view(L, T)
    inc = torch.stack([act & hit1, act & ~hit1 & hit2, walkn]).int()
    scanned = torch.cat([inc, reads[None]]).cumsum(1, dtype=torch.int32)
    per_run = scanned.view(4, R, L, T).sum(3, dtype=torch.int32)   # [4, R, L]
    for k in range(3):
        row_counts[k] += per_run[k].T
    for k in range(4):
        counters[k] += per_run[k, -1]
    n_map = hot[0].shape[1]
    idx = (m.long() + n_map * torch.arange(L)[:, None, None]).reshape(-1)
    hot[0].view(-1).index_add_(0, idx, flags[..., 0].reshape(-1).int())
    hot[1].view(-1).index_add_(0, idx, (flags[..., 0] & w).reshape(-1).int())
    return cum


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "L{}-R{}-T{}-oom{}"
                         .format(*s))
@pytest.mark.parametrize("name", MACHINES)
def test_kernel_order_mirror_matches_plain_version(name, shape):
    mc = machine(name)
    L, R, T, oom = shape
    seed = 5000 + R + 7 * L + 100 * list(MACHINES).index(name)
    got, kw = ref.fast_window_inputs(mc, L, R, T, seed, oom=oom)
    want, _ = ref.fast_window_inputs(mc, L, R, T, seed, oom=oom)
    assert_same([mirror(got, kw)] + flat_state(got),
                [ops.fast_window(*want, **kw)] + flat_state(want), name)


def _wider_cache(args, kw, c, sets, ways):
    """Cache ``c`` of every thread replaced by a drawn ``sets x ways`` one
    (tags in their sets, a fifth of the ways empty, tied stamps)."""
    g = torch.Generator().manual_seed(sets * 1000 + ways)
    L, T = args[0].shape[0], args[0].shape[2]
    shape = (L, T, sets, ways)
    tags = torch.randint(0, 64, shape, generator=g) // sets * sets \
        + torch.arange(sets)[:, None]
    empty = torch.rand(shape, generator=g) < 0.2
    lru = kw["now0"] - 1 - torch.randint(0, 6, shape, generator=g)
    args[6][c] = (torch.where(empty, -1, tags).to(torch.int32),
                  torch.where(empty, -1, lru).to(torch.int32))


def _late_stamps(args, kw):
    kw["now0"] = (1 << 32) // 32


def _too_many_entries(args, kw):
    _wider_cache(args, kw, 1, ops.MAX_STAGED_ENTRIES // 64, 65)


@pytest.mark.parametrize("change, msg", [
    (lambda a, kw: _wider_cache(a, kw, 1, 16, 33), None),
    (lambda a, kw: _wider_cache(a, kw, 0, 1, 64), None),
    (lambda a, kw: _wider_cache(a, kw, 2, 2, 4), "one set"),
    (_late_stamps, "32-bit way ranking"),
    (_too_many_entries, "shared memory"),
], ids=["stlb-33-ways", "l1-64-ways", "walk-cache-2-sets", "stamps",
        "staged-entries"])
def test_fast_window_rejects_what_the_kernel_cannot_take(change, msg):
    """The geometry the kernel is built for (the walk caches one set, stamps
    that rank in 32 bits, a thread's caches within the shared memory it
    stages them in) is checked by the wrapper on every device, so the CPU
    route refuses the rest too.  A cache of more than 32 ways is within
    it: the plain route runs it and equals the mirror of the kernel's
    order."""
    mc = cfg.benchmark_machine()
    args, kw = ref.fast_window_inputs(mc, 1, 4, 4, 9)
    change(args, kw)
    if msg is not None:
        with pytest.raises(ValueError, match=msg):
            ops.fast_window(*args, **kw)
        return
    want, _ = ref.fast_window_inputs(mc, 1, 4, 4, 9)
    change(want, kw)
    assert_same([mirror(args, kw)] + flat_state(args),
                [ops.fast_window(*want, **kw)] + flat_state(want), "wide")


def test_lanes_with_their_own_costs_equal_single_runs():
    """``L = 3`` runs, each with its own latency tables and CostConfig's
    four costs, in one call == each run alone (``L = 1``), bitwise."""
    mc = cfg.cxl_machine()
    costs = [(40.0, 10.0, 60.0, 0.6), (55.0, 7.0, 31.0, 0.25),
             (12.0, 30.0, 90.0, 0.9)]
    together, kw = ref.fast_window_inputs(mc, 3, 64, 8, 31, costs=costs,
                                          step_major=True)
    alone, _ = ref.fast_window_inputs(mc, 3, 64, 8, 31, costs=costs,
                                      step_major=True)
    assert not together[0].is_contiguous()
    cum = ops.fast_window(*together, **kw)

    def lane(x, i):
        if isinstance(x, (list, tuple)):
            return [lane(y, i) for y in x]
        return x[i:i + 1]

    cums = [ops.fast_window(*lane(alone, i), **dict(kw, costs=kw["costs"][i:i + 1]))
            for i in range(3)]
    assert_same([cum] + flat_state(together),
                [torch.cat(cums)] + flat_state(alone), "lanes")
    assert not torch.equal(cum[0], cum[1])


# -- the set index without a division -----------------------------------------

def machine_set_counts():
    """Every set count of the repository's machines (the L1 dTLB's and
    the STLB's; the walk caches have one set)."""
    machines = [cfg.MachineConfig(), cfg.benchmark_machine(),
                cfg.cxl_machine(), to_port(tiny_machine())]
    return sorted({1} | {s for mc in machines
                         for s in (mc.l1_tlb_sets, mc.stlb_sets)})


def magic_quotient(n, sets):
    magic, shift = ref.set_magic(sets)
    return (n * np.uint64(magic)) >> np.uint64(shift)


@pytest.mark.parametrize("sets", machine_set_counts())
def test_set_index_is_exact_for_every_tag(sets):
    """Every tag in [0, 2^31).  The magic quotient q(n) = n * magic >>
    shift is nondecreasing, and with magic <= 2^shift it grows by at most
    one from n to n + 1; so it equals n // sets at every n once it does at
    both sides of every multiple of ``sets`` (and at the last tag), which
    is what is checked.  At one set the magic is 2^shift: q(n) = n."""
    magic, shift = ref.set_magic(sets)
    assert 0 < magic < 1 << 32 and magic <= 1 << shift
    if sets == 1:
        assert magic == 1 << shift
        return
    top = (1 << 31) - 1
    step = 1 << 22
    for lo in range(1, top // sets + 1, step):
        q = np.arange(lo, min(lo + step, top // sets + 1), dtype=np.uint64)
        n = q * np.uint64(sets)
        assert np.array_equal(magic_quotient(n, sets), q)
        assert np.array_equal(magic_quotient(n - np.uint64(1), sets),
                              q - np.uint64(1))
    assert int(magic_quotient(np.uint64(top), sets)) == top // sets
    tags = torch.tensor([0, sets - 1, sets, top - 1, top], dtype=torch.int64)
    assert torch.equal(ref.set_index(tags, sets), tags % sets)


@pytest.mark.parametrize("block", range(4))
def test_set_index_on_drawn_tags(block):
    """10^6 drawn tags in [0, 2^31) at every set count in 1..4096 (a
    quarter of the counts per case): the remainder n - q * sets lies in
    [0, sets), which holds only for q = n // sets (a q too large wraps
    the unsigned difference above ``sets``).  Also the bound the proof of
    :func:`ref.set_magic` rests on, ``magic * sets - 2^shift < sets <=
    2^(shift - 31)``, for each count."""
    n = np.random.default_rng(block).integers(0, 1 << 31, 10 ** 6,
                                              dtype=np.uint64)
    q = np.empty(1 << 15, np.uint64)
    rem = np.empty(1 << 15, np.uint64)
    for sets in range(1 + 1024 * block, 1025 + 1024 * block):
        magic, shift = ref.set_magic(sets)
        assert 0 <= magic * sets - (1 << shift) < sets <= 1 << (shift - 31)
        mg, sh, d = np.uint64(magic), np.uint64(shift), np.uint64(sets)
        bad = 0
        for i in range(0, n.size, q.size):
            x = n[i:i + q.size]
            qq, rr = q[:x.size], rem[:x.size]
            np.multiply(x, mg, out=qq)
            np.right_shift(qq, sh, out=qq)
            np.multiply(qq, d, out=rr)
            np.subtract(x, rr, out=rr)
            bad += int(np.count_nonzero(rr >= d))
        assert bad == 0, f"{bad} drawn tags at {sets} sets"
    tags = torch.as_tensor(n[:4096].astype(np.int64))
    sets = 1 + 1024 * block + 1023
    assert torch.equal(ref.set_index(tags, sets), tags % sets)


# -- against JAX ----------------------------------------------------------------

def drawn_state(mc, seed, oom):
    """A port state (host numpy) with drawn placements, caches (tags in
    their sets, a fifth of the ways empty, tied stamps below the step),
    accumulators, counters and hotness counts."""
    rng = np.random.default_rng(seed)
    st = tc.init_state(mc, "cpu").to_numpy().lane(0)
    step = 500
    n_nodes = mc.n_nodes

    def nodes(n):
        return rng.integers(-1, n_nodes, n).astype(np.int32)

    st.data_node, st.leaf_node = nodes(mc.n_map), nodes(mc.n_leaf_pages)
    st.mid_node, st.top_node = nodes(mc.n_mid_pages), nodes(mc.n_top_pages)
    st.access_recent = rng.integers(0, 50, mc.n_map).astype(np.int32)
    st.written_recent = rng.integers(0, 50, mc.n_map).astype(np.int32)
    for tlb, shift in ((st.l1_tlb, 0), (st.stlb, 0), (st.pde_pwc, mc.radix_bits),
                       (st.pdpte_pwc, 2 * mc.radix_bits)):
        T, sets, ways = tlb.tags.shape
        cand = rng.integers(0, max(mc.n_map >> shift, 1), (T, sets, ways))
        tags = cand // sets * sets + np.arange(sets)[:, None]
        empty = rng.random((T, sets, ways)) < 0.2
        tlb.tags = np.where(empty, -1, tags).astype(np.int32)
        tlb.lru = np.where(empty, -1, step - 1 - rng.integers(0, 6, tags.shape)
                           ).astype(np.int32)
    for f in ("total", "walk", "stall", "data_mem", "fault"):
        setattr(st.cycles, f, (rng.random(mc.n_threads) * 1e5).astype(np.float32))
    for f in ("l1_hits", "stlb_hits", "walks", "walk_mem_reads", "faults"):
        setattr(st.counters, f, np.int32(rng.integers(0, 1000)))
    st.oom_killed = np.bool_(oom)
    st.step = np.int32(step)
    return st


def to_jax(obj, like):
    if dataclasses.is_dataclass(like):
        return type(like)(**{f.name: to_jax(getattr(obj, f.name),
                                            getattr(like, f.name))
                             for f in dataclasses.fields(like)})
    return jnp.asarray(obj)


@pytest.mark.parametrize("oom", [False, True])
def test_fast_window_tile_matches_jax(oom):
    """One segment of 40 rows from one drawn state: the port's
    ``fast_window_tile`` against the JAX package's fast window, jitted on
    the CPU, on the same numpy inputs; every state field and every
    timeline key, integers exact and f32 bitwise."""
    jmc = tiny_machine(radix_bits=4)
    mc = to_port(jmc)
    R, T = 40, mc.n_threads
    rng = np.random.default_rng(11)
    va = rng.integers(0, mc.va_pages, (R, T)).astype(np.int32)
    va[rng.random((R, T)) < 0.1] = -1
    va[5:] = np.where(rng.random((R - 5, T)) < 0.6, va[:R - 5], va[5:])
    trace = tc.Trace(va=va, is_write=rng.random((R, T)) < 0.4,
                     free_seg=np.full(R, -1, np.int32),
                     llc=rng.random(R).astype(np.float32),
                     seg_of_map=np.zeros(mc.n_map, np.int32), name="window")
    st = drawn_state(mc, 3, oom)
    jcc = jsim.CostConfig()
    fw = jax.jit(jsim._build_fast_window(jmc))
    jst, out = fw(to_jax(st, jstate.init_state(jmc)), jcc, jnp.asarray(va),
                  jnp.asarray(trace.is_write), jnp.asarray(trace.llc),
                  jnp.ones(R, bool))
    jst, out = jax.device_get((jst, out))

    sim = tc.TieredMemSimulator(mc=mc, pc=tc.linux_default(),
                                cc=to_port(jcc), device="cpu",
                                engine="per_step", debug=True)
    stepper = sim.runner(trace, state=st)
    ops.reset_launches()
    tsim.fast_window_tile(stepper, 0, R)
    stepper.s = R
    stepper.st.step.fill_(int(st.step) + R)
    res = stepper.result()
    for (k, g), (_, w) in zip(tsim_fields(res.final_state), tsim_fields(jst)):
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    for k, w in zip(tsim.TIMELINE_KEYS, out):
        g = res.timeline[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=f"tl/{k}")
    if not oom:
        assert res.timeline["walks"][-1] > res.timeline["walks"][0]
