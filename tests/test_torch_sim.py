"""The simulator's host half, TLBs, ``bern`` and the migration scan's
top-B selection in the port, held to the JAX package on the same inputs.

Inputs are made with numpy from a seed and handed to both; every
comparison here is exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
from repro.core import migrate as jmig
from repro.core import ref as jref
from repro.core import sim as jsim
from repro.core import state as jstate
from repro.core import tlbs as jtlbs
import repro_torch.core as tc
from repro_torch.core import migrate as tmig
from repro_torch.core import sim as tsim
from repro_torch.core import tlbs as ttlbs

MACHINES = [
    lambda m: m.MachineConfig(),
    lambda m: m.benchmark_machine(),
    lambda m: m.benchmark_machine(thp=True, n_threads=16),
    lambda m: m.cxl_machine(),
    lambda m: m.cxl_machine(cxl_pages_per_node=0, thp=True),
    lambda m: m.MachineConfig(n_threads=4, dram_pages_per_node=600,
                              nvmm_pages_per_node=2400, va_pages=1 << 12,
                              tier_pages_per_node=(600, 0, 900, 2400)),
]
MACHINE_PROPS = ("tier_capacities", "n_tiers", "n_nodes", "tier_of_node",
                 "alloc_nodes", "map_shift", "n_map", "n_leaf_pages",
                 "n_mid_pages", "n_top_pages", "walk_levels")
PRESETS = ("linux_default", "bind_all", "bhi", "bhi_mig", "tpp", "nomad")


@pytest.mark.parametrize("make", MACHINES)
def test_machine_config_matches_jax(make):
    jm, tm = make(jc), make(tc)
    assert dataclasses.asdict(jm) == dataclasses.asdict(tm)
    for prop in MACHINE_PROPS:
        assert getattr(jm, prop) == getattr(tm, prop), prop
    assert jm.node_capacity() == tm.node_capacity()


def test_policy_and_cost_presets_match_jax():
    assert dataclasses.asdict(jc.CostConfig()) == \
        dataclasses.asdict(tc.CostConfig())
    for name in PRESETS:
        for data_policy in (jc.FIRST_TOUCH, jc.INTERLEAVE):
            jp = getattr(jc, name)(data_policy=data_policy)
            tp = getattr(tc, name)(data_policy=data_policy)
            assert dataclasses.asdict(jp) == dataclasses.asdict(tp), name
            assert jp.label() == tp.label()
    for const in ("FIRST_TOUCH", "INTERLEAVE", "PT_FOLLOW_DATA",
                  "PT_BIND_ALL", "PT_BIND_HIGH", "MIG_AUTONUMA", "MIG_TPP",
                  "MIG_NOMAD"):
        assert getattr(jc, const) == getattr(tc, const)
    # legacy string spellings normalise to the codes, bad ones raise
    kw = dict(data_policy="interleave", pt_policy="bind_high",
              mig_policy="nomad")
    assert dataclasses.asdict(jc.PolicyConfig(**kw)) == \
        dataclasses.asdict(tc.PolicyConfig(**kw))
    for bad in (dict(data_policy="bind_all"), dict(pt_policy=3),
                dict(mig_policy="tpp2")):
        with pytest.raises(ValueError):
            jc.PolicyConfig(**bad)
        with pytest.raises(ValueError):
            tc.PolicyConfig(**bad)


def _small_machine(m):
    return m.MachineConfig(n_threads=8, dram_pages_per_node=600,
                           nvmm_pages_per_node=2400, va_pages=1 << 13,
                           radix_bits=6)


WORKLOADS = sorted(jc.workloads.ALL_WORKLOADS)


@pytest.mark.parametrize("name", WORKLOADS + ["multi_tenant", "padded"])
def test_traces_digests_and_fault_schedules_match_jax(name):
    jm, tm = _small_machine(jc), _small_machine(tc)
    if name == "multi_tenant":
        jt = jc.workloads.multi_tenant(jm, "btree", 1 << 11, 96)
        tt = tc.workloads.multi_tenant(tm, "btree", 1 << 11, 96)
    elif name == "padded":
        jt = jc.TraceSpec("hashjoin", 1 << 11, 64, seed=5, pad_to=600).build(jm)
        tt = tc.TraceSpec("hashjoin", 1 << 11, 64, seed=5, pad_to=600).build(tm)
        assert jc.TraceSpec("hashjoin", 1 << 11, 64).digest(jm) == \
            tc.TraceSpec("hashjoin", 1 << 11, 64).digest(tm)
    else:
        jt = jc.workloads.ALL_WORKLOADS[name](jm, 1 << 11, 96)
        tt = tc.workloads.ALL_WORKLOADS[name](tm, 1 << 11, 96)
    assert jc.trace_digest(jt) == tc.trace_digest(tt)
    assert jt.populate_steps == tt.populate_steps and jt.name == tt.name
    sched = tc.fault_schedule(tt, tm)
    np.testing.assert_array_equal(jc.fault_schedule(jt, jm), sched)
    np.testing.assert_array_equal(jc.fault_step_mask(jt, jm),
                                  tc.fault_step_mask(tt, tm))
    assert jsim.fault_group_bound(sched) == tsim.fault_group_bound(sched)
    for period, start in ((16, 0), (512, 3), (7, 100)):
        np.testing.assert_array_equal(
            jsim.scan_step_mask(tt.n_steps, period, True, start),
            tsim.scan_step_mask(tt.n_steps, period, True, start))
    np.testing.assert_array_equal(
        np.asarray(jsim.seg_of_leaf_table(jt, jm)),
        tsim.seg_of_leaf_table(tt, tm, "cpu").numpy())


def test_pad_trace_and_pow2ceil_match_jax():
    tm = _small_machine(tc)
    tt = tc.workloads.xsbench(tm, 1 << 10, 32)
    jt = jc.Trace(**{f.name: getattr(tt, f.name)
                     for f in dataclasses.fields(tt)})
    assert jc.trace_digest(jc.pad_trace(jt, 500)) == \
        tc.trace_digest(tc.pad_trace(tt, 500))
    assert tc.pad_trace(tt, 10) is tt
    for n, floor in ((0, 1), (1, 1), (5, 1), (64, 1), (65, 8), (3, 16)):
        assert jsim.pow2ceil(n, floor) == tsim.pow2ceil(n, floor)


def _tlb_state(rng, T, sets, ways, tag_hi):
    """Tags and LRU stamps with ties: whole sets empty (-1), repeated
    stamps, and tags present in more than one way is not possible (one
    tag per set), so hits are unique."""
    tags = np.full((T, sets, ways), -1, np.int32)
    lru = np.full((T, sets, ways), -1, np.int32)
    for t in range(T):
        for s in range(sets):
            n = rng.integers(0, ways + 1)
            pool = np.arange(s, tag_hi, sets)
            chosen = rng.choice(pool, size=min(n, len(pool)), replace=False)
            slots = rng.choice(ways, size=len(chosen), replace=False)
            tags[t, s, slots] = chosen
            lru[t, s, slots] = rng.integers(0, 4, len(chosen))   # ties
    return tags, lru


@pytest.mark.parametrize("sets,ways", [(4, 2), (8, 4), (1, 4), (1, 2), (16, 4)])
def test_tlb_lookup_and_update_break_ties_as_jax(sets, ways):
    rng = np.random.default_rng(sets * 10 + ways)
    T, tag_hi = 6, 64
    for trial in range(20):
        tags, lru = _tlb_state(rng, T, sets, ways, tag_hi)
        tag = rng.integers(0, tag_hi, T).astype(np.int32)
        active = rng.random(T) < 0.7
        now = int(rng.integers(0, 5))
        jt = jtlbs.TlbArray(tags=jnp.asarray(tags), lru=jnp.asarray(lru))
        tt = ttlbs.TlbArray(tags=torch.as_tensor(tags.copy()),
                            lru=torch.as_tensor(lru.copy()))
        jhit, jway = jtlbs.lookup(jt, jnp.asarray(tag))
        thit, tway = ttlbs.lookup(tt, torch.as_tensor(tag))
        np.testing.assert_array_equal(np.asarray(jhit), thit.numpy())
        np.testing.assert_array_equal(np.asarray(jway), tway.numpy())
        ju = jtlbs.update(jt, jnp.asarray(tag), jway, now, jnp.asarray(active))
        ttlbs.update(tt, torch.as_tensor(tag), tway, now,
                     torch.as_tensor(active))
        np.testing.assert_array_equal(np.asarray(ju.tags), tt.tags.numpy())
        np.testing.assert_array_equal(np.asarray(ju.lru), tt.lru.numpy())
        # the shootdowns of frees and migrations
        flushed = rng.random(tag_hi >> 1) < 0.3
        ji = jtlbs.invalidate_matching(ju, jnp.asarray(flushed), 1)
        ttlbs.invalidate_matching(tt, torch.as_tensor(flushed), 1)
        np.testing.assert_array_equal(np.asarray(ji.tags), tt.tags.numpy())
        np.testing.assert_array_equal(np.asarray(ji.lru), tt.lru.numpy())


@pytest.mark.parametrize("sets,ways", [(4, 2), (1, 4), (16, 4)])
def test_tlb_update_one_and_lookup_one_match_jax(sets, ways):
    """The sequential fault path's one-thread hit test and touch-or-insert
    (ties by index: the first matching way, else the first of least lru)."""
    rng = np.random.default_rng(100 + sets * 10 + ways)
    T, tag_hi = 5, 64
    for trial in range(20):
        tags, lru = _tlb_state(rng, T, sets, ways, tag_hi)
        jt = jtlbs.TlbArray(tags=jnp.asarray(tags), lru=jnp.asarray(lru))
        tt = ttlbs.TlbArray(tags=torch.as_tensor(tags.copy()),
                            lru=torch.as_tensor(lru.copy()))
        for _ in range(4):
            t = int(rng.integers(0, T))
            tag = int(rng.integers(0, tag_hi))
            active = bool(rng.random() < 0.7)
            now = int(rng.integers(0, 5))
            assert bool(jtlbs.lookup_one(jt, t, jnp.int32(tag))) == bool(
                ttlbs.lookup_one(tt, t, torch.tensor(tag, dtype=torch.int32)))
            jt = jtlbs.update_one(jt, t, jnp.int32(tag), now,
                                  jnp.asarray(active))
            ttlbs.update_one(tt, t, torch.tensor(tag, dtype=torch.int32), now,
                             torch.tensor(active))
            np.testing.assert_array_equal(np.asarray(jt.tags), tt.tags.numpy())
            np.testing.assert_array_equal(np.asarray(jt.lru), tt.lru.numpy())


def test_tlb_victim_is_the_first_empty_then_oldest_way():
    """An all-empty set picks way 0; equal stamps pick the lowest way."""
    tags = torch.tensor([[[-1, -1, -1]], [[5, 7, 9]], [[5, -1, 9]]],
                        dtype=torch.int32)
    lru = torch.tensor([[[-1, -1, -1]], [[3, 2, 2]], [[1, -1, 0]]],
                       dtype=torch.int32)
    hit, way = ttlbs.lookup(ttlbs.TlbArray(tags, lru),
                            torch.tensor([4, 8, 9], dtype=torch.int32))
    assert hit.tolist() == [False, False, True]
    assert way.tolist() == [0, 1, 2]


BERN_KEYS = [0, 1, 7, 2 ** 16 - 1, 2 ** 16, 2 ** 31 - 1, 2 ** 31,
             2 ** 31 + 12345, 2 ** 32 - 1]


@pytest.mark.parametrize("site", [0, 1, 4, 9])
def test_bern_is_bit_for_bit_jax_and_oracle(site):
    rng = np.random.default_rng(site)
    n = 512
    keys = [np.concatenate([np.array(BERN_KEYS, np.uint32),
                            rng.integers(0, 2 ** 32, n - len(BERN_KEYS),
                                         dtype=np.uint32)])
            for _ in range(3)]
    for p in (0.0, 0.3, 0.35, 0.45, 0.5, 0.999, 1.0):
        want = np.asarray(jsim.bern(p, site, *(jnp.asarray(k) for k in keys)))
        got = tsim.bern(p, site, *(torch.as_tensor(k.astype(np.int64))
                                   for k in keys))
        np.testing.assert_array_equal(want, got.numpy())
        # a threshold given as a tensor, as the reference's traced p
        got_t = tsim.bern(torch.tensor(p), site,
                          *(torch.as_tensor(k.astype(np.int64)) for k in keys))
        np.testing.assert_array_equal(want, got_t.numpy())
        oracle = [jref.bern(p, site, *(int(k[i]) for k in keys))
                  for i in range(0, n, 7)]
        assert got[::7].tolist() == oracle
    # int32 keys past 2^31 (negative as int32) read as uint32, as in JAX
    k32 = keys[0].view(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jsim.bern(0.4, site, jnp.asarray(k32), 3)),
        tsim.bern(0.4, site, torch.as_tensor(k32), 3).numpy())


@pytest.mark.parametrize("n,B", [(256, 32), (1000, 64), (4096, 256), (17, 17),
                                 (300, 1)])
def test_top_k_ranked_matches_jax_index_for_index(n, B):
    """Hot and cold keys as the scan makes them: counts with ties in
    the count (broken by index), and many -1 keys (invalid), which top_k
    takes lowest index first when too few are valid."""
    rng = np.random.default_rng(n + B)
    idx_bits = max(n - 1, 1).bit_length()
    for frac_valid in (0.0, 0.02, 0.3, 1.0):
        count = rng.integers(0, 300, n).astype(np.int32)
        valid = rng.random(n) < frac_valid
        count = np.where(valid, np.maximum(count, 1), 0).astype(np.int32)
        jkey = jnp.where(jnp.asarray(count) > 0,
                         jmig._rank_key(jnp.asarray(count), idx_bits), -1)
        tkey = torch.where(torch.as_tensor(count) > 0,
                           tmig._rank_key(torch.as_tensor(count), idx_bits), -1)
        np.testing.assert_array_equal(np.asarray(jkey), tkey.numpy())
        want = np.asarray(jmig._top_k_ranked(jkey, B, idx_bits))
        got = tmig._top_k_ranked(tkey, B, idx_bits).numpy()
        np.testing.assert_array_equal(want, got)
        np.testing.assert_array_equal(
            want, np.asarray(jnp.argsort(-jkey, stable=True)[:B]))


def test_split_two_matches_jax():
    for n, a, b in [(0, 5, 3), (4, 5, 3), (8, 5, 3), (8, 3, 5), (3, 3, 3),
                    (2, 0, 0), (9, -1, 10)]:
        want = jmig._split_two(jnp.int32(n), jnp.int32(a), jnp.int32(b))
        got = tmig._split_two(*(torch.tensor(v, dtype=torch.int32)
                                for v in (n, a, b)))
        assert int(want) == int(got)


def test_tier_latencies_match_jax():
    cc_j, cc_t = jc.CostConfig(), tc.CostConfig()
    for make in MACHINES:
        jm, tm = make(jc), make(tc)
        np.testing.assert_array_equal(np.asarray(jmig.tier_ext(jm)),
                                      tmig.tier_ext(tm, "cpu").numpy())
        np.testing.assert_array_equal(np.asarray(jmig.tier_read_lat(cc_j, jm)),
                                      tmig.tier_read_lat(cc_t, tm, "cpu").numpy())
        np.testing.assert_array_equal(
            np.asarray(jmig.tier_write_lat(cc_j, jm)),
            tmig.tier_write_lat(cc_t, tm, "cpu").numpy())
        nodes = jnp.arange(-1, jm.n_nodes)
        rd, wr, tier = tmig.node_tables(cc_t, tm, "cpu")
        np.testing.assert_array_equal(
            np.asarray(jmig._read_lat(cc_j, jm, nodes)), rd.numpy())
        np.testing.assert_array_equal(
            np.asarray(jmig._write_lat(cc_j, jm, nodes)), wr.numpy())
        np.testing.assert_array_equal(np.asarray(jmig.tier_ext(jm)),
                                      tier.numpy())


def test_init_state_matches_jax():
    for make in MACHINES[:5]:
        jm, tm = make(jc), make(tc)
        want = jax.device_get(jstate.init_state(jm))
        # the port's state has a lane axis: L = 1 by default, and each of
        # L = 3 lanes is the reference's empty machine
        for lanes in (1, 3):
            kw = {} if lanes == 1 else dict(lanes=lanes)
            got = tc.init_state(tm, device="cpu", **kw).to_numpy()
            for lane in range(lanes):
                for (name, x), (_, y) in zip(fields(want),
                                             fields(got.lane(lane))):
                    assert (x.dtype, x.shape) == (y.dtype, y.shape), name
                    np.testing.assert_array_equal(x, y, err_msg=name)
    a = np.array([-1, 0, 1, 2, 5, 3], np.int32)
    b = np.array([3, 1, 4, 0, 2, 1], np.int32)
    np.testing.assert_array_equal(np.asarray(jstate.is_dram(jnp.asarray(a))),
                                  tc.is_dram(torch.as_tensor(a)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jstate.same_tier(jnp.asarray(a), jnp.asarray(b))),
        tc.same_tier(torch.as_tensor(a), torch.as_tensor(b)).numpy())


def fields(state, prefix=""):
    """(name, numpy array) of every field of a state, nested ones too."""
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            yield from fields(v, prefix + f.name + ".")
        else:
            yield prefix + f.name, np.asarray(v)


def test_core_exports_the_jax_core_less_the_sweeps():
    # the sweeps are ported; the lane mesh is left out (one device)
    not_yet = {"lane_mesh"}
    assert set(tc.__all__) == set(jc.__all__) - not_yet
    assert all(hasattr(tc, name) for name in tc.__all__)


@pytest.mark.parametrize("L", [1, 3])
def test_lane_take_and_add_at_match_jax(L):
    """``migrate.lane_take`` / ``lane_add_at`` (one lane through the int32
    index, more through an int64 copy) == the per-lane gather and
    scatter-add of a vmapped JAX step, repeated indices included."""
    rng = np.random.default_rng(L)
    n, T = 50, 8
    arr = rng.integers(-3, 9, (L, n)).astype(np.int32)
    idx = rng.integers(0, n, (L, T, 2)).astype(np.int32)
    idx[:, 1] = idx[:, 0]                       # collisions in each lane
    vals = rng.integers(0, 4, (L, T, 2)).astype(np.int32)
    want_take = jax.vmap(lambda a, i: a[i])(jnp.asarray(arr),
                                            jnp.asarray(idx))
    want_add = jax.vmap(lambda a, i, v: a.at[i].add(v))(
        jnp.asarray(arr), jnp.asarray(idx), jnp.asarray(vals))
    got_take = tmig.lane_take(torch.as_tensor(arr), torch.as_tensor(idx))
    out = torch.as_tensor(arr.copy())
    got_add = tmig.lane_add_at(out, torch.as_tensor(idx),
                               torch.as_tensor(vals))
    assert got_add is out
    assert got_take.dtype == torch.int32 and got_take.shape == idx.shape
    np.testing.assert_array_equal(got_take.numpy(), np.asarray(want_take))
    np.testing.assert_array_equal(got_add.numpy(), np.asarray(want_add))
