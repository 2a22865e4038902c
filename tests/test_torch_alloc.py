"""The port's allocator (``core/alloc.py``, and ``ops.alloc_scan``'s plain
version on the CPU) held to the JAX package's ``core/alloc.py`` on the same
random carries: every output exact, in the full-depth scan and in the scan
compacted to the allocating threads (``slot_thread``); and the test mirror
of the CUDA kernel's algorithm (``ref.alloc_scan_speculative_ref``) held to
the plain loop, on drawn inputs and on crafted cases that cross each
predicate inside a chunk."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as jc
from repro.core import alloc as jalloc
import repro_torch.core as tc
from repro_torch.core import alloc as talloc
from repro_torch.kernels import ops, ref

MACHINES = {
    "2-tier": lambda m: m.MachineConfig(n_threads=16),
    "2-tier thp": lambda m: m.MachineConfig(n_threads=16, page_order=9),
    "3-tier": lambda m: m.cxl_machine(n_threads=16),
    "3-tier, empty middle": lambda m: m.MachineConfig(
        n_threads=16, tier_pages_per_node=(600, 0, 2400)),
    "4-tier thp": lambda m: m.MachineConfig(
        n_threads=16, tier_pages_per_node=(600, 900, 0, 2400), page_order=9),
}
DATA = (jc.FIRST_TOUCH, jc.INTERLEAVE)
PT = (jc.PT_FOLLOW_DATA, jc.PT_BIND_ALL, jc.PT_BIND_HIGH)
NAMES = ("nodes", "slow", "ok", "act", "gate", "free", "rec", "ptr", "oom")


def _carry(rng, mc):
    """Free counts near the watermark or near zero (on every node, one
    carry in three), a little reclaimable reserve, so the fast, slow,
    reclaim and failing paths all occur."""
    n = mc.n_nodes
    cap = np.asarray(mc.node_capacity())
    wm = (cap.astype(np.float32) * np.float32(mc.low_watermark)).astype(np.int32)
    near_zero = rng.random(n) < (1.0 if rng.random() < 0.35 else 0.5)
    free = np.where(near_zero, rng.integers(0, 3, n),
                    wm + rng.integers(-3, 4, n))
    free = np.where(cap > 0, np.maximum(free, 0), 0).astype(np.int32)
    rec = np.where(cap > 0, rng.integers(0, 3, n), 0).astype(np.int32)
    return free, rec, np.int32(rng.integers(0, 50)), bool(rng.random() < 0.1)


@pytest.mark.parametrize("machine", sorted(MACHINES))
def test_alloc_one_and_prefs_match_jax(machine):
    rng = np.random.default_rng(len(machine))
    jm, tm = MACHINES[machine](jc), MACHINES[machine](tc)
    thp = jm.page_order > 0
    np.testing.assert_array_equal(np.asarray(jalloc.watermark_pages(jm)),
                                  talloc.watermark_pages(tm, "cpu").numpy())
    for t in range(jm.n_threads):
        tt = torch.tensor(t, dtype=torch.int32)
        for fn in ("first_touch_prefs", "dram_prefs"):
            np.testing.assert_array_equal(
                np.asarray(getattr(jalloc, fn)(jnp.int32(t), jm)),
                getattr(talloc, fn)(tt, tm).numpy())
    for ptr in range(9):
        np.testing.assert_array_equal(
            np.asarray(jalloc.interleave_prefs(jnp.int32(ptr), jm)),
            talloc.interleave_prefs(torch.tensor(ptr, dtype=torch.int32),
                                    tm).numpy())
    wm = jalloc.watermark_pages(jm)
    for trial in range(40):
        free, rec, ptr, _ = _carry(rng, jm)
        t = int(rng.integers(0, jm.n_threads))
        d, p = int(rng.choice(DATA)), int(rng.choice(PT))
        upper = bool(rng.random() < 0.5)
        jd = jalloc.data_prefs_for(d, jnp.int32(t), jm, jnp.int32(ptr))
        td = talloc.data_prefs_for(torch.tensor(d), torch.tensor(t), tm,
                                   torch.tensor(ptr))
        np.testing.assert_array_equal(np.asarray(jd), td.numpy())
        jp, jign = jalloc.pt_prefs_for(p, upper, jnp.int32(t), jm, jd, thp)
        tp, tign = talloc.pt_prefs_for(torch.tensor(p), upper, torch.tensor(t),
                                       tm, td, thp)
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        assert bool(jign) == bool(tign)
        want = jalloc.alloc_one(jnp.asarray(free), jnp.asarray(rec), jp, wm,
                                jign)
        got = talloc.alloc_one(torch.as_tensor(free), torch.as_tensor(rec), tp,
                               torch.as_tensor(np.array(wm)), tign)
        for name, w, g in zip(("node", "slow", "free", "rec", "ok"), want, got):
            np.testing.assert_array_equal(np.asarray(w), g.numpy(),
                                          err_msg=f"trial {trial}: {name}")


def _slots(winners, T):
    G = tc.sim.pow2ceil(max(int(winners.sum()), 1))
    slot = np.cumsum(winners) - 1
    slot_thread = np.full(G, T, np.int64)
    slot_thread[slot[winners]] = np.where(winners)[0]
    return slot_thread


@pytest.mark.parametrize("machine", sorted(MACHINES))
def test_alloc_many_matches_jax_in_both_modes(machine):
    """The full-depth scan and the compacted one, each against the JAX
    package's same mode, on random winner sets and carries; requests come
    only from winners, as in the engine."""
    rng = np.random.default_rng(7 + len(machine))
    jm, tm = MACHINES[machine](jc), MACHINES[machine](tc)
    T = jm.n_threads
    wm = jalloc.watermark_pages(jm)
    twm = torch.as_tensor(np.array(wm))
    # one compile per mode (and per slot count) for every trial
    jax_alloc_many = jax.jit(functools.partial(jalloc.alloc_many, mc=jm))
    seen = dict.fromkeys(("fast", "slow", "failed", "gated"), 0)
    for trial in range(12):
        winners = rng.random(T) < rng.random()
        need_pt = winners[:, None] & (rng.random((T, 4)) < 0.4)
        need_data = winners & (rng.random(T) < 0.9)
        free, rec, ptr, oom = _carry(rng, jm)
        d, p = DATA[trial % 2], PT[trial % 3]
        for compact in (False, True):
            slot_thread = _slots(winners, T) if compact else None
            want = jax_alloc_many(
                jnp.asarray(free), jnp.asarray(rec), jnp.int32(ptr),
                jnp.asarray(oom), wm, d, p, need_pt=jnp.asarray(need_pt),
                need_data=jnp.asarray(need_data),
                slot_thread=None if slot_thread is None
                else jnp.asarray(slot_thread))
            got = talloc.alloc_many(
                torch.as_tensor(free), torch.as_tensor(rec),
                torch.tensor(ptr), torch.tensor(oom), twm, d, p, tm,
                torch.as_tensor(need_pt), torch.as_tensor(need_data),
                slot_thread=None if slot_thread is None
                else torch.as_tensor(slot_thread))
            for name, w, g in zip(NAMES, want, got):
                w = np.asarray(w)
                assert g.dtype == {np.dtype(np.int32): torch.int32,
                                   np.dtype(bool): torch.bool}[w.dtype], name
                np.testing.assert_array_equal(
                    w, g.numpy(), err_msg=f"trial {trial} compact={compact}: "
                                          f"{name}")
        act, ok, slow = (g.numpy() for g in (got[3], got[2], got[1]))
        seen["fast"] += int((act & ok & ~slow).sum())
        seen["slow"] += int((act & ok & slow).sum())
        seen["failed"] += int((act & ~ok).sum())
        seen["gated"] += int((~got[4].numpy()).sum())
    assert all(v > 0 for v in seen.values()), seen


def test_alloc_scan_lanes_are_independent_runs():
    """``ops.alloc_scan`` with L lanes equals L one-lane calls (the lane
    axis that a sweep of policies reuses)."""
    rng = np.random.default_rng(3)
    mc = tc.cxl_machine(n_threads=16)
    L, T, N = 5, mc.n_threads, mc.n_nodes
    carries = [_carry(rng, mc) for _ in range(L)]
    args = (torch.as_tensor(np.stack([c[0] for c in carries])),
            torch.as_tensor(np.stack([c[1] for c in carries])),
            torch.tensor([c[2] for c in carries], dtype=torch.int32),
            torch.tensor([c[3] for c in carries]),
            talloc.watermark_pages(mc, "cpu"),
            torch.tensor([DATA[i % 2] for i in range(L)], dtype=torch.int32),
            torch.tensor([PT[i % 3] for i in range(L)], dtype=torch.int32),
            torch.as_tensor(rng.random((L, T, 4)) < 0.3),
            torch.as_tensor(rng.random((L, T)) < 0.7))
    kw = dict(n_threads=T, alloc_nodes=mc.alloc_nodes, thp=False)
    together = ops.alloc_scan(*args, **kw)
    for lane in range(L):
        one = ops.alloc_scan(*(a if a.dim() == 1 and a.shape[0] == N
                               else a[lane:lane + 1] for a in args), **kw)
        for name, a, b in zip(NAMES, together, one):
            assert torch.equal(a[lane:lane + 1], b), (lane, name)


def test_alloc_scan_rejects_bad_arguments():
    mc = tc.benchmark_machine()
    T = mc.n_threads
    good = [torch.zeros((1, 4), dtype=torch.int32),
            torch.zeros((1, 4), dtype=torch.int32),
            torch.zeros((1,), dtype=torch.int32),
            torch.zeros((1,), dtype=torch.bool),
            torch.zeros((4,), dtype=torch.int32),
            torch.zeros((1,), dtype=torch.int32),
            torch.full((1,), 10, dtype=torch.int32),
            torch.zeros((1, T, 4), dtype=torch.bool),
            torch.zeros((1, T), dtype=torch.bool)]
    kw = dict(n_threads=T, alloc_nodes=(0, 1, 2, 3), thp=False)
    ops.alloc_scan(*good, **kw)
    for i, bad in [(0, torch.zeros((1, 4), dtype=torch.int64)),
                   (3, torch.zeros((1,), dtype=torch.int32)),
                   (4, torch.zeros((3,), dtype=torch.int32)),
                   (7, torch.zeros((1, T, 3), dtype=torch.bool)),
                   (1, torch.zeros((2, 4), dtype=torch.int32))]:
        args = list(good)
        args[i] = bad
        with pytest.raises(ValueError, match="alloc_scan"):
            ops.alloc_scan(*args, **kw)
    for nodes in ((0, 4), (2, 0), (0, 0)):
        with pytest.raises(ValueError, match="allocatable"):
            ops.alloc_scan(*good, **{**kw, "alloc_nodes": nodes})
    with pytest.raises(ValueError, match="slot_thread"):
        ops.alloc_scan(*good, **kw,
                       slot_thread=torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="at most"):
        wide = [torch.zeros((1, 18), dtype=torch.int32)] * 2
        ops.alloc_scan(*wide, *good[2:4], torch.zeros((18,), dtype=torch.int32),
                       *good[5:], **kw)


# -- the kernel's two-pass algorithm (csrc/alloc_scan.cu), mirrored --------

SPEC_MACHINES = [dict(n_threads=32, tier_pages_per_node=(600, 2400)),
                 dict(n_threads=48, tier_pages_per_node=(600, 0, 2400)),
                 dict(n_threads=40, tier_pages_per_node=(600, 900, 0, 2400),
                      page_order=9),
                 dict(n_threads=16, tier_pages_per_node=(600, 2400),
                      page_order=9),
                 dict(n_threads=64, tier_pages_per_node=(600, 2400))]


def _kw(mc):
    return dict(n_threads=mc.n_threads, alloc_nodes=mc.alloc_nodes,
                thp=mc.page_order > 0)


def _mirror(args, mc, slot_thread):
    """The test mirror of the kernel on ``args``: its nine outputs and the
    chunks it replayed."""
    out = ref.alloc_scan_speculative_ref(*args, mc.n_threads, mc.alloc_nodes,
                                         mc.page_order > 0, slot_thread)
    return out[:9], out[9]


def _assert_same(got, want, what):
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), f"{what}: {name}"


@settings(max_examples=40, deadline=None, derandomize=True)
@given(st.data())
def test_alloc_scan_speculative_mirror_matches_plain_loop(data):
    """The mirror of the kernel's algorithm (speculate a chunk of 32
    threads from its entry predicates, verify, replay where a predicate
    fell) == the plain loop on every output, on drawn machines (T = 16 to
    64, so one or two chunks), carries near the thresholds or far from
    them, codes, request masks and slot rows with pads."""
    mc = tc.MachineConfig(**data.draw(st.sampled_from(SPEC_MACHINES)))
    L = data.draw(st.integers(1, 3))
    T, N = mc.n_threads, mc.n_nodes
    cap = np.asarray(mc.node_capacity())
    wm = talloc.watermark_pages(mc, "cpu").numpy()
    kind = data.draw(st.lists(st.sampled_from(["zero", "watermark", "far"]),
                              min_size=L * N, max_size=L * N))
    offset = np.asarray(data.draw(st.lists(st.integers(-3, 12), min_size=L * N,
                                            max_size=L * N))).reshape(L, N)
    base = np.where(np.asarray(kind).reshape(L, N) == "zero", 0,
                    np.where(np.asarray(kind).reshape(L, N) == "watermark",
                             wm, 5000))
    free = np.where(cap > 0, np.maximum(base + offset, 0), 0).astype(np.int32)
    rec = np.where(cap > 0, np.asarray(data.draw(st.lists(
        st.integers(0, 3), min_size=L * N, max_size=L * N))).reshape(L, N),
        0).astype(np.int32)
    codes = data.draw(st.lists(st.tuples(st.sampled_from(DATA),
                                         st.sampled_from(PT)),
                               min_size=L, max_size=L))
    ptr = data.draw(st.lists(st.integers(-(1 << 31), (1 << 31) - 1)
                             | st.integers(-3, 40), min_size=L, max_size=L))
    oom = data.draw(st.lists(st.booleans(), min_size=L, max_size=L))
    p_pt, p_data = data.draw(st.floats(0, 0.5)), data.draw(st.floats(0, 1))
    rng = np.random.default_rng(data.draw(st.integers(0, 1 << 30)))
    args = (torch.as_tensor(free), torch.as_tensor(rec),
            torch.tensor(ptr, dtype=torch.int32), torch.tensor(oom),
            torch.as_tensor(wm), torch.tensor([d for d, _ in codes],
                                              dtype=torch.int32),
            torch.tensor([p for _, p in codes], dtype=torch.int32),
            torch.as_tensor(rng.random((L, T, 4)) < p_pt),
            torch.as_tensor(rng.random((L, T)) < p_data))
    slot_thread = None
    if data.draw(st.booleans()):
        G = data.draw(st.integers(1, T))
        rows = np.full((L, G), T, np.int32)
        for lane in range(L):
            k = int(rng.integers(0, G + 1))
            rows[lane, :k] = np.sort(rng.choice(T, k, replace=False))
        slot_thread = torch.as_tensor(rows)
    want = ops.alloc_scan(*args, **_kw(mc), slot_thread=slot_thread)
    got, _ = _mirror(args, mc, slot_thread)
    _assert_same(got, want, "mirror")


def _jax_alloc_many(machine):
    jm = jc.MachineConfig(**machine)
    return jm, jax.jit(functools.partial(jalloc.alloc_many, mc=jm))


@pytest.mark.parametrize("case", ref.alloc_scan_cases(),
                         ids=lambda c: c["name"])
def test_alloc_scan_crossing_cases(case):
    """Each crafted case (a node falling to its watermark, to 0 free, its
    reserve to 0, a failing request latching OOM mid-chunk, an interleave
    wrap past an empty tier, BHi's fallback, THP, two chunks at T = 48, a
    slot row with pads, and some built to be speculated): the mirror of
    the kernel == the plain loop == JAX's ``alloc_many`` (compacted where
    the case has a slot row), and the mirror replays the chunks the case
    says."""
    mc = tc.MachineConfig(**case["machine"])
    args, slot_thread = case["args"], case["slot_thread"]
    want = ops.alloc_scan(*args, **_kw(mc), slot_thread=slot_thread)
    got, replayed = _mirror(args, mc, slot_thread)
    _assert_same(got, want, "mirror")
    assert replayed == case["replays"]
    jm, jax_alloc_many = _jax_alloc_many(case["machine"])
    j = jax_alloc_many(*(jnp.asarray(a[0].numpy()) for a in args[:4]),
                       jnp.asarray(args[4].numpy()), int(args[5][0]),
                       int(args[6][0]), need_pt=jnp.asarray(args[7][0].numpy()),
                       need_data=jnp.asarray(args[8][0].numpy()),
                       slot_thread=None if slot_thread is None
                       else jnp.asarray(slot_thread[0].numpy()))
    for name, w, g in zip(NAMES, j, want):
        np.testing.assert_array_equal(np.asarray(w), g[0].numpy(),
                                      err_msg=f"JAX: {name}")


def test_alloc_scan_crossing_cases_take_both_paths():
    """Over the crafted cases both paths occur: chunks speculated and
    chunks replayed, with and without a slot row, and every allocation
    outcome (fast, slow, from the reserve, failed, gated)."""
    spec = replayed = 0
    seen = dict.fromkeys(("fast", "slow", "reserve", "failed", "gated"), 0)
    for case in ref.alloc_scan_cases():
        mc = tc.MachineConfig(**case["machine"])
        out, n = _mirror(case["args"], mc, case["slot_thread"])
        chunks = -(-mc.n_threads // ref.WARP)
        spec += chunks - n
        replayed += n
        _, slow, ok, act, gate, _, rec = out[:7]
        seen["reserve"] += int((case["args"][1] - rec).sum())
        seen["fast"] += int((act & ok & ~slow).sum())
        seen["slow"] += int((act & ok & slow).sum())
        seen["failed"] += int((act & ~ok).sum())
        seen["gated"] += int((~gate).sum())
    assert spec > 0 and replayed > 0
    assert all(v > 0 for v in seen.values()), seen


@pytest.mark.parametrize("machine", sorted(MACHINES))
def test_alloc_scan_slot_thread_matches_jax_compacted(machine):
    """``ops.alloc_scan``'s ``slot_thread`` over L runs at once == JAX's
    ``alloc_many`` in its compacted mode, run by run (``jax.jit``), and
    == the mirror of the kernel; requests of threads outside a slot row
    are dropped."""
    rng = np.random.default_rng(11 + len(machine))
    jm, tm = MACHINES[machine](jc), MACHINES[machine](tc)
    T, L = jm.n_threads, 4
    jax_alloc_many = jax.jit(functools.partial(jalloc.alloc_many, mc=jm))
    wm = jalloc.watermark_pages(jm)
    carries = [_carry(rng, jm) for _ in range(L)]
    rows = [_slots(rng.random(T) < 0.6, T) for _ in range(L)]
    slot_thread = np.full((L, max(len(r) for r in rows)), T, np.int32)
    for lane, row in enumerate(rows):
        slot_thread[lane, :len(row)] = row
    # requests everywhere: those of threads outside the row are dropped
    need_pt = rng.random((L, T, 4)) < 0.4
    need_data = rng.random((L, T)) < 0.9
    codes = [(DATA[i % 2], PT[i % 3]) for i in range(L)]
    args = (torch.as_tensor(np.stack([c[0] for c in carries])),
            torch.as_tensor(np.stack([c[1] for c in carries])),
            torch.tensor([c[2] for c in carries], dtype=torch.int32),
            torch.tensor([c[3] for c in carries]),
            torch.as_tensor(np.array(wm)),
            torch.tensor([d for d, _ in codes], dtype=torch.int32),
            torch.tensor([p for _, p in codes], dtype=torch.int32),
            torch.as_tensor(need_pt), torch.as_tensor(need_data))
    got = ops.alloc_scan(*args, **_kw(tm),
                         slot_thread=torch.as_tensor(slot_thread))
    mirror, _ = _mirror(args, tm, torch.as_tensor(slot_thread))
    _assert_same(mirror, got, "mirror")
    for lane in range(L):
        want = jax_alloc_many(
            jnp.asarray(carries[lane][0]), jnp.asarray(carries[lane][1]),
            jnp.int32(carries[lane][2]), jnp.asarray(carries[lane][3]), wm,
            *codes[lane], need_pt=jnp.asarray(need_pt[lane]),
            need_data=jnp.asarray(need_data[lane]),
            slot_thread=jnp.asarray(slot_thread[lane]))
        for name, w, g in zip(NAMES, want, got):
            np.testing.assert_array_equal(np.asarray(w), g[lane].numpy(),
                                          err_msg=f"run {lane}: {name}")
