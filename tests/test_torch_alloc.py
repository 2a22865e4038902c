"""The port's allocator (``core/alloc.py``, and ``ops.alloc_scan``'s plain
version on the CPU) held to the JAX package's ``core/alloc.py`` on the same
random carries: every output exact, in the full-depth scan and in the scan
compacted to the allocating threads (``slot_thread``)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
from repro.core import alloc as jalloc
import repro_torch.core as tc
from repro_torch.core import alloc as talloc
from repro_torch.kernels import ops

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
    with pytest.raises(ValueError, match="allocatable"):
        ops.alloc_scan(*good, **{**kw, "alloc_nodes": (0, 4)})
    with pytest.raises(ValueError, match="at most"):
        wide = [torch.zeros((1, 18), dtype=torch.int32)] * 2
        ops.alloc_scan(*wide, *good[2:4], torch.zeros((18,), dtype=torch.int32),
                       *good[5:], **kw)
