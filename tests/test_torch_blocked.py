"""The port's time-blocked engine (``repro_torch.core.TieredMemSimulator``,
``engine="blocked"``, the default) on the CPU, on the cases of
tests/test_blocked.py: bitwise equal to the port's per-step engine (every
state field and every timeline key, f32 cycles included), and equal to
the JAX package's blocked engine (integers and flags exact, f32 to
``rtol=1e-5``).  The fast window's tile (``sim.fast_window_tile``, whose
scan is ``ops.fast_window``'s plain version on the CPU) is also held
directly against the per-step engine's ``phase_a`` row loop.
"""
import functools

import numpy as np
import pytest

import repro.core as jc
from repro.core.ref import OracleSim
import repro_torch.core as tc
from repro_torch.core import sim as tsim
from repro_torch.kernels import ops

from test_blocked import (POLICIES, fault_heavy_trace, make_trace,
                          steady_trace, tiny_machine)
from test_ntier import CYCLE_KEYS, EXACT_KEYS
from test_torch_engine import to_port, tsim_fields
from test_torch_engine_jax import assert_same_run
from test_torch_engine import fresh_jax_caches  # noqa: F401 (autouse)


def port_blocked(mc, pc, block=16, **kw):
    return tc.TieredMemSimulator(mc=to_port(mc), pc=to_port(pc), block=block,
                                 device="cpu", debug=True, **kw)


def port_per_step(mc, pc, **kw):
    return tc.TieredMemSimulator(mc=to_port(mc), pc=to_port(pc), device="cpu",
                                 engine="per_step", debug=True, **kw)


def assert_bitwise(a, b, label):
    """Two port runs: every state field and timeline key, bit for bit."""
    for (k, x), (_, y) in zip(tsim_fields(a.final_state),
                              tsim_fields(b.final_state)):
        assert x.dtype == y.dtype and x.shape == y.shape, f"{label}: {k}"
        np.testing.assert_array_equal(x, y, err_msg=f"{label}: {k}")
    assert a.timeline.keys() == b.timeline.keys()
    for k in a.timeline:
        assert a.timeline[k].dtype == b.timeline[k].dtype, f"{label}: tl/{k}"
        np.testing.assert_array_equal(a.timeline[k], b.timeline[k],
                                      err_msg=f"{label}: tl/{k}")


def check_case(mc, pc, trace, block=16, want=None, **kw):
    """The port's blocked run == its per-step run, bitwise, and == JAX's
    blocked run (``want``, else a fresh one with the batched fault path:
    JAX's two fault paths agree); returns the port's blocked result."""
    blk = port_blocked(mc, pc, block, **kw).run(to_port(trace))
    ps = port_per_step(mc, pc, **kw).run(to_port(trace))
    assert_bitwise(blk, ps, f"{pc.label()}: blocked vs per-step")
    for k in blk.timeline:
        assert blk.timeline[k].shape == (trace.n_steps,)
    if want is None:
        want = jc.TieredMemSimulator(mc=mc, pc=pc, block=block).run(trace)
    assert_same_run(want, blk, f"{pc.label()}: port blocked vs JAX")
    return blk


@functools.lru_cache(maxsize=1)
def steady_case():
    """The steady-state case and JAX's blocked runs of its four policies
    (one lane each of a blocked sweep, which the reference holds equal to
    its solo blocked runs bit for bit: one compile for the four)."""
    mc = tiny_machine()
    trace = steady_trace(mc, steps=200, seed=3)
    return mc, trace, jc.sweep(mc, jc.CostConfig(), POLICIES, trace, block=16)


@pytest.mark.parametrize("policy", range(len(POLICIES)))
def test_steady_state_trace_bitwise(policy):
    """Long fault-free stretches become fast windows (several per trace,
    forced by a small block)."""
    mc, trace, want = steady_case()
    pc = POLICIES[policy]
    runner = port_blocked(mc, pc).runner(to_port(trace))
    assert runner.plan.counts[tsim.WIN_FAST] + \
        runner.plan.counts[tsim.WIN_HOIST] > 0
    check_case(mc, pc, trace, want=want[policy])


@pytest.mark.parametrize("phase_b", ["batched", "sequential"])
def test_fault_heavy_and_free_bitwise(phase_b):
    """Faults and a mid-run segment free everywhere: nearly every window
    replays step by step, through either fault path."""
    mc = tiny_machine()
    trace = fault_heavy_trace(mc, steps=96, seed=5, free_at=60)
    for pc in POLICIES[:2]:
        check_case(mc, pc, trace, phase_b=phase_b)


def test_thp_machine_bitwise():
    mc = tiny_machine(page_order=9)
    trace = steady_trace(mc, steps=160, seed=51)
    for pc in POLICIES[:2]:
        check_case(mc, pc, trace)


def test_oom_trace_bitwise():
    """The OOM latch makes every later row inactive; the fast windows after
    it stay inert exactly as the per-step engine's steps do."""
    mc = tiny_machine(dram_pages_per_node=150, nvmm_pages_per_node=1600,
                      va_pages=1 << 11, radix_bits=4)
    T = mc.n_threads
    s = np.arange(160, dtype=np.int32)[:, None]
    t = np.arange(T, dtype=np.int32)[None, :]
    va = np.minimum(s * T + t, mc.va_pages - 1).astype(np.int32)
    va[100:] = va[:60]                       # re-touch: fast windows
    trace = make_trace(mc, va)
    for ptp in (jc.PT_FOLLOW_DATA, jc.PT_BIND_ALL):
        pc = jc.PolicyConfig(data_policy=jc.FIRST_TOUCH, pt_policy=ptp,
                             autonuma=False)
        res = check_case(mc, pc, trace)
        if ptp == jc.PT_BIND_ALL:
            assert res.summary()["oom_killed"]


def test_resume_mid_block():
    """A trace split inside what the whole run tiles as one fast window:
    the chained blocked runs equal the unsplit per-step run bit for bit,
    and JAX's unsplit blocked run (which the reference holds equal to its
    chained runs)."""
    mc, trace, sweep = steady_case()
    pc = POLICIES[0]
    full = port_per_step(mc, pc).run(to_port(trace))
    cut = 75                      # not a multiple of any pow2 block size

    def part(sl):
        return jc.Trace(va=trace.va[sl], is_write=trace.is_write[sl],
                        free_seg=trace.free_seg[sl], llc=trace.llc[sl],
                        seg_of_map=trace.seg_of_map)

    first, second = part(slice(None, cut)), part(slice(cut, None))
    sim = port_blocked(mc, pc)
    mid = sim.run(to_port(first))
    res = sim.run(to_port(second), state=mid.final_state)
    for (k, x), (_, y) in zip(tsim_fields(res.final_state),
                              tsim_fields(full.final_state)):
        np.testing.assert_array_equal(x, y, err_msg=f"resume: {k}")
    for k in full.timeline:
        np.testing.assert_array_equal(
            np.concatenate([mid.timeline[k], res.timeline[k]]),
            full.timeline[k], err_msg=f"resume: tl/{k}")
    want = sweep[0]
    res.timeline = {k: np.concatenate([mid.timeline[k], v])
                    for k, v in res.timeline.items()}
    res.trace_name = want.trace_name
    assert_same_run(want, res, "resumed, port blocked vs JAX")


def wide_cache_machine():
    """A 4-thread radix-6 machine whose L1 dTLB, STLB and both walk caches
    have more than 32 ways (the fast-window kernel folds a lane's ways
    lane, lane + 32, ... into its key)."""
    return jc.MachineConfig(n_threads=4, dram_pages_per_node=600,
                            nvmm_pages_per_node=2400, va_pages=1 << 12,
                            radix_bits=6, l1_tlb_sets=1, l1_tlb_ways=40,
                            stlb_sets=2, stlb_ways=48, pde_pwc_entries=64,
                            pdpte_pwc_entries=40)


def test_wide_cache_machine_bitwise():
    """Caches of more than 32 ways run on the default engine: the port's
    blocked run == its per-step run bitwise, == JAX's blocked engine, and
    == ``OracleSim`` (the summary keys)."""
    mc = wide_cache_machine()
    pc = jc.linux_default()
    trace = jc.workloads.kv_store(mc, 1 << 10, run_steps=256, seed=1)
    res = check_case(mc, pc, trace)
    runner = port_blocked(mc, pc).runner(to_port(trace))
    assert runner.fast_segments > 0
    oracle = OracleSim(mc, jc.CostConfig(), pc)
    oracle.run(trace)
    ref, got = oracle.summary(), res.summary()
    for k in EXACT_KEYS:
        assert got[k] == ref[k], f"{k}: port={got[k]} oracle={ref[k]}"
    for k in CYCLE_KEYS:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    assert got["stlb_hits"] > 0 and got["walks"] > 0


def test_window_tiling_shape_independence():
    """The window count comes from the step count alone, every step is
    emitted once, and the runner's segments cover every step once, in
    order."""
    mc = tiny_machine()
    pc = to_port(POLICIES[0])
    for trace in (steady_trace(mc, steps=100, seed=1),
                  fault_heavy_trace(mc, steps=100, seed=2)):
        xs, plan = tsim.blocked_xs(to_port(trace), to_port(mc), pc, block=16,
                                   device="cpu")
        assert xs[0].shape[0] == plan.n_windows == 7       # ceil(100 / 16)
        assert int(plan.emit_valid.sum()) == 100
        runner = port_blocked(mc, POLICIES[0]).runner(to_port(trace))
        steps = [s for win in runner.ops for op, a, b in win if op != "scan"
                 for s in range(a, b)]
        assert steps == list(range(100))
    none = np.zeros(100, bool)
    p1 = tsim.plan_windows(none, none, np.eye(1, 100, 19, dtype=bool)[0],
                           100, 16)
    p2 = tsim.plan_windows(none, none, np.eye(1, 100, 20, dtype=bool)[0],
                           100, 16)
    assert p1.geom == p2.geom and p1.emit_valid.shape == p2.emit_valid.shape


@pytest.fixture
def fast_window_calls(monkeypatch):
    """The rows of every ``ops.fast_window`` call (the CPU route counts no
    launches, so the calls are counted here)."""
    rows = []
    kernel = ops.fast_window

    def counted(m, *args, **kwargs):
        rows.append(m.shape[1])
        return kernel(m, *args, **kwargs)

    monkeypatch.setattr(ops, "fast_window", counted)
    return rows


def test_fast_window_tile_matches_phase_a_rows(fast_window_calls):
    """``fast_window_tile`` over an event-free stretch (its scan through
    ``ops.fast_window``, the plain version here) == the per-step engine's
    ``phase_a`` and timeline row, step by step, from the same state: every
    state field and timeline row bitwise; one launch per segment."""
    mc = to_port(tiny_machine())
    trace = to_port(steady_trace(tiny_machine(), steps=200, seed=3))
    pc = to_port(POLICIES[2])                         # no scan ticks
    sim = tc.TieredMemSimulator(mc=mc, pc=pc, device="cpu", engine="per_step",
                                debug=True)
    a, b = sim.runner(trace), sim.runner(trace)
    has_fault = tsim.fault_step_mask(trace, mc)
    s0 = int(np.flatnonzero(has_fault)[-1]) + 1       # after the last fault
    a.advance(s0)
    b.advance(s0)
    for lo, hi in ((s0, s0 + 1), (s0 + 1, s0 + 40), (s0 + 40, 200)):
        tsim.fast_window_tile(a, lo, hi)
    assert fast_window_calls == [1, 39, 160 - s0]
    for s in range(s0, 200):
        b.phase_a(s, b.start + s)
        b._record(s)
    a.s = b.s = 200
    ra, rb = a.result(), b.result()
    assert_bitwise(ra, rb, "fast_window_tile vs phase_a")


def test_advance_by_windows_equals_one_run(fast_window_calls):
    """``advance`` by windows in pieces equals one run, the kernel is
    launched once per fast segment of the plan, and a run resumed from a
    final state (host numpy) carries its step on."""
    mc = tiny_machine()
    pc = POLICIES[1]
    trace = to_port(steady_trace(mc, steps=150, seed=7))
    sim = port_blocked(mc, pc)
    whole = sim.run(trace)
    runner = sim.runner(trace)
    fast_window_calls.clear()
    for n in (1, 3, 100):
        runner.advance(n)
    assert len(fast_window_calls) == runner.fast_segments > 0
    assert runner.w == runner.plan.n_windows
    assert_bitwise(whole, runner.result(), "windows in pieces")
    assert int(runner.result().final_state.step) == trace.n_steps
    again = sim.run(trace, state=whole.final_state)
    assert int(again.final_state.step) == 2 * trace.n_steps
