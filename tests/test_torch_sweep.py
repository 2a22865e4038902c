"""The port's sweeps (``repro_torch.core.sweep`` / ``sweep_lanes``) on the
CPU, on the cases of tests/test_sweep.py and the sweep cases of
tests/test_blocked.py, tests/test_fault_batch.py and
tests/test_split_windows.py, at their sizes.  Every lane must equal:

* the port's solo run of that lane (``TieredMemSimulator``), bit for bit:
  every state field and every timeline key, f32 cycles included (a solo
  run is the one-lane case of the same engine);
* the JAX package's sweep lane: integers and flags exact, f32 to
  ``rtol=1e-5`` (``assert_same_run``);
* ``OracleSim`` where the reference checks it (``EXACT_KEYS`` exact,
  ``CYCLE_KEYS`` to ``rtol=1e-5``).

Also: per-lane ``CostConfig``s, the ``budget`` / ``group`` overrides, the
``debug`` gate, ``lane_sharding`` ("auto" on one device, an unknown
one refused) and ``compile_count``.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as jc
import repro_torch.core as tc

from test_blocked import fault_heavy_trace
from test_blocked import tiny_machine as blocked_machine
from test_fault_batch import conflict_trace
from test_split_windows import make_trace as split_trace
from test_split_windows import tiny_machine as split_machine
from test_sweep import (POLICIES, assert_lane_matches_oracle, random_trace,
                        sequential_trace, tiny_machine)
from test_torch_blocked import assert_bitwise
from test_torch_engine import to_port
from test_torch_engine_jax import assert_same_run
from test_torch_engine import fresh_jax_caches  # noqa: F401 (autouse)


def port(obj):
    """The port's twin of a JAX config or trace, or of a list of them."""
    if isinstance(obj, (list, tuple)):
        return [port(x) for x in obj]
    return to_port(obj)


def port_sweep(mc, cc, policies, traces, **kw):
    """``repro_torch.core.sweep`` on the CPU with the port's twins."""
    cc = port(cc)
    traces = port(traces) if isinstance(traces, (list, tuple)) else port(traces)
    return tc.sweep(port(mc), cc, port(policies), traces, device="cpu", **kw)


def port_solo(mc, cc, pc, trace, **kw):
    return tc.TieredMemSimulator(mc=port(mc), cc=port(cc), pc=port(pc),
                                 device="cpu", **kw).run(port(trace))


def check_lanes(mc, ccs, policies, traces, got, want=None, oracle=False,
                **solo_kw):
    """Each lane of ``got`` (the port's sweep lanes, in lane order) ==
    its solo port run bitwise, == ``want[i]`` (the JAX sweep lane), and
    == ``OracleSim`` if asked."""
    for i, (cc, pc, trace) in enumerate(zip(ccs, policies, traces)):
        res = got[i]
        assert res.trace_name == trace.name
        assert_bitwise(res, port_solo(mc, cc, pc, trace, **solo_kw),
                       f"lane {i} {pc.label()}: sweep vs solo")
        if want is not None:
            assert_same_run(want[i], res, f"lane {i} {pc.label()}: vs JAX")
        if oracle:
            assert_lane_matches_oracle(res, mc, cc, pc, trace)


# -- the twins of tests/test_sweep.py ------------------------------------------

def test_sweep_matches_sequential_and_oracle():
    """One batched sweep == 4 solo runs == JAX's sweep == 4 oracle runs."""
    mc, cc = tiny_machine(), jc.CostConfig()
    trace = random_trace(mc, seed=3, free_at=100)
    batch = port_sweep(mc, cc, POLICIES, trace)
    assert len(batch) == len(POLICIES)
    want = jc.sweep(mc, cc, POLICIES, trace)
    n = len(POLICIES)
    check_lanes(mc, [cc] * n, POLICIES, [trace] * n, batch, want, oracle=True)


def test_sweep_single_compile_per_trace_shape():
    """The reference's accounting: a >= 4-policy sweep is one signature,
    re-sweeping the same shape (other policies, other trace data) adds
    none, 96 and 128 steps tile to the same two windows, and a window
    count not seen before in this module adds exactly one."""
    mc, cc = tiny_machine(), jc.CostConfig()
    before = tc.sweep_compile_count()
    port_sweep(mc, cc, POLICIES, random_trace(mc, seed=11, steps=96))
    after_first = tc.sweep_compile_count()
    assert after_first == before + 1
    port_sweep(mc, cc, list(reversed(POLICIES)),
               random_trace(mc, seed=12, steps=96))
    assert tc.sweep_compile_count() == after_first
    port_sweep(mc, cc, POLICIES, random_trace(mc, seed=13, steps=128))
    assert tc.sweep_compile_count() == after_first
    port_sweep(mc, cc, POLICIES, random_trace(mc, seed=14, steps=320))
    assert tc.sweep_compile_count() == after_first + 1


def test_sweep_multi_trace_grid():
    """Policies x padded traces in one run, a mid-run free in one trace."""
    mc, cc = tiny_machine(), jc.CostConfig()
    policies = POLICIES[:2]
    traces = [random_trace(mc, seed=21, steps=120, name="a"),
              random_trace(mc, seed=22, steps=96, free_at=60, name="b")]
    steps = max(t.n_steps for t in traces)
    traces = [jc.pad_trace(t, steps) for t in traces]
    grid = port_sweep(mc, cc, policies, traces)
    want = jc.sweep(mc, cc, policies, traces)
    assert len(grid) == len(traces) and len(grid[0]) == len(policies)
    for j, trace in enumerate(traces):
        check_lanes(mc, [cc] * 2, policies, [trace] * 2, grid[j], want[j])


def test_sweep_bind_all_oom_lane():
    """An OOM-ing bind-all lane must not perturb its sweep neighbours."""
    mc = jc.MachineConfig(n_threads=4, dram_pages_per_node=150,
                          nvmm_pages_per_node=1600, va_pages=1 << 11,
                          radix_bits=4, l1_tlb_sets=4, l1_tlb_ways=2,
                          stlb_sets=8, stlb_ways=4, pde_pwc_entries=4,
                          pdpte_pwc_entries=2)
    cc = jc.CostConfig()
    policies = [jc.PolicyConfig(data_policy=jc.FIRST_TOUCH, pt_policy=p,
                                autonuma=False)
                for p in (jc.PT_FOLLOW_DATA, jc.PT_BIND_ALL, jc.PT_BIND_HIGH)]
    trace = sequential_trace(mc, steps=256)
    batch = port_sweep(mc, cc, policies, trace)
    assert batch[1].summary()["oom_killed"]
    assert not batch[0].summary()["oom_killed"]
    want = jc.sweep(mc, cc, policies, trace)
    check_lanes(mc, [cc] * 3, policies, [trace] * 3, batch, want, oracle=True)


def test_sweep_thp_machine():
    """fig13's setting: THP machine (3-level walks, PMD leaves)."""
    mc = tiny_machine()
    mc = dataclasses.replace(mc, page_order=9)
    cc = jc.CostConfig()
    policies = POLICIES[:2]
    trace = random_trace(mc, seed=51)
    batch = port_sweep(mc, cc, policies, trace)
    want = jc.sweep(mc, cc, policies, trace)
    check_lanes(mc, [cc] * 2, policies, [trace] * 2, batch, want, oracle=True)


def test_sweep_rejects_mixed_periods_and_shapes():
    mc, cc = tiny_machine(), jc.CostConfig()
    tr = random_trace(mc, seed=41, steps=64)
    mixed = [jc.PolicyConfig(autonuma=True, autonuma_period=16),
             jc.PolicyConfig(autonuma=True, autonuma_period=32)]
    with pytest.raises(ValueError, match="autonuma_period"):
        port_sweep(mc, cc, mixed, tr)
    with pytest.raises(ValueError, match="shape"):
        port_sweep(mc, cc, POLICIES, [tr, random_trace(mc, seed=42, steps=65)])
    with pytest.raises(ValueError, match="threads"):
        tc.sweep(tc.MachineConfig(n_threads=8), tc.CostConfig(),
                 [tc.PolicyConfig()], port(tr), device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        tc.sweep(port(mc), tc.CostConfig(), [], port(tr), device="cpu")


def test_policy_config_rejects_bad_codes():
    with pytest.raises(ValueError, match="data_policy"):
        tc.PolicyConfig(data_policy=tc.PT_FOLLOW_DATA)
    with pytest.raises(ValueError, match="pt_policy"):
        tc.PolicyConfig(pt_policy=99)
    with pytest.raises(ValueError, match="data_policy"):
        tc.PolicyConfig(data_policy="first-touch")
    pc = tc.PolicyConfig(data_policy="interleave", pt_policy="bind_high")
    assert pc.data_policy == tc.INTERLEAVE and pc.pt_policy == tc.PT_BIND_HIGH
    stacked = tc.stack_policies([pc, tc.bhi_mig(), tc.nomad()], device="cpu")
    want = jc.stack_policies([jc.PolicyConfig(data_policy="interleave",
                                              pt_policy="bind_high"),
                              jc.bhi_mig(), jc.nomad()])
    for f in dataclasses.fields(want):
        w, g = np.asarray(getattr(want, f.name)), getattr(stacked, f.name)
        assert g.numpy().dtype == w.dtype, f.name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f.name)


# -- the sweep cases of the blocked, fault-batch and split-window suites -------

EIGHT = [jc.PolicyConfig(data_policy=d, pt_policy=p, autonuma=False)
         for d in (jc.FIRST_TOUCH, jc.INTERLEAVE)
         for p in (jc.PT_FOLLOW_DATA, jc.PT_BIND_ALL, jc.PT_BIND_HIGH)] + \
    [jc.PolicyConfig(data_policy=d, pt_policy=jc.PT_BIND_HIGH, mig=True,
                     autonuma=False) for d in (jc.FIRST_TOUCH, jc.INTERLEAVE)]


def test_sweep_blocked_matches_per_step_bitwise():
    """tests/test_blocked.py's 8-lane sweep: the blocked sweep == the
    per-step sweep lane for lane, and == the solo blocked runs, bitwise
    (window events are the union across lanes)."""
    mc, cc = blocked_machine(), jc.CostConfig()
    trace = fault_heavy_trace(mc, seed=7, free_at=60)
    blk = port_sweep(mc, cc, EIGHT, trace, engine="blocked", block=16)
    ps = port_sweep(mc, cc, EIGHT, trace, engine="per_step", debug=True)
    for pc, a, b in zip(EIGHT, blk, ps):
        assert_bitwise(a, b, f"{pc.label()}: blocked vs per-step sweep")
    check_lanes(mc, [cc] * 8, EIGHT, [trace] * 8, blk, block=16)


def test_sweep_lanes_match_sequential_reference():
    """tests/test_fault_batch.py's 8-lane sweep of the batched fault path
    == 8 solo runs of the sequential path (states and every timeline key
    bitwise), and the sequential path swept == the same."""
    mc, cc = blocked_machine(), jc.CostConfig()
    trace = conflict_trace(mc)
    batch = port_sweep(mc, cc, EIGHT, trace, phase_b="batched")
    seq = port_sweep(mc, cc, EIGHT, trace, phase_b="sequential", debug=True)
    for pc, a, b in zip(EIGHT, batch, seq):
        assert_bitwise(a, b, f"{pc.label()}: batched vs sequential sweep")
    check_lanes(mc, [cc] * 8, EIGHT, [trace] * 8, batch,
                phase_b="sequential", debug=True)


def test_sweep_shares_signatures_across_same_geometry():
    """tests/test_split_windows.py's case: a fault at rows 3 and 4 of a
    window land in one quantized geometry (one signature); row 9 needs a
    wider prefix bucket (exactly one more)."""
    mc = split_machine(va_pages=1 << 11)
    cc = jc.CostConfig()
    pcs = [jc.PolicyConfig(data_policy=jc.FIRST_TOUCH,
                           pt_policy=jc.PT_FOLLOW_DATA, autonuma=False),
           jc.PolicyConfig(data_policy=jc.INTERLEAVE,
                           pt_policy=jc.PT_BIND_HIGH, autonuma=False)]
    T = mc.n_threads
    pop_rows = 16
    pool = pop_rows * T

    def tr(fault_step, seed):
        s = np.arange(pop_rows, dtype=np.int64)[:, None]
        t = np.arange(T, dtype=np.int64)[None, :]
        run = np.random.default_rng(seed).integers(0, pool,
                                                   (64 - pop_rows, T))
        va = (np.concatenate([s * T + t, run]) << mc.map_shift).astype(np.int32)
        va[fault_step] = (np.arange(pool, pool + T) << mc.map_shift
                          ).astype(np.int32)
        return split_trace(mc, va)

    before = tc.sweep_compile_count()
    first = tr(35, 1)
    got = port_sweep(mc, cc, pcs, first, block=16)
    base = tc.sweep_compile_count()
    assert base == before + 1
    check_lanes(mc, [cc] * 2, pcs, [first] * 2, got, block=16)
    port_sweep(mc, cc, pcs, tr(36, 2), block=16)
    assert tc.sweep_compile_count() == base
    port_sweep(mc, cc, pcs, tr(41, 3), block=16)
    assert tc.sweep_compile_count() == base + 1


# -- per-lane costs, overrides, gates ---------------------------------------------

COSTS = [jc.CostConfig(),
         jc.CostConfig(llc_hit=55, stlb_hit=7, cpu_work=31, nvmm_read=900,
                       fault_base=700, migrate_fixed=900, copy_lines=24,
                       data_stall_frac=0.25, mig_cost_scale=0.1,
                       leaf_llc_hit=0.5, upper_llc_hit=0.2),
         jc.CostConfig(dram_read=200, dram_write=220, nvmm_write=1300,
                       alloc_fast=120, alloc_slow=3000, zero_lines=8,
                       tlb_flush=600, oom_scan=150000, data_stall_frac=0.9,
                       leaf_llc_hit=0.1, upper_llc_hit=0.6)]


def test_sweep_lanes_with_their_own_costs():
    """Four lanes over a two-trace grid (a mid-run free in one), three
    different CostConfigs and scanning policies: each lane == its solo run
    with its own costs bitwise, == JAX's ``sweep_lanes`` lane and ==
    ``OracleSim``."""
    mc = tiny_machine()
    a = random_trace(mc, seed=61, steps=128, name="a")
    b = random_trace(mc, seed=62, steps=128, free_at=70, name="b")
    pols = [POLICIES[1], POLICIES[3], POLICIES[0], POLICIES[1]]
    ccs = [COSTS[0], COSTS[1], COSTS[2], COSTS[1]]
    traces = [a, b, a, b]
    ta, tb = port([a, b])
    got = tc.sweep_lanes(port(mc), port(ccs), port(pols), [ta, tb, ta, tb],
                         device="cpu")
    want = jc.sweep_lanes(mc, ccs, pols, traces)
    check_lanes(mc, ccs, pols, traces, got, want, oracle=True)
    assert got[0].summary()["total_cycles"] != got[2].summary()["total_cycles"]
    assert got[1].summary()["migration_cycles"] > 0


def test_budget_and_group_overrides():
    """An override below the lanes' maximum is refused, as in the
    reference; one above it changes nothing, bit for bit."""
    mc, cc = tiny_machine(), jc.CostConfig()
    trace = random_trace(mc, seed=71, steps=96)
    pols = POLICIES[:2]
    with pytest.raises(ValueError, match="budget override"):
        port_sweep(mc, cc, pols, trace, budget=16)
    with pytest.raises(ValueError, match="group override"):
        tc.sweep_lanes(port(mc), [port(cc)] * 2, port(pols),
                       [port(trace)] * 2, group=1, device="cpu")
    plain = port_sweep(mc, cc, pols, trace)
    wide = tc.sweep_lanes(port(mc), [port(cc)] * 2, port(pols),
                          [port(trace)] * 2, budget=64, group=4, device="cpu")
    for x, y in zip(plain, wide):
        assert_bitwise(x, y, "overrides")


def test_debug_gate_and_one_device():
    mc, cc = tiny_machine(), jc.CostConfig()
    trace = random_trace(mc, seed=72, steps=32)
    for kw in (dict(engine="per_step"), dict(phase_b="sequential")):
        with pytest.raises(ValueError, match="debug=True"):
            port_sweep(mc, cc, POLICIES[:2], trace, **kw)
    with pytest.raises(ValueError, match="unknown engine"):
        port_sweep(mc, cc, POLICIES[:2], trace, engine="fast", debug=True)
    with pytest.raises(ValueError, match="lane_sharding"):
        port_sweep(mc, cc, POLICIES[:2], trace, lane_sharding=object())
    # "auto" on the CPU is the degenerate lane mesh of one device
    auto = port_sweep(mc, cc, POLICIES[:2], trace, lane_sharding="auto")
    a = port_sweep(mc, cc, POLICIES[:2], trace, engine="per_step", debug=True)
    b = port_sweep(mc, cc, POLICIES[:2], trace)
    for x, y, z in zip(a, b, auto):
        assert_bitwise(x, y, "per-step vs blocked")
        assert_bitwise(z, y, "lane mesh of one vs plain")
