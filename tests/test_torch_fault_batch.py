"""The port's sequential fault path (``phase_b="sequential"``, the
reference's per-thread loop) against its batched fault path and the JAX
package's pure-Python oracle, on the cases of tests/test_fault_batch.py
that need no sweep: a random trace with a free, the conflict-heavy trace,
an OOM during a populate burst, THP, and resumed states.

Sequential == batched bit for bit (every state field and timeline key:
the port commits the batched costs in the sequential order), and both ==
``OracleSim`` (counters exact, cycles to ``rtol=1e-5``).  Both run under
the default (blocked) engine, as in the reference's suite.
"""
import numpy as np
import pytest

import repro.core as jc
from repro.core.ref import OracleSim

from test_fault_batch import (CYCLE_KEYS, EXACT_KEYS, POLICIES,
                              conflict_trace, random_trace, sequential_trace,
                              tiny_machine)
from test_torch_blocked import assert_bitwise, port_blocked
from test_torch_engine import to_port
from test_torch_engine import fresh_jax_caches  # noqa: F401 (autouse)


def port_sim(mc, pc, phase_b):
    return port_blocked(mc, pc, block=64, phase_b=phase_b)


def assert_seq_batched_oracle(mc, pc, trace, oracle=True):
    bat = port_sim(mc, pc, "batched").run(to_port(trace))
    seq = port_sim(mc, pc, "sequential").run(to_port(trace))
    assert_bitwise(seq, bat, f"{pc.label()}: sequential vs batched")
    if oracle:
        ref = OracleSim(mc, jc.CostConfig(), pc)
        ref.run(trace)
        want, got = ref.summary(), bat.summary()
        for k in EXACT_KEYS:
            assert got[k] == want[k], f"{pc.label()}: oracle {k}"
        for k in CYCLE_KEYS:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=f"{pc.label()}: oracle {k}")
    return bat


@pytest.mark.parametrize("policy", range(len(POLICIES)))
def test_batched_matches_sequential_and_oracle(policy):
    mc = tiny_machine()
    trace = random_trace(mc, steps=96, seed=3, free_at=60)
    assert_seq_batched_oracle(mc, POLICIES[policy], trace)


@pytest.mark.parametrize("policy", range(len(POLICIES)))
def test_conflict_heavy_trace(policy):
    """All threads faulting one page (one winner, three waits) or pages
    under one new leaf PT page (four data winners, one leaf winner), past
    a mid-run free."""
    mc = tiny_machine()
    assert_seq_batched_oracle(mc, POLICIES[policy], conflict_trace(mc))


@pytest.mark.parametrize("pt_policy", [jc.PT_FOLLOW_DATA, jc.PT_BIND_ALL,
                                       jc.PT_BIND_HIGH])
def test_oom_during_burst(pt_policy):
    """Bind-all under a populate storm OOMs mid-burst: both paths latch at
    the same thread of the same step."""
    mc = tiny_machine(dram_pages_per_node=150, nvmm_pages_per_node=1600,
                      va_pages=1 << 11, radix_bits=4)
    trace = sequential_trace(mc, steps=160)
    pc = jc.PolicyConfig(data_policy=jc.FIRST_TOUCH, pt_policy=pt_policy,
                         autonuma=False)
    res = assert_seq_batched_oracle(mc, pc, trace)
    if pt_policy == jc.PT_BIND_ALL:
        assert res.summary()["oom_killed"]


def test_thp_machine():
    mc = tiny_machine(page_order=9)
    trace = random_trace(mc, steps=96, seed=51)
    for pc in POLICIES[:2]:
        assert_seq_batched_oracle(mc, pc, trace)


def test_resumed_state_overapproximation():
    """Resumed from a populated state, the host schedule's DO bits
    over-approximate; both paths no-op on the pages already mapped and
    equal the unsplit run."""
    mc = tiny_machine()
    pc = POLICIES[0]
    trace = random_trace(mc, seed=13, steps=96)
    full = assert_seq_batched_oracle(mc, pc, trace, oracle=False)

    def part(sl):
        return jc.Trace(va=trace.va[sl], is_write=trace.is_write[sl],
                        free_seg=trace.free_seg[sl], llc=trace.llc[sl],
                        seg_of_map=trace.seg_of_map)

    for mode in ("batched", "sequential"):
        sim = port_sim(mc, pc, mode)
        mid = sim.run(to_port(part(slice(None, 48))))
        res = sim.run(to_port(part(slice(48, None))), state=mid.final_state)
        np.testing.assert_array_equal(res.final_state.data_node,
                                      full.final_state.data_node)
        assert res.summary()["faults"] == full.summary()["faults"]


def test_resume_after_cross_segment_free_reallocates_leaf():
    """A free that clears a leaf PT page while a sibling granule's data
    page stays mapped; resumed after it, the next real fault under that
    leaf allocates it again on both paths."""
    mc = tiny_machine(radix_bits=4)            # 16 granules per leaf
    T = mc.n_threads
    seg = np.zeros((mc.n_map,), np.int32)
    seg[8:] = 1                                # boundary mid-leaf-0

    def rows_to_trace(rows, free_at=None):
        va = np.array(rows, np.int32)
        free_seg = np.full((va.shape[0],), -1, np.int32)
        if free_at is not None:
            free_seg[free_at] = 0
        return jc.Trace(va=va, is_write=np.ones_like(va, bool),
                        free_seg=free_seg,
                        llc=np.full((va.shape[0],), 0.4, np.float32),
                        seg_of_map=seg)

    first = rows_to_trace([[0, 8, 16, 24][:T] + [-1] * max(T - 4, 0),
                           [-1] * T], free_at=1)
    second = rows_to_trace([[8] + [-1] * (T - 1), [9] + [-1] * (T - 1)])
    pc = jc.PolicyConfig(data_policy=jc.FIRST_TOUCH,
                         pt_policy=jc.PT_FOLLOW_DATA, autonuma=False)
    finals = {}
    for mode in ("batched", "sequential"):
        sim = port_sim(mc, pc, mode)
        st = sim.run(to_port(first)).final_state
        assert int(st.leaf_node[0]) == -1 and int(st.data_node[8]) >= 0
        finals[mode] = sim.run(to_port(second), state=st)
    assert_bitwise(finals["batched"], finals["sequential"], "cross-segment")
    assert int(finals["batched"].final_state.leaf_node[0]) >= 0
