"""The port's window plan and its hoist and split windows, on the cases of
tests/test_split_windows.py.

``plan_windows`` and ``blocked_xs`` are host numpy in both packages: the
port's outputs equal JAX's field for field on the same masks (``geom``,
``kind``, ``seg_a``, ``seg_b``, ``emit_valid``, ``rows_in``, ``counts``),
drawn and crafted.  The port's blocked runs over hoist and split windows
equal its per-step runs bit for bit, and the JAX package's pure-Python
oracle (``OracleSim``) on the fixed-seed fuzz cases.
"""
import numpy as np
import pytest

import repro.core as jc
from repro.core import sim as jsim
from repro.core.ref import OracleSim
from repro_torch.core import sim as tsim

import test_split_windows
from test_blocked import CYCLE_KEYS, EXACT_KEYS, steady_trace, tiny_machine
from test_split_windows import quiet_masks
from test_torch_blocked import assert_bitwise, port_blocked, port_per_step
from test_torch_engine import to_port

PLAN_FIELDS = ("geom", "kind", "seg_a", "seg_b", "emit_valid", "rows_in",
               "block", "counts")


def assert_same_plan(got, want, label=""):
    for f in PLAN_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, f"{label}: {f}"
            np.testing.assert_array_equal(g, w, err_msg=f"{label}: {f}")
        else:
            assert g == w, f"{label}: {f}: {g} != {w}"
    assert got.n_windows == want.n_windows


def both_plans(df, ds, hf, S, B):
    got = tsim.plan_windows(df, ds, hf, S, B)
    assert_same_plan(got, jsim.plan_windows(df, ds, hf, S, B), f"S={S} B={B}")
    return got


def test_plan_windows_matches_jax_on_drawn_masks():
    """Random event rows (sparse and dense, lone scan ticks, spans at the
    window edges), step counts with and without a partial tail, blocks 4
    to 64."""
    rng = np.random.default_rng(0)
    for trial in range(120):
        B = int(rng.choice([4, 8, 16, 64]))
        S = int(rng.integers(1, 6 * B))
        density = float(rng.choice([0.0, 0.01, 0.05, 0.3]))
        df = rng.random(S) < density / 4
        ds = np.zeros(S, bool)
        period = int(rng.choice([B // 2 or 1, B, 3 * B]))
        ds[period::period] = rng.random() < 0.7
        hf = rng.random(S) < density
        both_plans(df, ds, hf, S, B)


def test_blocked_xs_matches_jax():
    """The tiled inputs and the plan of real traces, fresh and resumed."""
    mc = tiny_machine()
    pc = jc.PolicyConfig(data_policy=jc.FIRST_TOUCH,
                         pt_policy=jc.PT_FOLLOW_DATA, autonuma=True,
                         autonuma_period=16, autonuma_budget=32)
    for trace, start in ((steady_trace(mc, steps=150, seed=4), 0),
                         (steady_trace(mc, steps=90, seed=5, free_at=40), 7)):
        for block in (16, 64):
            want_xs, want = jsim.blocked_xs(trace, mc, pc, start_step=start,
                                            block=block)
            got_xs, got = tsim.blocked_xs(to_port(trace), to_port(mc),
                                          to_port(pc), start_step=start,
                                          block=block, device="cpu")
            assert_same_plan(got, want, f"blocked_xs block={block}")
            assert len(got_xs) == len(want_xs) == 12
            for i, (g, w) in enumerate(zip(got_xs, want_xs)):
                w = np.asarray(w)
                g = g.numpy()
                assert g.dtype == w.dtype and g.shape == w.shape, i
                np.testing.assert_array_equal(g, w, err_msg=f"xs[{i}]")


def test_plan_classifies_fast_hoist_split_full():
    S, B = 64, 16
    df, ds, hf = quiet_masks(S)
    p = both_plans(df, ds, hf, S, B)
    assert p.counts == (4, 0, 0, 0)
    assert p.geom is None
    assert int(p.emit_valid.sum()) == S

    ds[21] = True                    # lone scan tick in window 1 -> hoist
    p = both_plans(df, ds, hf, S, B)
    assert p.counts == (3, 0, 1, 0)

    hf[36:39] = True                 # narrow fault span in window 2 -> split
    p = both_plans(df, ds, hf, S, B)
    assert p.counts == (2, 0, 1, 1)

    df[49] = True                    # span 49..63 wider than block // 2:
    df[63] = True                    # window 3 replays in full
    p = both_plans(df, ds, hf, S, B)
    assert p.counts == (1, 1, 1, 1)
    assert int(p.emit_valid.sum()) == S
    kinds = tsim.window_kinds(p)
    assert kinds.tolist() == [tsim.WIN_FAST, tsim.WIN_HOIST, tsim.WIN_SPLIT,
                              tsim.WIN_FULL]
    # what the runner does with each: hoist at step 21, the span 36..38
    ops = tsim.window_ops(p, S)
    assert ops == [[("fast", 0, 16)],
                   [("fast", 16, 21), ("scan", 21, 22), ("fast", 21, 32)],
                   [("fast", 32, 36), ("steps", 36, 39), ("fast", 39, 48)],
                   [("steps", 48, 64)]]


def test_partial_tail_with_faults_replays_full():
    S, B = 40, 16                    # windows of 16, 16, and a tail of 8
    df, ds, hf = quiet_masks(S)
    hf[38] = True
    p = both_plans(df, ds, hf, S, B)
    assert p.counts[tsim.WIN_FULL] == 1
    assert p.counts[tsim.WIN_SPLIT] == 0
    assert int(p.emit_valid.sum()) == S
    assert tsim.window_ops(p, S)[-1] == [("steps", 32, 40)]


def test_geometry_quantizes_to_pow2_buckets():
    S, B = 64, 16

    def one_fault(step):
        df, ds, hf = quiet_masks(S)
        hf[step] = True
        return both_plans(df, ds, hf, S, B)

    a, b = one_fault(19), one_fault(20)
    assert a.counts[tsim.WIN_SPLIT] == 1
    assert a.geom == b.geom == (False, None, (4, 1, 16))
    assert a.emit_valid.shape == b.emit_valid.shape
    assert a.rows_in == b.rows_in == 2 * B
    c = one_fault(25)
    assert c.geom != a.geom


@pytest.mark.parametrize("family", ["autonuma", "tpp", "nomad"])
def test_hoist_engages_and_stays_bitwise(family):
    """period == block puts one scan tick at row 0 of every post-populate
    window: those windows hoist the tick between two fast segments (no
    per-step row) and still equal the per-step engine bit for bit."""
    mc = tiny_machine()
    trace = steady_trace(mc, steps=192, seed=9)
    pc = {"autonuma": jc.PolicyConfig(
              data_policy=jc.FIRST_TOUCH, pt_policy=jc.PT_FOLLOW_DATA,
              autonuma=True, autonuma_period=16, autonuma_budget=32),
          "tpp": jc.tpp(autonuma_period=16, autonuma_budget=32),
          "nomad": jc.nomad(autonuma_period=16, autonuma_budget=32)}[family]
    runner = port_blocked(mc, pc).runner(to_port(trace))
    assert runner.plan.counts[tsim.WIN_HOIST] > 0
    assert any(op == "scan" for win in runner.ops for op, _, _ in win)
    blk = runner.advance().result()
    ps = port_per_step(mc, pc).run(to_port(trace))
    assert_bitwise(blk, ps, family)


def fuzz_inputs(seed, monkeypatch):
    """(mc, cc, pc, trace, block) of tests/test_split_windows.py's
    ``fuzz_case(seed)``: its own generator, with its JAX assertion swapped
    for a capture."""
    got = []
    monkeypatch.setattr(test_split_windows, "assert_blocked_matches_per_step",
                        lambda mc, pc, trace, cc, block: got.append(
                            (mc, cc, pc, trace, block)))
    test_split_windows.fuzz_case(seed)
    (case,) = got
    return case


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_split_hoist_vs_per_step_and_oracle(seed, monkeypatch):
    """Random fault, free and tick rows at window boundaries, interiors and
    the last (maybe partial) row, over four policy families: blocked ==
    per-step bitwise, and == OracleSim (counters exact, cycles to
    ``rtol=1e-5``)."""
    mc, cc, pc, trace, block = fuzz_inputs(seed, monkeypatch)
    runner = port_blocked(mc, pc, block).runner(to_port(trace))
    assert runner.plan.counts[tsim.WIN_FAST] < runner.plan.n_windows
    blk = runner.advance().result()
    ps = port_per_step(mc, pc).run(to_port(trace))
    assert_bitwise(blk, ps, f"fuzz {seed}")
    oracle = OracleSim(mc, cc, pc)
    oracle.run(trace)
    want, got = oracle.summary(), blk.summary()
    for k in EXACT_KEYS:
        assert got[k] == want[k], f"fuzz {seed}: {k}: {got[k]} != {want[k]}"
    for k in CYCLE_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                   err_msg=f"fuzz {seed}: {k}")
