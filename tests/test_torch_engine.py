"""The port's per-step engine (``repro_torch.core.TieredMemSimulator(
engine="per_step", debug=True)`` on the CPU) held to the JAX package's
pure-Python oracle
(``repro.core.ref.OracleSim``): ``EXACT_KEYS`` exact and ``CYCLE_KEYS`` to
``rtol=1e-5`` (f32 sums in another order), on the small machines, traces
and policy bundles of tests/test_core_oracle.py and tests/test_ntier.py.
``test_torch_engine_jax.py`` holds the same cases to the JAX per-step
engine, field by field.

Every run also checks that the fault path's scatters commit each entry
once: the indices written by ``sim._set_where`` are unique after the
sentinel mask.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as jc
from repro.core.ref import OracleSim
import repro_torch.core as tc
from repro_torch.core import sim as tsim

from test_core_oracle import POLICIES, random_trace, tiny_machine
from test_ntier import (CYCLE_KEYS, EXACT_KEYS, FAMILY_POLICIES, TIER3,
                        random_trace as ntier_trace,
                        tiny_machine as ntier_machine)


def _pressure_machine():
    return jc.MachineConfig(n_threads=4, dram_pages_per_node=200,
                            nvmm_pages_per_node=1600, va_pages=1 << 11,
                            l1_tlb_sets=4, l1_tlb_ways=2, stlb_sets=8,
                            stlb_ways=4, pde_pwc_entries=4, pdpte_pwc_entries=2)


def _radix6_machine():
    return jc.MachineConfig(n_threads=4, dram_pages_per_node=600,
                            nvmm_pages_per_node=2400, va_pages=1 << 12,
                            radix_bits=6, l1_tlb_sets=4, l1_tlb_ways=2,
                            stlb_sets=8, stlb_ways=4, pde_pwc_entries=4,
                            pdpte_pwc_entries=2)


def _churn_trace(mc):
    """tests/test_ntier.py's Nomad abort churn: a hot set larger than DRAM,
    writes nine accesses in ten."""
    rng = np.random.default_rng(2)
    steps, T = 256, mc.n_threads
    return jc.Trace(va=rng.integers(0, 512, (steps, T)).astype(np.int32),
                    is_write=rng.random((steps, T)) < 0.9,
                    free_seg=np.full(steps, -1, np.int32),
                    llc=np.full(steps, 0.4, np.float32),
                    seg_of_map=np.zeros(mc.n_map, np.int32), name="churn")


# (name, machine, policy, trace) of the JAX package's oracle suites
CASES = (
    [(f"oracle policy {i}", tiny_machine, lambda i=i: POLICIES[i],
      lambda mc, i=i: random_trace(mc, seed=i)) for i in range(len(POLICIES))]
    + [("segment free", tiny_machine, lambda: POLICIES[3],
        lambda mc: random_trace(mc, seed=42, free_at=100))]
    + [(f"thp policy {i}", lambda: tiny_machine(page_order=9),
        lambda i=i: POLICIES[i], lambda mc, i=i: random_trace(mc, seed=7 + i))
       for i in (0, 3)]
    + [(f"memory pressure policy {i}", _pressure_machine,
        lambda i=i: POLICIES[i],
        lambda mc, i=i: random_trace(mc, seed=i, steps=256)) for i in (1, 2, 3)]
    + [(f"radix 6 policy {i}", _radix6_machine, lambda i=i: POLICIES[i],
        lambda mc, i=i: random_trace(mc, seed=20 + i)) for i in (2, 3)]
    + [(f"3-tier family {i}", lambda: ntier_machine(tiers=TIER3),
        lambda i=i: FAMILY_POLICIES[i],
        lambda mc, i=i: ntier_trace(mc, seed=30 + i,
                                    free_at=100 if i >= 2 else None))
       for i in range(len(FAMILY_POLICIES))]
    + [(f"3-tier pressure {name}",
        lambda: ntier_machine(tiers=(200, 400, 1600), va_pages=1 << 11),
        lambda pc=pc: pc,
        lambda mc, i=i: ntier_trace(mc, steps=256, seed=60 + i, write_p=0.5))
       for i, (name, pc) in enumerate(
           (("tpp", jc.tpp(demote_wm=0.10, autonuma_period=16,
                           autonuma_budget=32)),
            ("nomad", jc.nomad(autonuma_period=16, autonuma_budget=32))))]
    + [("3-tier nomad churn",
        lambda: ntier_machine(tiers=(150, 300, 1600), va_pages=1 << 11),
        lambda: jc.nomad(autonuma_period=16, autonuma_budget=64),
        _churn_trace)]
)
CASE_NAMES = [c[0] for c in CASES]


def to_port(obj):
    """The port's twin of a JAX config or trace (same fields)."""
    kind = {jc.MachineConfig: tc.MachineConfig, jc.PolicyConfig:
            tc.PolicyConfig, jc.CostConfig: tc.CostConfig,
            jc.Trace: tc.Trace}[type(obj)]
    return kind(**{f.name: getattr(obj, f.name)
                   for f in dataclasses.fields(obj)})


def case(name):
    _, make_mc, make_pc, make_trace = CASES[CASE_NAMES.index(name)]
    mc = make_mc()
    return mc, make_pc(), make_trace(mc)


@pytest.fixture
def unique_commits(monkeypatch):
    """Wrap ``sim._set_where``: the rows it writes (after the sentinel
    mask) must name distinct entries, or a scatter would pick a winner."""
    calls = []
    orig = tsim._set_where

    def checked(arr, idx, vals, mask):
        written = idx[mask]
        assert written.unique().numel() == written.numel(), \
            f"duplicate commit indices {written.tolist()}"
        calls.append(int(written.numel()))
        return orig(arr, idx, vals, mask)

    monkeypatch.setattr(tsim, "_set_where", checked)
    return calls


def port_sim(mc, pc, **kw):
    """The port's per-step engine on the CPU (an oracle path: ``debug``)."""
    return tc.TieredMemSimulator(mc=to_port(mc), pc=to_port(pc), device="cpu",
                                 engine="per_step", debug=True, **kw)


def port_run(name):
    mc, pc, trace = case(name)
    return port_sim(mc, pc).run(to_port(trace))


@pytest.mark.parametrize("name", CASE_NAMES)
def test_per_step_engine_matches_oracle(name, unique_commits):
    mc, pc, trace = case(name)
    res = port_run(name)
    assert sum(unique_commits) > 0           # the fault path committed
    oracle = OracleSim(mc, jc.CostConfig(), pc)
    oracle.run(trace)
    ref, got = oracle.summary(), res.summary()
    for k in EXACT_KEYS:
        assert got[k] == ref[k], f"{name}: {k}: port={got[k]} oracle={ref[k]}"
    for k in CYCLE_KEYS:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5,
                                   err_msg=f"{name}: {k}")


def test_stepping_in_pieces_equals_one_run():
    mc, pc, trace = case("segment free")
    sim = port_sim(mc, pc)
    whole = sim.run(to_port(trace))
    stepper = sim.runner(to_port(trace))
    for n in (1, 37, 62, 1000):
        stepper.advance(n)
    pieces = stepper.result()
    for (name, a), (_, b) in zip(tsim_fields(whole.final_state),
                                 tsim_fields(pieces.final_state)):
        np.testing.assert_array_equal(a, b, err_msg=name)
    for k in whole.timeline:
        np.testing.assert_array_equal(whole.timeline[k], pieces.timeline[k])
    assert int(pieces.final_state.step) == trace.n_steps


def tsim_fields(state, prefix=""):
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            yield from tsim_fields(v, prefix + f.name + ".")
        else:
            yield prefix + f.name, np.asarray(v)


def test_reference_paths_need_debug():
    """The reference's gate: the default is the blocked engine with the
    batched fault path; the per-step engine and the sequential path are
    oracle paths that raise ``ValueError`` without ``debug=True`` and run
    with it."""
    sim = tc.TieredMemSimulator(device="cpu")
    assert (sim.engine, sim.phase_b, sim.debug) == ("blocked", "batched",
                                                     False)
    mc, pc, trace = case("oracle policy 0")
    trace = to_port(trace)
    trace = dataclasses.replace(trace, va=trace.va[:24],
                                is_write=trace.is_write[:24],
                                free_seg=trace.free_seg[:24],
                                llc=trace.llc[:24])
    runs = []
    for kw in (dict(engine="per_step"), dict(phase_b="sequential"),
               dict(engine="per_step", phase_b="sequential")):
        with pytest.raises(ValueError, match="debug=True"):
            tc.TieredMemSimulator(mc=to_port(mc), pc=to_port(pc),
                                  device="cpu", **kw)
        sim = tc.TieredMemSimulator(mc=to_port(mc), pc=to_port(pc),
                                    device="cpu", debug=True, **kw)
        assert isinstance(sim.runner(trace), tsim.Stepper) == \
            (sim.engine == "per_step")
        runs.append(sim.run(trace).summary())
    assert runs[0] == runs[1] == runs[2]
    for kw in (dict(engine="fast"), dict(phase_b="parallel")):
        with pytest.raises(ValueError, match="unknown"):
            tc.TieredMemSimulator(device="cpu", debug=True, **kw)
