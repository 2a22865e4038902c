"""The port's numpy oracle (``repro_torch.core.ref.OracleSim``) against the
JAX package's (``repro.core.ref.OracleSim``) on the cases of
tests/test_ntier.py and of tests/test_torch_engine.py (2, 3 and 4 tiers,
the AutoNUMA, TPP and Nomad families, THP, memory pressure, segment
frees, a radix of 6 bits, the seeded fuzz cases): both are numpy in the
same order, so every summary value (cycles included), every placement
array, counter, cycle array and TLB entry is equal, exactly.  The port's
copy imports neither JAX nor the JAX package."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core as jc
import test_ntier
from repro.core.ref import OracleSim
import repro_torch.core as tc
from repro_torch.core import ref as tref
from test_ntier import DEGENERATE_POLICIES, random_trace, tiny_machine
from test_torch_engine import CASE_NAMES, case, to_port

SRC = Path(__file__).resolve().parents[1] / "src"


def fuzz(seed):
    """tests/test_ntier.py's fuzz case of ``seed``: its machine, costs,
    policy and trace, taken from ``fuzz_case`` with the JAX run stubbed."""
    got = []

    class NoRun:
        def __init__(self, **kw):
            pass

        def run(self, tr):
            return None

    orig = (test_ntier.TieredMemSimulator, test_ntier.assert_matches_oracle)
    test_ntier.TieredMemSimulator = NoRun
    test_ntier.assert_matches_oracle = \
        lambda res, mc, cc, pc, tr: got.append((mc, cc, pc, tr))
    try:
        test_ntier.fuzz_case(seed)
    finally:
        test_ntier.TieredMemSimulator, test_ntier.assert_matches_oracle = orig
    return got[0]


def zero_middle_tier(pc, **kw):
    mc = tiny_machine(tiers=(600, 0, 2400))
    return mc, jc.CostConfig(), pc, random_trace(mc, **kw)


def ntier(tiers, pc, seed, **kw):
    mc = tiny_machine(tiers=tiers, va_pages=1 << 11)
    return mc, jc.CostConfig(), pc, random_trace(mc, seed=seed, **kw)


# tests/test_ntier.py's cases that tests/test_torch_engine.py lacks
NTIER = {
    **{f"zero middle tier {i}": (
        lambda i=i: zero_middle_tier(DEGENERATE_POLICIES[i], seed=i,
                                     free_at=100 if i == 1 else None))
       for i in range(len(DEGENERATE_POLICIES))},
    "3-tier per-tier tpp": lambda: ntier(
        (300, 600, 2400), jc.tpp(demote_wm=0.05, autonuma_period=16,
                                 autonuma_budget=32), 70, steps=256,
        write_p=0.5),
    "4-tier per-tier nomad": lambda: ntier(
        (300, 600, 1200, 4800), jc.nomad(autonuma_period=16,
                                         autonuma_budget=32), 71, steps=256,
        write_p=0.5),
    **{f"fuzz {seed}": (lambda seed=seed: fuzz(seed)) for seed in range(3)},
}


def make(name):
    if name in NTIER:
        return NTIER[name]()
    mc, pc, trace = case(name)
    return mc, jc.CostConfig(), pc, trace


def assert_equal_state(got, want, name):
    assert sorted(vars(got)) == sorted(vars(want)), name
    for key, w in vars(want).items():
        g = getattr(got, key)
        if key in ("mc", "cc", "pc"):
            continue
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, (name, key)
            np.testing.assert_array_equal(g, w, err_msg=f"{name}: {key}")
        elif isinstance(w, list) and w and hasattr(w[0], "tags"):
            for i, (gt, wt) in enumerate(zip(g, w, strict=True)):
                np.testing.assert_array_equal(gt.tags, wt.tags,
                                              err_msg=f"{name}: {key}[{i}]")
                np.testing.assert_array_equal(gt.lru, wt.lru,
                                              err_msg=f"{name}: {key}[{i}]")
        else:
            assert g == w and type(g) is type(w), (name, key, g, w)


@pytest.mark.parametrize("name", CASE_NAMES + list(NTIER))
def test_port_oracle_equals_the_jax_packages(name):
    mc, cc, pc, trace = make(name)
    want = OracleSim(mc, cc, pc)
    want.run(trace)
    got = tref.OracleSim(to_port(mc), to_port(cc), to_port(pc))
    got.run(to_port(trace))
    assert got.summary() == want.summary(), name
    assert_equal_state(got, want, name)
    assert want.summary()["faults"] > 0


def test_port_oracle_resumes_as_the_jax_packages():
    """A second ``run`` on the same oracle (a pre-populated address space,
    where the schedule checks are off) stays equal too."""
    mc, cc, pc, trace = make("segment free")
    want = OracleSim(mc, cc, pc)
    got = tref.OracleSim(to_port(mc), to_port(cc), to_port(pc))
    for _ in range(2):
        want.run(trace)
        got.run(to_port(trace))
    assert got.summary() == want.summary()
    assert_equal_state(got, want, "resumed")


def test_port_oracle_holds_the_port_engine():
    """The port's default engine on the CPU against the port's oracle:
    the summary's counters and placements exact, cycles to rtol 1e-5
    (the bar tests/test_ntier.py sets the JAX engine), and the final
    state's placement arrays equal to the oracle's (``ref.PLACEMENTS``,
    what ``chip_smoke.py`` [multitenant] holds the card to)."""
    mc, cc, pc, trace = (to_port(x) for x in make("3-tier per-tier tpp"))
    res = tc.TieredMemSimulator(mc=mc, cc=cc, pc=pc, device="cpu").run(trace)
    oracle = tref.OracleSim(mc, cc, pc)
    oracle.run(trace)
    ref, s = oracle.summary(), res.summary()
    for k in test_ntier.EXACT_KEYS:
        assert s[k] == ref[k], k
    for k in test_ntier.CYCLE_KEYS:
        np.testing.assert_allclose(s[k], ref[k], rtol=1e-5, err_msg=k)
    for state_key, oracle_key in tref.PLACEMENTS:
        np.testing.assert_array_equal(
            getattr(res.final_state, state_key), getattr(oracle, oracle_key),
            err_msg=state_key)


def test_port_oracle_imports_no_jax():
    code = ("import sys\n"
            "import repro_torch.core.ref\n"
            "assert not any(m.split('.')[0] in ('jax', 'repro') "
            "for m in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=SRC,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
