"""The port's golden file of the multi-tenant scenario holds the JAX
package's outputs: a fresh JAX run of ``examples/multitenant_sim.py``'s
two policies on the full ``benchmark_machine()`` must give it, at the
example's size and at the smoke size ``chip_smoke.py`` runs (every
summary key, and the last and populate-phase rows of every timeline key;
integers exact, cycles to ``rtol=1e-5``).  The port's trace generator
gives the same traces, and the port's numpy oracle gives the smoke
size's counters and placements.  ``chip_smoke.py`` and ``python -m
repro_torch.multitenant_sim`` hold the card's runs to the same file.

Rewrite the file after a deliberate change to the reference:

    PYTHONPATH=src python tests/test_torch_multitenant.py --write
"""
import json
import sys

import numpy as np
import pytest

import repro.core as jc
from repro_torch import multitenant_sim as tm
from repro_torch.core import CostConfig, ref as tref
from repro_torch.core import workloads as tw
from test_ntier import CYCLE_KEYS, EXACT_KEYS
from test_torch_engine import fresh_jax_caches  # noqa: F401 (autouse)


def jax_size(size: str) -> dict:
    mc = jc.benchmark_machine()
    trace = jc.workloads.multi_tenant(mc, "memcached", **tm.SIZES[size])
    sched = jc.fault_schedule(trace, mc)
    out = {"trace": {"workload": "multi_tenant", "bench": "memcached",
                     **tm.SIZES[size], "name": trace.name,
                     "n_steps": int(trace.n_steps),
                     "populate_steps": int(trace.populate_steps),
                     "fault_steps": int(((sched & jc.sim.SCHED_DO) > 0)
                                        .any(axis=1).sum()),
                     "free_at": [int(s) for s in
                                 np.nonzero(trace.free_seg >= 0)[0]],
                     "digest": jc.trace_digest(trace)},
           "policies": {}}
    for (name, _), fn in zip(tm.POLICIES, ("linux_default", "bhi_mig")):
        pc = getattr(jc, fn)()
        res = jc.TieredMemSimulator(mc=mc, pc=pc).run(trace)
        out["policies"][name] = {"label": pc.label(),
                                 **tm.outputs(res, trace)}
    return out


def jax_golden() -> dict:
    return {"source": "the JAX package's TieredMemSimulator (default "
                      "engine) on examples/multitenant_sim.py's run and on "
                      "the smoke size; written by "
                      "tests/test_torch_multitenant.py",
            "sizes": {size: jax_size(size) for size in tm.SIZES}}


@pytest.fixture(scope="module")
def golden():
    return tm.load_golden()


@pytest.mark.parametrize("size", list(tm.SIZES))
def test_golden_file_is_the_jax_multitenant_run(size, golden):
    want = golden["sizes"][size]
    assert tm.mismatches(jax_size(size), want) == []
    # the port's trace generator gives the golden trace, bit for bit
    trace = tm.multitenant_trace(tm.benchmark_machine(), size)
    assert tw.trace_digest(trace) == want["trace"]["digest"]
    assert trace.populate_steps == want["trace"]["populate_steps"]
    assert trace.n_steps == want["trace"]["n_steps"]
    # the scenario's point: only Radiant's Mig brings PTE pages home
    assert tm.pte_pages_come_home(
        {n: want["policies"][n]["summary"] for n in want["policies"]})


def test_golden_full_size_is_the_examples_run(golden):
    """16,081 steps, 9,937 of them populate (each with a fault), the fill
    apps freed once, mid-run."""
    t = golden["sizes"]["full"]["trace"]
    assert (t["n_steps"], t["populate_steps"], t["fault_steps"]) == \
        (16081, 9937, 9937)
    assert len(t["free_at"]) == 1 and t["populate_steps"] < t["free_at"][0]


def test_port_oracle_gives_the_smoke_size(golden):
    """The port's numpy oracle on the smoke size: counters and placements
    exact, cycles to rtol 1e-5, against the golden file (what
    ``chip_smoke.py`` [multitenant] holds the card to on both sides)."""
    mc = tm.benchmark_machine()
    trace = tm.multitenant_trace(mc, "smoke")
    want = golden["sizes"]["smoke"]["policies"]
    for name, pc in tm.POLICIES:
        oracle = tref.OracleSim(mc, CostConfig(), pc)
        oracle.run(trace)
        s, ref = want[name]["summary"], oracle.summary()
        for k in EXACT_KEYS:
            assert ref[k] == s[k], (name, k)
        for k in CYCLE_KEYS:
            np.testing.assert_allclose(ref[k], s[k], rtol=1e-5,
                                       err_msg=f"{name}: {k}")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        raise SystemExit(__doc__)
    tm.GOLDEN.write_text(json.dumps(jax_golden(), indent=1) + "\n")
