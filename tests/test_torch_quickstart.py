"""The port's golden file of the quickstart holds the JAX package's
outputs: a fresh JAX run of ``examples/quickstart.py``'s two policies on
the full ``benchmark_machine()`` must give it (every summary key, and the
last and populate-phase timeline rows; integers exact, cycles to
``rtol=1e-5``).  ``chip_smoke.py`` holds the card's run to the same file.

Rewrite the file after a deliberate change to the reference:

    PYTHONPATH=src python tests/test_torch_quickstart.py --write
"""
import json
import sys

import numpy as np

import repro.core as jc
from repro_torch import quickstart as tq
from repro_torch.core import workloads as tw


def jax_golden() -> dict:
    mc = jc.benchmark_machine()
    trace = jc.workloads.kv_store(mc, footprint=1 << 18, run_steps=4096,
                                  name="memcached")
    sched = jc.fault_schedule(trace, mc)
    out = {"source": "the JAX package's TieredMemSimulator (default engine) "
                     "on examples/quickstart.py's run; written by "
                     "tests/test_torch_quickstart.py",
           "trace": {"workload": "kv_store", "footprint": 1 << 18,
                     "run_steps": 4096, "name": trace.name,
                     "n_steps": int(trace.n_steps),
                     "populate_steps": int(trace.populate_steps),
                     "fault_steps": int(((sched & jc.sim.SCHED_DO) > 0)
                                        .any(axis=1).sum()),
                     "digest": jc.trace_digest(trace)},
           "policies": {}}
    for name, pc in ((n, getattr(jc, fn)()) for n, fn in
                     zip((n for n, _ in tq.POLICIES),
                         ("linux_default", "bhi_mig"))):
        res = jc.TieredMemSimulator(mc=mc, pc=pc).run(trace)
        out["policies"][name] = {"label": pc.label(),
                                 **tq.outputs(res, trace)}
    return out


def test_golden_file_is_the_jax_quickstart():
    golden = tq.load_golden()
    fresh = jax_golden()
    assert tq.mismatches(fresh, golden) == []
    # the port's trace generator gives the golden trace, bit for bit
    trace = tq.quickstart_trace(tq.benchmark_machine())
    assert tw.trace_digest(trace) == golden["trace"]["digest"]
    assert trace.populate_steps == golden["trace"]["populate_steps"]
    # the numbers the quickstart prints
    pol = golden["policies"]
    leaf = [pol[n]["summary"]["leaf_pages_dram"] for n, _ in tq.POLICIES]
    run = [pol[n]["timeline_last"]["total_cycles"]
           - pol[n]["timeline_at_populate"]["total_cycles"]
           for n, _ in tq.POLICIES]
    assert leaf == [1480, 3109]
    assert np.isclose(100 * (run[0] - run[1]) / run[0], 22.1, atol=0.05)


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        raise SystemExit(__doc__)
    tq.GOLDEN.write_text(json.dumps(jax_golden(), indent=1) + "\n")
