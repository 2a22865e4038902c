"""Quickstart on the port: the paper's headline result (twin of the JAX
package's ``examples/quickstart.py``, printing the same lines).

Runs the scaled paper machine under the Linux baseline and under Radiant
(BHi+Mig) on a zipfian key-value workload and prints the cycle breakdown —
the paper's ~20% total-cycle improvement (Table 4).

    PYTHONPATH=src python -m repro_torch.quickstart     # on the CUDA device
"""
from __future__ import annotations

import json
import math
from pathlib import Path

from .core import (TieredMemSimulator, benchmark_machine, bhi_mig,
                   linux_default, workloads)

# The JAX package's outputs for this run (tests/test_torch_quickstart.py
# writes it from a fresh JAX run and holds it equal to one)
GOLDEN = Path(__file__).resolve().parent / "core" / "golden" / "quickstart.json"
RTOL = 1e-5            # cycle values (f32 sums, whose order differs)

POLICIES = (("Linux first-touch", linux_default()),
            ("Radiant BHi+Mig ", bhi_mig()))


def quickstart_trace(mc):
    return workloads.kv_store(mc, footprint=1 << 18, run_steps=4096,
                              name="memcached")


def run_phase(res, trace):
    """(run-phase cycles, run-phase walk cycles) from a run's timeline."""
    tl, p = res.timeline, trace.populate_steps
    return (float(tl["total_cycles"][-1] - tl["total_cycles"][p]),
            float(tl["walk_cycles"][-1] - tl["walk_cycles"][p]))


def outputs(res, trace) -> dict:
    """What the golden file keeps of a run: every ``summary()`` key, and
    the last row and the populate-phase row of every timeline key."""
    p = trace.populate_steps
    return {"summary": res.summary(),
            "timeline_last": {k: v[-1].item() for k, v in res.timeline.items()},
            "timeline_at_populate": {k: v[p].item()
                                     for k, v in res.timeline.items()}}


def load_golden() -> dict:
    return json.loads(GOLDEN.read_text())


def mismatches(got: dict, want: dict, path: str = "") -> list:
    """Where ``got`` differs from ``want``: floats (the cycle values) by
    more than ``RTOL``, everything else (integers, flags, lists of counts,
    names) at all."""
    if isinstance(want, dict):
        bad = [f"{path}{k}: missing" for k in want if k not in got]
        bad += [f"{path}{k}: not in the golden file" for k in got
                if k not in want]
        for k in want:
            if k in got:
                bad += mismatches(got[k], want[k], f"{path}{k}.")
        return bad
    if isinstance(want, float):
        if not math.isclose(got, want, rel_tol=RTOL, abs_tol=0.0):
            return [f"{path[:-1]}: {got!r} != {want!r} (rtol {RTOL})"]
        return []
    if got != want or type(got) is not type(want):
        return [f"{path[:-1]}: {got!r} != {want!r}"]
    return []


def report_line(name, res, trace, base_total):
    s = res.summary()
    run_total, run_walk = run_phase(res, trace)
    return (f"{name}: run-phase cycles={run_total:.3g} "
            f"walk={run_walk:.3g} ({100*run_walk/run_total:.0f}% of cycles) "
            f"PTE pages on DRAM={s['leaf_pages_dram']}/"
            f"{s['leaf_pages_dram']+s['leaf_pages_nvmm']} "
            f"improvement={100*(base_total-run_total)/base_total:.1f}%")


def main() -> None:
    mc = benchmark_machine()
    trace = quickstart_trace(mc)
    base = None
    for name, pc in POLICIES:
        res = TieredMemSimulator(mc=mc, pc=pc).run(trace)
        if base is None:
            base = run_phase(res, trace)[0]
        print(report_line(name, res, trace, base))
    print("\n(paper Table 4: BHi+Mig improves total cycles by ~20%)")


if __name__ == "__main__":
    main()
