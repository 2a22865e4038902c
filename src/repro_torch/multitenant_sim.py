"""The paper's section 6.3 multi-tenant scenario on the port, end to end
(twin of the JAX package's ``examples/multitenant_sim.py``, printing the
same lines).

Fill apps occupy DRAM, the benchmark app lands on NVMM, the fill apps
exit, AutoNUMA promotes the data — and only Radiant's Mig brings the
PTE pages home.  Prints the before/after placement and cycle deltas, then
holds both runs to the golden file of the JAX package's outputs and
prints each policy's steps/s and kernel launches.

    PYTHONPATH=src python -m repro_torch.multitenant_sim             # card
    PYTHONPATH=src python -m repro_torch.multitenant_sim --size smoke \\
        --device cpu
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from .core import (TieredMemSimulator, benchmark_machine, bhi_mig,
                   linux_default, workloads)
from .device import resolve_device
from .kernels import ops
from .quickstart import mismatches, outputs

# The JAX package's outputs for both sizes (tests/test_torch_multitenant.py
# writes it from a fresh JAX run and holds it equal to one)
GOLDEN = Path(__file__).resolve().parent / "core" / "golden" / \
    "multitenant.json"

# "full" is the example's run; "smoke" keeps benchmark_machine() and its
# fill apps (3,857 populate steps, fixed by the DRAM size) and cuts the
# benchmark app to 2^12 pages and 256 run steps
SIZES = {"full": dict(bench_footprint=1 << 17, run_steps=6144),
         "smoke": dict(bench_footprint=1 << 12, run_steps=256)}

POLICIES = (("Linux+AutoNUMA", linux_default()),
            ("Radiant BHi+Mig", bhi_mig()))


def multitenant_trace(mc, size: str = "full"):
    return workloads.multi_tenant(mc, "memcached", **SIZES[size])


def report_line(name, res, trace) -> str:
    s = res.summary()
    tl, p = res.timeline, trace.populate_steps
    run_total = float(tl["total_cycles"][-1] - tl["total_cycles"][p])
    run_walk = float(tl["walk_cycles"][-1] - tl["walk_cycles"][p])
    return (f"{name}: run cycles={run_total:.4g} walk={run_walk:.4g} | "
            f"PTE pages DRAM/NVMM = {s['leaf_pages_dram']}/"
            f"{s['leaf_pages_nvmm']} | PTE migrations={s['l4_mig_success']} "
            f"(already-in-dest={s['l4_mig_already_dest']}, "
            f"within-tier={s['l4_mig_in_dram']}, "
            f"sibling-guard={s['l4_mig_sibling_guard']}, "
            f"lock-skip={s['l4_mig_lock_skip']})")


def load_golden() -> dict:
    return json.loads(GOLDEN.read_text())


def pte_pages_come_home(summaries: dict) -> bool:
    """Radiant's Mig brings PTE pages back to DRAM: BHi+Mig ends with more
    leaf pages on DRAM than Linux, having migrated some."""
    linux, radiant = (summaries[n] for n, _ in POLICIES)
    return (radiant["leaf_pages_dram"] > linux["leaf_pages_dram"]
            and radiant["l4_mig_success"] > 0)


def run(size: str = "full", device=None, names=None):
    """Both policies (or those named) on ``benchmark_machine()`` at
    ``size``, one run each: (trace, [(name, result, seconds, kernel
    launches)])."""
    dev = resolve_device(device)
    mc = benchmark_machine()
    trace = multitenant_trace(mc, size)
    runs = []
    for name, pc in POLICIES:
        if names is not None and name not in names:
            continue
        ops.reset_launches()
        t0 = time.perf_counter()
        res = TieredMemSimulator(mc=mc, pc=pc, device=dev).run(trace)
        runs.append((name, res, time.perf_counter() - t0,
                     ops.launch_counts()))
    return trace, runs


def golden_mismatches(trace, runs, size: str) -> list:
    """Where the runs differ from the golden file's ``size`` entry
    (``quickstart.mismatches``: integers exact, cycles to its RTOL)."""
    want = load_golden()["sizes"][size]["policies"]
    return mismatches({name: outputs(res, trace) for name, res, _, _ in runs},
                      {n: {k: v for k, v in want[n].items() if k != "label"}
                       for n in want})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", choices=sorted(SIZES), default="full")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    trace, runs = run(args.size, args.device)
    for name, res, _, _ in runs:
        print(report_line(name, res, trace))
    print("\n(paper Fig. 10: walk cycles improve ~33-61%; "
          "PTE pages return to DRAM only with Mig)")
    for name, res, seconds, launches in runs:
        print(f"{name}: {trace.n_steps} steps in {seconds:.2f} s "
              f"({trace.n_steps / seconds:.1f} steps/s) on "
              f"{resolve_device(args.device)}; launches {launches}")
    bad = golden_mismatches(trace, runs, args.size)
    print(f"golden file ({args.size}): "
          + ("equal" if not bad else f"{len(bad)} mismatches: {bad[:5]}"))
    home = pte_pages_come_home({name: res.summary()
                                for name, res, _, _ in runs})
    print(f"PTE pages come home under Radiant: {home}")
    return 0 if not bad and home else 1


if __name__ == "__main__":
    raise SystemExit(main())
