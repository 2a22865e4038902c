"""Compare two trees of the PyTorch/CUDA port on one card, in turns.

    python chip_ab.py A_ROOT B_ROOT [TURNS]

Each root is a checkout of the repository (a tree's kernels build under
its own ``build/``).  The trees run in the order A, B, B, A, that order
``TURNS`` times (default 1), each run in
a process of its own that imports that tree's ``repro_torch`` and
``chip_smoke.py``, so both are measured by their own code on the same
card in one call:

  * N1 (``fast_window``) at a quickstart run-phase segment's shape
    (L = 1, 64 rows, T = 32, ``benchmark_machine()``), by the tree's own
    ``chip_smoke.fast_window_phase``, which first holds the kernel to its
    plain version on its drawn cases; where the tree has
    ``chip_smoke.WIDE_CACHES``, also at that shape on the 33-64-way
    machine;
  * a solo populate at ``chip_smoke`` [10]'s size (``REDUCED``) for each
    quickstart policy under the default engine: the profiler's device
    activities per step and the device's idle share over one populate
    window (``chip_smoke.profiled_window``), then, on ``REPS`` fresh runs,
    the wall clock and steps/s of all populate windows (host clock around
    work closed by a synchronise; the median and each run's).

Prints the card's name and power limit, one ``AB {json}`` line per run,
and a summary of each tree's mean over its runs.  Needs one CUDA
card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPS = 5           # timed populates per policy and run


def worker(root: Path) -> None:
    sys.path[:0] = [str(root / "src"), str(root)]
    import dataclasses

    import torch

    import chip_smoke as cs
    from repro_torch import quickstart as tq
    from repro_torch.core import (TieredMemSimulator, benchmark_machine,
                                  workloads)
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    out = {"root": str(root)}
    _, fw = cs.fast_window_phase(dev)
    out["fast_window_ms"] = fw["ms"]
    out["fast_window_us_per_row"] = fw["per_row_us"]
    if hasattr(cs, "WIDE_CACHES"):
        wide = dataclasses.replace(benchmark_machine(), **cs.WIDE_CACHES)
        args, kw = ref.fast_window_inputs(wide, 1, 64, 32, seed=99,
                                          device=dev)
        out["fast_window_wide_ms"] = cs.device_ms(
            lambda: ops.fast_window(*args, **kw))

    mc = benchmark_machine()
    trace = workloads.kv_store(mc, **cs.REDUCED)
    for name, pc in tq.POLICIES:
        runner = TieredMemSimulator(mc=mc, pc=pc).runner(trace)
        runner.advance(2)                  # warm: the first launches
        prof = cs.profiled_window(runner, 1)
        walls = []
        for _ in range(REPS):
            runner = TieredMemSimulator(mc=mc, pc=pc).runner(trace)
            n_pop = -(-trace.populate_steps // runner.block)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.advance(n_pop)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        steps = cs.steps_done(runner)
        wall = statistics.median(walls)
        out[name.strip()] = dict(activities_per_step=prof["per_step"],
                                 idle=prof["idle"], populate_s=wall,
                                 steps=steps, steps_per_s=steps / wall,
                                 each_steps_per_s=[steps / w for w in walls])
    print("AB " + json.dumps(out), flush=True)


def main(a: str, b: str, turns: int = 1) -> int:
    roots = [Path(a).resolve(), Path(b).resolve()]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(f"card: {card.strip().splitlines()[0]}", flush=True)
    runs = {0: [], 1: []}
    for i in (0, 1, 1, 0) * turns:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             str(roots[i])], capture_output=True, text=True, timeout=1500)
        sys.stderr.write(proc.stderr[-4000:])
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:])
            print(f"chip_ab: run of {roots[i]} failed "
                  f"(exit {proc.returncode})")
            return 1
        print(lines[-1], flush=True)
        runs[i].append(json.loads(lines[-1][3:]))
    for i, tag in ((0, "A"), (1, "B")):
        got = runs[i]
        means = {k: statistics.mean(r[k] for r in got)
                 for k in got[0] if k.startswith("fast_window")}
        for name in (k for k in got[0] if isinstance(got[0][k], dict)):
            for key in (k for k in got[0][name] if k != "each_steps_per_s"):
                means[f"{name}: {key}"] = statistics.mean(
                    r[name][key] for r in got)
        print(f"{tag} {roots[i]}: " + json.dumps(means), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(Path(sys.argv[2]).resolve())
        sys.exit(0)
    if len(sys.argv) not in (3, 4):
        sys.exit(__doc__)
    sys.exit(main(*sys.argv[1:3], *map(int, sys.argv[3:])))
