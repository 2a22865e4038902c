"""Time the quickstart ([9] of chip_smoke.py) after other work in the
same process, on one card, in turns.

    python chip_model_ab.py [ARM ...]

Each run is a process of its own that imports this checkout's
``repro_torch`` and ``chip_smoke.py``, does its arm's work, then runs
``chip_smoke.quickstart_phase()`` (Linux first-touch at full size, held to
the golden file).  The arms (default: plain model):

  * plain: one small op on the card;
  * model: ``chip_smoke.model_phase``, in the process;
  * profiler: ``torch.profiler`` recording CUDA activity around one
    small op on the card;
  * profiler_big: the same around 16,384 small ops (about as many device
    activities as [model] profiles);
  * cpu: [model]'s heaviest CPU work alone: Qwen1.5-0.5B at full width in
    f32 on the CPU (seeded params), a 2 x 32 prefill and 4 decode steps.

The arms run in the order given, then reversed (plain, model, model,
plain by default), after the kernels are built once.  Prints the card's
name and power limit, one ``AB {json}`` line per run (the populate and
run-phase seconds, host clock around work closed by a synchronise) and
each arm's mean.  Needs one CUDA card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARMS = ("plain", "model", "profiler", "profiler_big", "cpu")


def worker(arm: str) -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    if arm == "model":
        cs.model_phase(dev)
        torch.cuda.empty_cache()
    elif arm in ("profiler", "profiler_big"):
        x = torch.zeros(1, device=dev)
        with profile(activities=[ProfilerActivity.CUDA]):
            for _ in range(1 if arm == "profiler" else 16384):
                x.add_(1)
            torch.cuda.synchronize()
    elif arm == "cpu":
        import dataclasses

        from repro_torch import configs, models
        cfg = dataclasses.replace(configs.get_config("qwen1.5-0.5b"),
                                  dtype="float32")
        params = models.make_params(cfg, torch.Generator().manual_seed(1),
                                    "cpu")
        toks = torch.zeros((2, 36), dtype=torch.int32)
        _, kvs = models.prefill(cfg, params, {"tokens": toks[:, :32]})
        st = models.init_decode_state(cfg, 2, 36, device="cpu")
        st["pos0"]["k"][:, :, :32] = kvs[0][0]
        st["pos0"]["v"][:, :, :32] = kvs[0][1]
        for i in range(4):
            st, _ = models.decode_step(cfg, params, st, toks[:, 32 + i],
                                       32 + i)
        del params, kvs, st
    else:
        torch.zeros(1, device=dev).add_(1)
        torch.cuda.synchronize()
    before = time.perf_counter() - t0
    populate_s, run_s = cs.quickstart_phase()[2]
    print("AB " + json.dumps(dict(arm=arm, before_s=before,
                                  populate_s=populate_s, run_s=run_s)),
          flush=True)


def main(arms: list[str]) -> int:
    sys.path[:0] = [str(ROOT / "src")]
    from repro_torch.kernels import build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(f"card: {card.strip().splitlines()[0]}", flush=True)
    print(f"kernels built in {build.build().seconds:.1f} s", flush=True)
    runs = {arm: [] for arm in arms}
    for arm in arms + arms[::-1]:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker", arm],
            capture_output=True, text=True, timeout=600)
        sys.stderr.write(proc.stderr[-4000:])
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:])
            print(f"chip_model_ab: {arm} run failed (exit {proc.returncode})")
            return 1
        print(lines[-1], flush=True)
        runs[arm].append(json.loads(lines[-1][3:]))
    for arm, got in runs.items():
        print(f"{arm}: " + json.dumps({k: statistics.mean(r[k] for r in got)
                                       for k in ("populate_s", "run_s")}),
              flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2])
        sys.exit(0)
    arms = sys.argv[1:] or ["plain", "model"]
    if not set(arms) <= set(ARMS) or len(set(arms)) != len(arms):
        sys.exit(__doc__)
    sys.exit(main(arms))
