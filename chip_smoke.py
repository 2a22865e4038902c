#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's tiered paged-KV server, its paged decode
attention, its model stack's serving and training paths (on one device
and on a mesh), its
tiered-memory simulator (the time-blocked engine, and the per-step engine
and the sequential fault path beside it) and the simulation service over
it on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught and passed over):

1. torch / CUDA versions and the card's name and power limit;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (timed),
   and check that the SASS of ``fast_window.cu`` holds no FFMA (its f32
   chain is separate roundings, as the reference's);
3. hold each kernel against its plain PyTorch version on the card, exactly,
   at the serving path's shapes and at the shapes of tests/test_kernels.py:
   the walk (``pt_walk``, and ``pt_walk_rows_any``, the tick's gathered
   rows walked and reduced to a flag each, out-of-range queries and row
   ids included) and the copy (``block_copy``, and ``block_copy_pools``
   over 1 and 2 pool pairs at M = 1, 6, 128, blocks that are not a whole
   number of chunks, id pairs outside the pools as the JAX oracle reads
   them: counted from the end, sources clamped, destinations dropped);
4. serve at Qwen1.5-0.5B's full KV width (24 groups, 16 KV heads, d_head
   64, bf16): the ``serve_tiered`` burst, then the ``kv_tiering`` pressure
   burst with Radiant and with immobile tables, each with the launch
   counts set to 0 just before it and read just after: ``pt_walk``
   launches == decode ticks, ``block_copy`` launches == migrations that
   moved blocks (one launch for a migration's K and V pools);
5. re-run both pressure bursts on the CPU through the plain versions and
   require the card's final state to equal the CPU's, field for field;
6. time each kernel, its plain version and a one-call PyTorch yardstick
   with CUDA events in a CUDA graph, beside the least time the card could
   take: ``pt_walk`` at the tick's shape; the tick's whole walk as one
   launch against the same work as four separate ops (gather, walk,
   compare, reduce), with the eager host time of each and an empty kernel as the
   floor of one launch; the copy of K and V at the burst's mean blocks per
   migration in one launch (its eager host time also against one
   ``block_copy`` call per pool), and one pool at that M and at M = 128;
7. decode attention through ``ops.paged_attention``: (a) the kernel
   against its plain version at the shapes of tests/test_kernels.py and
   the kernel's wider domain (head dims 80 and 192, blocks of 4 and 12,
   groups of 7 and 12), with -1 table entries past each length and rows
   of length 0 (f32, bf16 and f16; bf16 and f16 also row by row against
   the f32 answer on their own inputs, ``ref.ATTN_ROW_TOL``), and the
   tensor-core kernel's CTAs per SM against the card's occupancy query;
   (b) at Qwen1.5-0.5B's (16 / 16 / 64) and Qwen2.5-14B's (40 / 8 / 128)
   full attention widths in bf16 (held both ways) and f32, 8 sequences of
   up to 4096 / 8192 tokens, the launch counts set to 0 just before each
   call and read just after; (c) the kernel (one launch per call), its
   plain version and ``scaled_dot_product_attention`` on K/V gathered
   beforehand, timed;
8. ``alloc_scan``, the simulator's allocator scan, against its plain
   version and the test mirror of its algorithm on the card, exactly:
   T = 32 on N = 4 and N = 6 nodes (and a middle tier left empty), L = 1
   and 8 lanes, every pair of data and PT policy codes, THP on and off,
   free counts near the watermark and near zero, then the crafted cases
   that cross each predicate inside a chunk (it prints how often the
   fast, slow, reclaim and failing paths occurred, and how many chunks
   were speculated and replayed); its time at the populate shape
   (speculated) and at the replay shape (near the thresholds) beside an
   empty kernel; then ``fast_window`` (N1), the fast window's inner scan,
   against its plain version, exactly (every output, and the caches and
   accumulators it writes back), on drawn segments of 1 to 256 rows,
   T = 4 and 32, L = 1 and 3, ``benchmark_machine()`` and
   ``cxl_machine()`` with THP off and on, inactive rows and OOM-killed
   states, caches of 33 to 64 ways, and three lanes with three
   CostConfigs' costs and the trace rows step-major, as the engine passes
   them; and its time at a quickstart segment's shape beside an empty
   kernel;
9. the quickstart (``repro_torch.quickstart``) on the card at full size
   under the default (blocked) engine: ``benchmark_machine()``, the
   16,384-step ``kv_store`` trace, Linux first-touch (Radiant BHi+Mig runs
   at [10]'s size in [10] and in [service] (a)), held to the golden
   file of the JAX package's outputs
   (``src/repro_torch/core/golden/quickstart.json``; the trace's digest
   first, then every summary key and the last and populate-phase rows of
   every timeline key: integers exact, cycles to rtol 1e-5), the loop
   under ``torch.cuda.set_sync_debug_mode("error")``, ``alloc_scan``
   launches == steps with a fault, ``fast_window`` launches == the fast
   segments of the window plan, whose counts (fast, full, hoist, split)
   it prints, the chunks ``alloc_scan`` replayed (its device count, read
   after the run); wall clock and steps/s per policy, populate and run
   phase apart, and (measured last, after every timed run, in profiled
   windows at [10]'s size: one populate window and four run-phase windows
   of the blocked engine) device activities per step, the device's idle
   share and the kernels' times per launch;
10. per case, the card's blocked run against its per-step run
   (``debug=True``: every state field bitwise, the timeline's integer keys
   exact, its f32 keys bitwise or else to rtol 1e-6, and which held is
   printed) and against the port's own CPU route (worker processes, each
   waited for; the script checks that it leaves no child running), field
   for field over the final state and the timeline, at footprint 2^11 and
   448 run steps: tests/test_core_oracle.py's six policies on
   ``benchmark_machine()``, ``tpp()`` and ``nomad()`` on ``cxl_machine()``;
   then sweeps at that size, each lane bitwise against its solo blocked
   run (the loop under the sync check, ``alloc_scan`` launches == the
   steps where a lane faults, ``fast_window`` launches == the plan's fast
   segments): the six policies as one 6-lane sweep, ``tpp()`` and
   ``nomad()`` as one 2-lane sweep and again with ``lane_sharding="auto"``
   (the lane mesh of the one card, run as a mesh: bitwise against the
   unsharded sweep, its launches the same), the quickstart's two
   policies as one 2-lane sweep (whole fast windows), then again through
   ``sweep_lanes`` and, BHi+Mig alone, ``TieredMemSimulator`` with a tracing
   ``Telemetry``, each against the same call without one (the same
   results bitwise, the same count of synchronising device operations
   under ``set_sync_debug_mode("warn")``, the window counters == the
   plan's, a valid trace), a 2-trace grid of 4 lanes with a mid-run free
   and three CostConfigs; a machine of 33 to 64 ways, blocked against
   per-step; then the sequential fault path against the batched one on a
   small case (footprint 2^8, 16 run steps);
[service] the simulation service (``repro_torch.service``) on the card,
   with ``repro_torch.obs.Telemetry`` on: (a) at [10]'s size (the
   quickstart's ``kv_store`` trace cut to [10]'s footprint and run steps,
   so that the script stays within its time limit; [9] holds the full
   size to the golden file), the quickstart's two policies on that trace
   as a ``TraceSpec``, each submitted three times, through one
   ``SimBroker`` flush (one ``sweep_lanes`` call of 2 lanes, one compile
   of the reference's accounting, 4 in-flight joins), each future
   bitwise against a solo blocked run of its policy on the broker's
   (idle-padded) trace,
   ``alloc_scan`` / ``fast_window`` launches == the steps with a fault /
   the plan's fast segments; the same queries again answered from the
   cache with no ``sweep_lanes`` call and no launch; the exported Perfetto
   trace validated and the snapshot's counters printed; wall clock and
   queries/s, cold against cached and against the solo runs; (b) at
   [10]'s size, its six policies as queries (mixed priorities, one
   deadline; two buckets by scan period)
   and the trace idle-padded to a power of two (a third bucket), each
   future bitwise against its solo blocked run; then a seeded
   ``fail_lane`` poisons one lane and bisection isolates it
   (``PoisonedQueryError``), the other five bitwise against [10]'s solo
   runs;
[multitenant] the multi-tenant twin (``repro_torch.multitenant_sim``, the
   paper's section 6.3 scenario: fill apps exit mid-run, AutoNUMA
   promotes, Radiant's Mig brings PTE pages home) on the card at its smoke
   size: ``benchmark_machine()`` at full width, the fill apps as at the
   full size (3,857 populate steps), the benchmark app cut to 2^12 pages
   and 256 run steps; Linux and BHi+Mig, each in a worker process of its
   own (``--multitenant-worker``, side by side), held to the port's numpy
   oracle (``repro_torch.core.ref.OracleSim``, run on the CPU meanwhile in
   a third worker, ``--oracle-worker``: summary counters and placement
   arrays exact, cycles to rtol 1e-5) and to the golden file's smoke entry
   (``src/repro_torch/core/golden/multitenant.json``); ``alloc_scan``
   launches == steps with a fault; BHi+Mig ends with more PTE pages on
   DRAM than Linux, having migrated some;
[steady] the steady-state trace of benchmarks/steady_state.py (at half its
   run steps, 1,024) under Linux
   first-touch and BHi+Mig at ``autonuma_period`` 512: the blocked and
   the per-step engine's wall clock and steps/s, the two held equal as in
   [10], and over the run phase of
   a third blocked run (profiler; its
   populate windows run first, unprofiled) device activities per step,
   the device's idle share and ``fast_window``'s device time per launch
   beside an empty kernel and its bytes bound;
[model] the model stack's serving path (``repro_torch.models``, no kernel
   of the port on it), in a process of its own (``--model-worker``,
   waited for), so that no profiling of another phase slows its
   timing and its own does not slow another's: (a) each of the ten archs at
   ``configs.reduced()``, f32 and bf16, on the card against the CPU route
   on the same seeded params: ``lm_loss``, prefill logits and one decode
   step (hubert: forward and loss), and rwkv in f32 once more with its
   time-mix steps kept in f32, held to the f32 tolerance of the rest,
   and ``moe_apply`` over two sequence chunks (S = 2 x ``seq_chunk``);
   (b) Qwen1.5-0.5B at full width (24 layers, d_model 1024, 16/16 heads,
   d_ff 2816, vocab 151,936, tied, QKV bias, bf16, seeded params):
   prefill of 8 x 512 tokens, 64 greedy decode steps with the tokens on
   the card and the loop under the sync check (no launch of the port's
   kernels), decode against ``forward`` at every position of a
   teacher-forced 2 x 64 prompt, card against CPU in f32 on a 2 x 32
   prompt and 4 decode steps (and the card again with TF32 products,
   which must fail that tolerance), each tolerance printed beside its
   measured maximum; (c) prefill and decode tokens/s, host ms a decode
   step, device activities a step and the device's idle share over 8
   profiled decode steps, beside the step's byte bound (the weights once,
   the K and V it reads, its logits);
[train] the model stack's training path (``repro_torch.data``,
   ``training``, ``checkpoint``, ``launch.train``; no kernel of the port on
   it), in a process of its own (``--train-worker``, waited for, started
   with ``CUBLAS_WORKSPACE_CONFIG`` set for deterministic algorithms):
   (a) ``data.batch_at`` at three vocabularies, glibc's ``powf`` on every
   draw and the bias corrections, card against CPU bitwise, the learning
   rate within an ulp of its peak; each of the ten archs at
   ``configs.reduced()``, f32 and bf16, B, S = 2, 64: one train step at lr
   1e-3 on the card against the CPU route on the same params and batch
   (loss, grad norm, every param, its mean error against the step's mean
   move, and every moment after the step; rwkv at three seeds), the remat
   policies "none", "dots" and "full" bitwise equal on the card (f32 and
   bf16), two microbatches against one; (b) Qwen1.5-0.5B at full width,
   bf16 params, f32 moments, remat "full", ``launch.train``'s optimizer
   defaults: 30 steps of 8 x 512 tokens from ``data.batch_at`` under the
   sync check, the losses finite and falling, ms a step and tokens/s
   (median of steps 11-30) beside the step's operations bound, the peak
   memory of one step under each remat policy, the card against the CPU
   in f32 on 2 x 32 tokens; (c) tests/test_launch.py's kill-and-resume run
   through ``python -m repro_torch.launch.train`` on the card (its two
   processes one after the other, on a thread beside (a), joined before
   (b)'s timing), and in one
   process 8 steps + checkpoint + restore + 4 steps bitwise equal to 12;
   (d) ``repro_torch.train_100m`` at its settings but 20 steps of its
   300 (the script's time limit), with its checkpoint at 20, its first
   and last logged loss and ms a step; then [dist] (below) and, last,
   device activities a step and the idle share over 3 profiled steps of
   (b);
[dist] the mesh half of the training path (``repro_torch.distributed``,
   the mesh and int8 train steps, ``checkpoint`` on DTensors, the
   launcher's mesh flags; no kernel of the port on it), in [train]'s
   process after its (d) and before its profiled steps, on a one-rank
   NCCL process group and its (1, 1) ``DeviceMesh`` (the machine has one
   card), its CPU route in five processes (``--dist-cpu-worker OUT
   PART``, one thread each, run beside [train] (a), waited for):
   (a) each of the ten archs at ``configs.reduced()`` in f32, B, S = 2,
   64, one mesh step (two microbatches, ``seq_shard``) against the
   card's one-device step ([train] (a)'s two-microbatch step; bitwise,
   under deterministic algorithms) and
   against the same step on a one-rank gloo mesh on the CPU ([train]
   (a)'s tolerances), and the int8 compressed step card against CPU
   (within two int8 quanta of the shared scale); (b) Qwen1.5-0.5B at full
   width, bf16, remat "full", two microbatches of 4 x 512 tokens, 3 steps
   each under ``DEFAULT_RULES``, ``FSDP_RULES`` and ``seq_shard``, the
   params DTensors and the backend NCCL, each bitwise equal to the
   one-device step, ms a step beside the one-device step's, every kernel
   launch count 0; the int8 compressed step at DP 1 at full width against
   one plain step (the loss equal, the moments within two int8 quanta of
   the leaf's largest plus 2^-7 for the plain step's bf16 rounding of its
   clipped grads, the params within 2 lr + 1e-4); four decode steps of B 8
   on the mesh, the cache laid out by ``kv_cache_sharding``
   (``models.model.on_cache_shards``), logits and state bitwise equal to
   the one-device steps;
   (c) the params saved from the mesh, files byte-equal to a one-device
   save, restored with ``FSDP_RULES`` placements bitwise; (d)
   ``launch.train --data 2 --model 1`` raising with the card count, and
   the card's memory equal to ``distributed.sharding.H100_HBM_BYTES``;
11. print the ``kernels`` line and, last, ``{"ok": true, "device": ...}``.

Without a CUDA device it exits 1 and prints no result.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (NVIDIA data sheet)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def device_ms(calls, reps=50, rounds=7):
    """Median device time per call: ``reps`` calls captured in one CUDA
    graph (so host launch cost is left out), replayed ``rounds`` times
    between CUDA events."""
    import torch
    calls()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            calls()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def host_ms(calls, reps=200):
    """Wall time per eager call, launch overhead included."""
    import torch
    calls()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        calls()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


# -- the simulator (phases 8-10) ---------------------------------------------

# tests/test_core_oracle.py's six policy bundles (kwargs of PolicyConfig),
# run in phase [10] on benchmark_machine(); tpp() and nomad() run there on
# cxl_machine()
ORACLE_POLICIES = [
    dict(data_policy=0, pt_policy=10, mig=False, autonuma=False),
    dict(data_policy=0, pt_policy=10, mig=False, autonuma=True,
         autonuma_period=16, autonuma_budget=32),
    dict(data_policy=1, pt_policy=12, mig=True, autonuma=True,
         autonuma_period=16, autonuma_budget=32),
    dict(data_policy=0, pt_policy=12, mig=True, autonuma=True,
         autonuma_period=16, autonuma_budget=32),
    dict(data_policy=0, pt_policy=11, mig=False, autonuma=False),
    dict(data_policy=1, pt_policy=10, mig=False, autonuma=True,
         autonuma_period=16, autonuma_budget=32, autonuma_exchange=False),
]
# the summary keys tests/test_ntier.py holds to the oracle: exact, and the
# cycle sums to rtol 1e-5
ORACLE_EXACT = ("l1_hits", "stlb_hits", "walks", "walk_mem_reads", "faults",
                "slow_allocs", "data_migrations", "demotions",
                "l4_mig_success", "l4_mig_already_dest", "l4_mig_in_dram",
                "l4_mig_sibling_guard", "l4_mig_lock_skip",
                "data_pages_dram", "data_pages_nvmm", "leaf_pages_dram",
                "leaf_pages_nvmm", "oom_killed", "oom_step",
                "data_pages_per_tier", "leaf_pages_per_tier", "shadow_pages",
                "nomad_retries", "nomad_flip_demotions", "nomad_shadow_drops")
ORACLE_CYCLES = ("total_cycles", "walk_cycles", "stall_cycles",
                 "data_mem_cycles", "fault_cycles", "migration_cycles")
# phase [10]'s trace: 96 populate and 448 run steps, one scan tick (at
# step 512, the default autonuma_period, so a hoist window) and a split
# window; its footprint is cut so that the script, [dist] and
# [multitenant] included, stays within its time limit
REDUCED = dict(footprint=1 << 11, run_steps=448)


def sim_cases():
    """(name, machine, policy) of phase [10]."""
    from repro_torch.core import config as cfg
    cases = [(f"oracle policy {i} ({cfg.PolicyConfig(**kw).label()})",
              cfg.benchmark_machine(), cfg.PolicyConfig(**kw))
             for i, kw in enumerate(ORACLE_POLICIES)]
    cases += [(f"{fn} on cxl_machine", cfg.cxl_machine(), getattr(cfg, fn)())
              for fn in ("tpp", "nomad")]
    return cases


def cpu_route_run(case: int, trace_kw: dict):
    """Phase [10]'s CPU run of ``sim_cases()[case]`` on ``kv_store(mc,
    **trace_kw)`` (one worker process, one thread): the final state and
    timeline as numpy."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core import TieredMemSimulator, workloads
    torch.set_num_threads(1)
    _, mc, pc = sim_cases()[case]
    trace = workloads.kv_store(mc, **trace_kw)
    t0 = time.perf_counter()
    res = TieredMemSimulator(mc=mc, pc=pc, device="cpu").run(trace)
    return res.final_state, res.timeline, time.perf_counter() - t0


def state_fields(state, prefix=""):
    """(name, numpy array) of every field of a SimState.to_numpy()."""
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            yield from state_fields(v, prefix + f.name + ".")
        else:
            yield prefix + f.name, v


def same_arrays(a, b) -> bool:
    """Integers and flags exact; f32 (cycles) to rtol 1e-5."""
    import numpy as np
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.kind == "f":
        return bool(np.allclose(a, b, rtol=1e-5, atol=0.0))
    return bool(np.array_equal(a, b))


def alloc_scan_phase(dev, gen_seed=8):
    """[8] alloc_scan against its plain version on the card, exactly: T = 32
    on N = 4 (benchmark_machine), N = 6 (cxl_machine, and with its middle
    tier empty, so interleaving skips it), L = 1 and 8, every pair of data
    and PT policy codes, THP on and off; free and reclaimable counts drawn
    near the watermark and near zero so that every allocation path occurs;
    then the crafted cases of ``ref.alloc_scan_cases`` that cross each
    predicate inside a chunk (T = 48 and a slot row with pads among them).
    The chunks the kernel replays equal those of the test mirror of its
    algorithm (``ref.alloc_scan_speculative_ref``), and both paths occur.
    Timed at two shapes: the populate shape (L = 1, T = 32, N = 4, a slot
    row, DRAM and NVMM far above their watermarks: speculated) and the
    replay shape (the near-threshold draw above: replayed).
    Returns (max abs err, path counts, timing at the populate shape)."""
    import numpy as np
    import torch
    from repro_torch.core import alloc as alloc_mod
    from repro_torch.core import config as cfg
    from repro_torch.kernels import alloc_scan as alloc_scan_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import pt_walk as pt_walk_mod

    rng = np.random.default_rng(gen_seed)
    T = 32
    pairs = [(d, p) for d in (cfg.FIRST_TOUCH, cfg.INTERLEAVE)
             for p in (cfg.PT_FOLLOW_DATA, cfg.PT_BIND_ALL, cfg.PT_BIND_HIGH)]
    machines = [cfg.benchmark_machine(), cfg.cxl_machine(),
                cfg.MachineConfig(n_threads=32, radix_bits=6,
                                  tier_pages_per_node=(49152, 0, 204800))]
    paths = dict(fast=0, slow=0, reclaim=0, failed=0)
    worst = 0

    def inputs(mc, codes, device):
        L, N = len(codes), mc.n_nodes
        wm = alloc_mod.watermark_pages(mc, "cpu")
        cap = torch.tensor(mc.node_capacity())
        near_wm = wm + torch.as_tensor(rng.integers(-3, 4, (L, N)))
        near_zero = torch.as_tensor(rng.integers(0, 4, (L, N)))
        free = torch.where(torch.as_tensor(rng.random((L, N)) < 0.5),
                           near_wm, near_zero).clamp(min=0)
        free = torch.where(cap > 0, free, 0).to(torch.int32)
        rec = torch.where(cap > 0, torch.as_tensor(rng.integers(0, 3, (L, N))),
                          0).to(torch.int32)
        t = (free, rec,
             torch.as_tensor(rng.integers(0, 64, L), dtype=torch.int32),
             torch.as_tensor(rng.random(L) < 0.1), wm.to(torch.int32),
             torch.tensor([d for d, _ in codes], dtype=torch.int32),
             torch.tensor([p for _, p in codes], dtype=torch.int32),
             torch.as_tensor(rng.random((L, T, 4)) < 0.3),
             torch.as_tensor(rng.random((L, T)) < 0.7))
        return [x.to(device) for x in t]

    def held(args, kw, slot_thread, what):
        """The kernel == the plain version == the test mirror on every
        output; returns the mirror's replayed chunks."""
        nonlocal worst
        want = ops.alloc_scan(*args, **kw, slot_thread=slot_thread)
        mirror = ref.alloc_scan_speculative_ref(
            *args, kw["n_threads"], kw["alloc_nodes"], kw["thp"], slot_thread)
        got = ops.alloc_scan(*[a.to(dev) for a in args], **kw,
                             slot_thread=None if slot_thread is None
                             else slot_thread.to(dev))
        for g, w, m in zip(got, want, mirror):
            g = g.cpu()
            check(g.dtype == w.dtype and torch.equal(g, w) and torch.equal(m, w),
                  f"alloc_scan {what}: kernel != plain version != mirror")
            worst = max(worst, int((g.long() - w.long()).abs().max()))
        _, slow, ok, act = want[:4]
        from_reserve = int((args[1] - want[6]).sum())
        paths["fast"] += int((act & ok & ~slow).sum())
        paths["slow"] += int((act & ok & slow).sum()) - from_reserve
        paths["reclaim"] += from_reserve
        paths["failed"] += int((act & ~ok).sum())
        return mirror[-1]

    ops.reset_launches()
    n_cases = mirror_replays = 0
    for mc_base in machines:
        for thp in (False, True):
            mc = dataclasses.replace(mc_base, page_order=6 if thp else 0)
            kw = dict(n_threads=mc.n_threads, alloc_nodes=mc.alloc_nodes,
                      thp=thp)
            lane_sets = [[pair] for pair in pairs] + [
                [pairs[(i + j) % len(pairs)] for i in range(8)]
                for j in range(2)]
            for codes in lane_sets:
                mirror_replays += held(inputs(mc, codes, "cpu"), kw, None,
                                       f"on {mc.tier_capacities} thp={thp} "
                                       f"codes {codes}")
                n_cases += 1
    random_chunks = alloc_scan_mod.chunks
    crossing = []
    for case in ref.alloc_scan_cases():
        mc = cfg.MachineConfig(**case["machine"])
        kw = dict(n_threads=mc.n_threads, alloc_nodes=mc.alloc_nodes,
                  thp=mc.page_order > 0)
        n = held(case["args"], kw, case["slot_thread"], case["name"])
        check(n == case["replays"], f"alloc_scan {case['name']}: the mirror "
              f"replays {n} chunks, not {case['replays']}")
        mirror_replays += n
        crossing.append(n)
    replayed, chunks = alloc_scan_mod.replays(), alloc_scan_mod.chunks
    check(replayed == mirror_replays, f"alloc_scan: the kernel replayed "
          f"{replayed} chunks, the mirror of its algorithm {mirror_replays}")
    check(0 < replayed < chunks, f"alloc_scan: {replayed} of {chunks} chunks "
          f"replayed: a path never occurred")
    check(all(v > 0 for v in paths.values()),
          f"alloc_scan: an allocation path never occurred: {paths}")
    log(f"[8] alloc_scan == plain version == the test mirror of its "
        f"algorithm on {n_cases} drawn cases and {len(crossing)} crafted ones "
        f"(max abs err {worst}); allocation paths: {paths}; chunks: "
        f"{chunks - replayed} speculated, {replayed} replayed of {chunks} (the "
        f"kernel's device count == the mirror's; drawn cases "
        f"{replayed - sum(crossing)} of {random_chunks}, crafted "
        f"{sum(crossing)} of {chunks - random_chunks})")

    # timing.  The populate shape: a populate step asks a data page of
    # about two threads in three and a leaf page of a few, from DRAM and
    # NVMM far above their watermarks, no OOM latched, the slot row the
    # requesting threads.  The replay shape: the near-threshold draw.
    mc = cfg.benchmark_machine()
    kw = dict(n_threads=32, alloc_nodes=mc.alloc_nodes, thp=False)
    cap = torch.tensor(mc.node_capacity(), dtype=torch.int32)
    need_pt = torch.as_tensor(rng.random((1, T, 4)) < 0.02)
    need_data = torch.as_tensor(rng.random((1, T)) < 0.67)
    asking = torch.nonzero(need_data[0] | need_pt[0].any(1))[:, 0]
    slots = torch.full((1, T), T, dtype=torch.int32)
    slots[0, :len(asking)] = asking.to(torch.int32)
    populate = [(cap * 3 // 4)[None], (cap // 100)[None],
                torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.bool),
                alloc_mod.watermark_pages(mc, "cpu"),
                torch.tensor([cfg.FIRST_TOUCH], dtype=torch.int32),
                torch.tensor([cfg.PT_FOLLOW_DATA], dtype=torch.int32),
                need_pt, need_data]
    replay = inputs(mc, [(cfg.FIRST_TOUCH, cfg.PT_FOLLOW_DATA)], "cpu")
    replay[3].fill_(False)
    timing = {}
    for shape, args, slot in (("populate", populate, slots),
                              ("replay", replay, None)):
        dargs = [a.to(dev) for a in args]
        dslot = None if slot is None else slot.to(dev)
        ops.reset_launches()
        ops.alloc_scan(*dargs, **kw, slot_thread=dslot)
        timing[shape] = dict(
            replayed=alloc_scan_mod.replays(),
            ms=device_ms(lambda: ops.alloc_scan(*dargs, **kw,
                                                slot_thread=dslot)),
            call_ms=host_ms(lambda: ops.alloc_scan(*dargs, **kw,
                                                   slot_thread=dslot)))
    check(timing["populate"]["replayed"] == 0 and
          timing["replay"]["replayed"] == 1,
          f"alloc_scan timing shapes took the wrong path: {timing}")
    floor_ms = device_ms(lambda: pt_walk_mod.empty_cuda(dev))
    dargs = [a.to(dev) for a in populate]
    plain_ms = host_ms(lambda: ref.alloc_scan_ref(
        *dargs, 32, mc.alloc_nodes, False, slots.to(dev)), reps=3)
    L, N, G = 1, mc.n_nodes, T
    # bytes the scan must move, each once: its inputs (the carry, the
    # watermarks, the two codes, the request masks, the slot row) and its
    # outputs (a node and three flags per request, a gate per thread, the
    # new carry)
    moved = (L * (2 * 4 * N + 4 + 1 + 2 * 4 + 4 * T + T + 4 * G) + 4 * N
             + L * (T * 5 * (4 + 3) + T + 2 * 4 * N + 4 + 1))
    pop, rep = timing["populate"], timing["replay"]
    result = dict(ms=pop["ms"], plain_ms=plain_ms, call_ms=pop["call_ms"],
                  floor_ms=floor_ms, bound_ms=moved / HBM_BYTES_PER_S * 1e3,
                  library_ms=None, bytes=moved, replay_ms=rep["ms"])
    log(f"[8] alloc_scan at the populate shape (L=1 T=32 N=4, a slot row of "
        f"{G}, speculated): kernel {pop['ms']:.7f} ms (eager call "
        f"{pop['call_ms']:.5f} ms); at the replay shape (free near the "
        f"watermark or 0, replayed): kernel {rep['ms']:.7f} ms (eager call "
        f"{rep['call_ms']:.5f} ms); an empty kernel {floor_ms:.7f} ms (the "
        f"floor of one launch), plain version {plain_ms:.3f} ms (eager, on "
        f"the card, populate shape), bytes bound "
        f"{result['bound_ms']:.9f} ms ({moved} B)")
    return float(worst), paths, result


def fast_window_bytes(args) -> int:
    """Bytes one ``fast_window`` launch must move on these arguments, each
    once: the trace rows and thresholds read; the placements it gathers
    (each distinct entry once); the latency tables; of each cache, the
    tags of the sets probed by the rows whose result depends on it (the L1
    dTLB's active rows, the STLB's active rows that miss the L1, the walk
    caches' walking rows), the stamps of the sets where such a probe
    misses (to pick the victim), and each tag and stamp that changes,
    written once (the chain replayed on the CPU with the plain version's
    probe); the accumulators and the counters read and written; the
    hotness counts it adds to (each distinct entry read and written); the
    row counts read and written; ``cum`` written."""
    (va, is_write, thr, oom, nodes, lat, caches, acc, counters, hot,
     row_counts), kw = args
    import torch
    from repro_torch.kernels import ref
    L, R, T = va.shape
    n_map = nodes[0].shape[1]
    rb, shift = kw["radix_bits"], kw["map_shift"]
    m = torch.where(va >= 0, va >> shift, 0).clamp(0, n_map - 1).long()
    active = (va >= 0) & ~oom[:, None, None]
    lane = torch.arange(L, device=va.device)[:, None, None]

    def distinct(idx, n, mask=None):
        key = lane * n + idx.clamp(max=n - 1)
        return int((key if mask is None else key[mask]).unique().numel())

    gathered = sum(distinct(m >> k, t.shape[1])
                   for k, t in zip((0, rb, 2 * rb, 3 * rb), nodes))
    touched = distinct(m, n_map, active) + distinct(m, n_map,
                                                    active & is_write)
    # the chain on CPU copies: which sets each cache's rows need, and
    # which entries change
    N = L * T
    state = [(t.cpu().reshape(N, *t.shape[2:]).clone(),
              r.cpu().reshape(N, *r.shape[2:]).clone()) for t, r in caches]
    before = [(t.clone(), r.clone()) for t, r in state]
    probed, missed = [[] for _ in state], [[] for _ in state]
    m_cpu, act_cpu = m.cpu().int(), active.cpu()
    for r in range(R):
        m_r, act = m_cpu[:, r].reshape(N), act_cpu[:, r].reshape(N)
        tags = (m_r, m_r, m_r >> rb, m_r >> (2 * rb))
        probes = [ref._probe_sets(c, s, tag) for (c, s), tag
                  in zip(state, tags)]
        (hit1, _), (hit2, _) = probes[:2]
        walkn = act & ~hit1 & ~hit2
        for c, ((hit, pos), on) in enumerate(zip(probes, (
                act, act & ~hit1, walkn, walkn))):
            ways = state[c][0].shape[2]
            probed[c].append((pos // ways)[on])
            missed[c].append((pos // ways)[on & ~hit])
            ref._touch(*state[c], pos, tags[c], int(kw["now0"]) + r, on)
    cache_bytes = 0
    for c, ((t1, r1), (t0, r0)) in enumerate(zip(state, before)):
        ways = t0.shape[2]
        cache_bytes += 4 * ways * (torch.cat(probed[c]).unique().numel()
                                   + torch.cat(missed[c]).unique().numel())
        cache_bytes += 4 * int((t1 != t0).sum() + (r1 != r0).sum())
    return (va.numel() * 5 + thr.numel() * 8 + L + 4 * gathered
            + sum(t.numel() * 4 for t in lat) + kw["costs"].numel() * 4
            + cache_bytes
            + 2 * 4 * (4 * L * T + 4 * L) + 2 * 4 * touched
            + 2 * 4 * 3 * L * R + 4 * L * R * 4 * T)


# fast_window's cases of more than 32 ways ([8]): the L1 dTLB 33, the STLB
# 48, the PDE walk cache 64 and the PDPTE walk cache 40, on
# benchmark_machine()'s geometry
WIDE_CACHES = dict(l1_tlb_ways=33, stlb_sets=32, stlb_ways=48,
                   pde_pwc_entries=64, pdpte_pwc_entries=40)
# three CostConfigs' (llc_hit, stlb_hit, cpu_work, data_stall_frac), one a
# lane, for [8]'s L = 3 cases
LANE_COSTS = ((40.0, 10.0, 60.0, 0.6), (55.0, 7.0, 31.0, 0.25),
              (12.0, 30.0, 90.0, 0.9))


def fast_window_phase(dev, seed=0):
    """[8] fast_window (N1), an event-free segment in one launch, against
    its plain version on the card, exactly: ``cum`` and everything it
    updates in place (caches, accumulators, counters, hotness counts, row
    counts); drawn segments of 1, 7, 64, 128 and 256 rows at T = 4 and 32,
    one and three runs (L), on ``benchmark_machine()`` and
    ``cxl_machine()`` with THP off and on, inactive rows throughout and an
    OOM-killed state (every row inactive) on each machine; then caches of
    33 to 64 ways (``WIDE_CACHES``) at 1 to 128 rows, and three runs with
    three CostConfigs' costs (``LANE_COSTS``), the trace rows laid out
    step-major as the engine passes them.  Then timed at a quickstart
    run-phase segment's shape (L = 1, 64 rows, T = 32,
    ``benchmark_machine()``) beside an empty kernel, the plain version
    (eager, on the card) and the byte bound, and at 1 and 128 rows for
    the per-row slope.  Returns (max abs err, timing)."""
    import torch
    from repro_torch.core import config as cfg
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import pt_walk as pt_walk_mod

    def updated(args):
        (_, _, _, _, _, _, caches, acc, counters, hot, row_counts) = args
        return ([t for pair in caches for t in pair] + list(acc)
                + list(counters) + list(hot) + list(row_counts))

    machines = [(f"{fn}(thp={thp})", getattr(cfg, fn)(thp=thp))
                for fn in ("benchmark_machine", "cxl_machine")
                for thp in (False, True)]
    wide = dataclasses.replace(cfg.benchmark_machine(), **WIDE_CACHES)
    cases = [(what, mc, R, T, 3 if R in (7, 128, 256) else 1, False, {})
             for what, mc in machines for R in (1, 7, 64, 128, 256)
             for T in (4, 32)]
    cases += [(what, mc, 64, 32, 1, True, {}) for what, mc in machines]
    cases += [("33-64 ways", wide, R, 32, L, False, {})
              for R in (1, 7, 64, 128) for L in (1, 3)]
    cases += [(f"{what} 3 costs", mc, R, 32, 3, False,
               dict(costs=LANE_COSTS, step_major=True))
              for what, mc in machines[::2] + [("33-64 ways", wide)]
              for R in (7, 64)]
    worst, n_cases = 0.0, 0
    ops.reset_launches()
    for what, mc, R, T, L, oom, extra in cases:
        case = seed + n_cases
        want_args, kw = ref.fast_window_inputs(mc, L, R, T, case, oom=oom,
                                               **extra)
        got_args, got_kw = ref.fast_window_inputs(mc, L, R, T, case, oom=oom,
                                                  device=dev, **extra)
        want = ops.fast_window(*want_args, **kw)
        got = ops.fast_window(*got_args, **got_kw)
        n_cases += 1
        label = f"fast_window {what} L={L} R={R} T={T} oom={oom}"
        for g, w in zip([got] + updated(got_args),
                        [want] + updated(want_args)):
            g = g.cpu()
            check(g.dtype == w.dtype and torch.equal(g, w),
                  f"{label}: kernel != plain version")
            worst = max(worst, float((g.double() - w.double()).abs().max()))
    check(ops.launch_counts()["fast_window"] == n_cases,
          "fast_window: launches != cases")
    log(f"[8] fast_window == plain version on {n_cases} drawn cases "
        f"(segments of 1 to 256 rows, T = 4 and 32, L = 1 and 3, "
        f"benchmark_machine() and cxl_machine() with THP off and on, "
        f"inactive rows, OOM-killed states; caches of 33 to 64 ways "
        f"{WIDE_CACHES}; L = 3 with three CostConfigs' costs {LANE_COSTS}, "
        f"rows step-major): cum and every cache, accumulator, counter, "
        f"hotness count and row count exact (max abs err {worst})")

    mc = cfg.benchmark_machine()
    L, R, T = 1, 64, 32
    args, kw = ref.fast_window_inputs(mc, L, R, T, seed=99, device=dev)

    def kernel():
        ops.fast_window(*args, **kw)

    def plain():
        ref.fast_window_ref(*args, **kw)

    cache_bytes = sum(t.numel() + r.numel() for t, r in args[6]) * 4
    moved = fast_window_bytes((args, kw))
    result = dict(ms=device_ms(kernel), call_ms=host_ms(kernel),
                  floor_ms=device_ms(lambda: pt_walk_mod.empty_cuda(dev)),
                  plain_ms=host_ms(plain, reps=3),
                  bound_ms=moved / HBM_BYTES_PER_S * 1e3, library_ms=None,
                  bytes=moved)
    # the same launch at 1 and 128 rows: the caches' load and write-back
    # and the launch against the rows' chain
    by_rows = {}
    for rows in (1, 128):
        a, k = ref.fast_window_inputs(mc, L, rows, T, seed=99, device=dev)
        by_rows[rows] = device_ms(lambda: ops.fast_window(*a, **k))
    per_row = (by_rows[128] - by_rows[1]) / 127
    result.update(rows_1_ms=by_rows[1], rows_128_ms=by_rows[128],
                  per_row_us=per_row * 1e3)
    log(f"[8] fast_window at a quickstart segment's shape (L=1, R=64, T=32, "
        f"benchmark_machine(), {cache_bytes} B of caches): kernel "
        f"{result['ms']:.7f} ms (eager call {result['call_ms']:.5f} ms), an "
        f"empty kernel {result['floor_ms']:.7f} ms (the floor of one "
        f"launch), plain version {result['plain_ms']:.3f} ms (eager, on the "
        f"card), bytes bound {result['bound_ms']:.9f} ms ({moved} B); at 1 "
        f"row {by_rows[1]:.7f} ms, at 128 rows {by_rows[128]:.7f} ms, so "
        f"{per_row * 1e3:.4f} us a row")
    return worst, result


class sync_error:
    """``torch.cuda.set_sync_debug_mode("error")`` inside the block: a
    device read there raises."""

    def __enter__(self):
        import torch
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        import torch
        torch.cuda.set_sync_debug_mode(0)


def counted_syncs(fn):
    """(``fn()``, the synchronising device operations it made: under
    ``torch.cuda.set_sync_debug_mode("warn")`` each one warns)."""
    import warnings

    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchronizing CUDA operation" in str(w.message)
                    for w in caught)


def steps_done(runner) -> int:
    """Steps a runner (blocked or per-step) has run."""
    return getattr(runner, "stepper", runner).s


def device_events(prof):
    """The device activities (kernels, copies, fills) a profile recorded;
    fails if there are none."""
    from torch.autograd import DeviceType
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(len(events) > 0, "the profiler recorded no device activity")
    return events


def idle_share(events) -> float:
    """The part of the span from the first device activity to the last
    that no activity covers."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    busy += hi - lo
    return 1 - busy / (max(b for _, b in spans) - spans[0][0])


def profiled_window(runner, k):
    """Over the runner's next ``k`` windows (blocked) or steps (per-step),
    from the profiler: device activities (kernels, copies, fills) per
    step, the device's idle share (the part of the span from the window's
    first device activity to its last that no activity covers), and, of
    alloc_scan and fast_window, the launches (the wrappers' counts: the
    profiler may drop an event) and the mean ms of the launches that the
    profiler recorded, and how many it recorded (``<name>_recorded``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    s0 = steps_done(runner)
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        runner.advance(k)
        torch.cuda.synchronize()
    launched = ops.launch_counts()
    steps = steps_done(runner) - s0
    events = device_events(prof)
    out = dict(steps=steps, per_step=len(events) / steps,
               idle=idle_share(events))
    for name in ("alloc_scan", "fast_window"):
        t = [e.time_range.elapsed_us() for e in events if name in e.name]
        out[name] = (launched[name], sum(t) / len(t) / 1e3 if t else 0.0)
        out[name + "_recorded"] = len(t)
    return out


def launch_count_phase(replays):
    """[9]'s device activities per step, idle share and kernel device times,
    measured last, so that the profiler's hooks can slow no timed run: for
    each quickstart policy, a fresh run of its machine at [10]'s size (the
    same step kinds: a populate step, a fault on most threads; a
    run-phase step, no fault) under the default (blocked) engine, its
    first populate window (64 steps, replayed step by step) and four
    run-phase windows (fast windows).  ``replays`` is (replayed, chunks)
    of each policy's timed run."""
    from repro_torch import quickstart as tq
    from repro_torch.core import TieredMemSimulator, benchmark_machine, workloads
    mc = benchmark_machine()
    trace = workloads.kv_store(mc, **REDUCED)
    p = trace.populate_steps
    for name, pc in tq.POLICIES:
        runner = TieredMemSimulator(mc=mc, pc=pc).runner(trace)
        block = runner.block
        pop = profiled_window(runner, 1)          # the first populate window
        runner.advance(-(-p // block) - runner.w)
        run = profiled_window(runner, 4)
        check(pop["alloc_scan"][0] == pop["steps"] == block,
              f"{name}: {pop['alloc_scan'][0]} alloc_scan launches in a "
              f"populate window of {pop['steps']} steps")
        check(run["fast_window"][0] > 0,
              f"{name}: no fast_window launch in the run-phase windows")
        timed = ""
        if name in replays:            # the policy [9] ran at full size
            replayed, chunks = replays[name]
            timed = (f", so about {pop['alloc_scan'][1] * chunks / 1e3:.4f} "
                     f"s over the {chunks} launches of the timed run, which "
                     f"replayed {replayed} of its {chunks} chunks")
        log(f"[9] {name.strip()} (profiler, after [10], a fresh run at "
            f"[10]'s size): blocked engine, device activities per step: "
            f"populate {pop['per_step']:.1f} (a window of {pop['steps']} "
            f"steps), run phase {run['per_step']:.2f} ({run['steps']} steps, "
            f"{run['fast_window'][0]} fast_window launches of "
            f"{run['fast_window'][1]:.7f} ms each over the "
            f"{run['fast_window_recorded']} the profiler recorded); device "
            f"idle share: populate {pop['idle']:.4f}, run phase "
            f"{run['idle']:.4f}; alloc_scan {pop['alloc_scan'][1]:.7f} ms per "
            f"launch in the populate window (over the "
            f"{pop['alloc_scan_recorded']} of its {pop['alloc_scan'][0]} "
            f"launches the profiler recorded){timed}")


def quickstart_phase():
    """[9] the quickstart on the card at full size under the default
    (blocked) engine, Linux first-touch alone (BHi+Mig runs at [10]'s
    size, solo and in [service] (a)), held to the golden
    file of the JAX package's outputs; the populate windows and the
    run-phase windows timed apart.  Returns the launches of each kernel,
    and per policy (chunks replayed, chunks) of alloc_scan in its timed
    run (the device count read once, after the run)."""
    import torch
    from repro_torch import quickstart as tq
    from repro_torch.core import (TieredMemSimulator, benchmark_machine,
                                  fault_step_mask, trace_digest)
    from repro_torch.kernels import alloc_scan as alloc_scan_mod
    from repro_torch.kernels import ops

    golden = tq.load_golden()
    mc = benchmark_machine()
    t0 = time.perf_counter()
    trace = tq.quickstart_trace(mc)
    check(trace_digest(trace) == golden["trace"]["digest"],
          "the quickstart trace's digest differs from the golden file's")
    fault_steps = int(fault_step_mask(trace, mc).sum())
    check(fault_steps == golden["trace"]["fault_steps"],
          f"fault steps {fault_steps} != golden {golden['trace']['fault_steps']}")
    p, S = trace.populate_steps, trace.n_steps
    log(f"[9] quickstart trace: {S} steps ({p} populate, {fault_steps} with a "
        f"fault) x {mc.n_threads} threads, n_map {mc.n_map}; digest matches "
        f"the golden file; trace and schedule {time.perf_counter() - t0:.1f} s")
    launches, base, replays = {"alloc_scan": 0, "fast_window": 0}, None, {}
    for name, pc in tq.POLICIES[:1]:
        sim = TieredMemSimulator(mc=mc, pc=pc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner = sim.runner(trace)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pop_windows = -(-p // runner.block)
        ops.reset_launches()
        with sync_error():
            runner.advance(pop_windows)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        before = dict(runner.host_s)
        with sync_error():
            runner.advance()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        host = {k: runner.host_s[k] - before[k] for k in before}
        ran = [op for win in runner.ops[pop_windows:] for op, _, _ in win]
        segs, ticks = ran.count("fast"), ran.count("scan")
        counts = ops.launch_counts()
        replays[name] = (alloc_scan_mod.replays(), alloc_scan_mod.chunks)
        res = runner.result()
        t4 = time.perf_counter()
        check(counts["alloc_scan"] == fault_steps,
              f"{name}: alloc_scan launches {counts['alloc_scan']} != "
              f"{fault_steps} steps with a fault")
        check(counts["fast_window"] == runner.fast_segments > 0,
              f"{name}: fast_window launches {counts['fast_window']} != "
              f"{runner.fast_segments} fast segments of the plan")
        for k in launches:
            launches[k] += counts[k]
        bad = tq.mismatches({"label": pc.label(), **tq.outputs(res, trace)},
                            golden["policies"][name])
        check(not bad, f"{name}: differs from the golden file: {bad[:8]}")
        if base is None:
            base = tq.run_phase(res, trace)[0]
        n_pop = min(pop_windows * runner.block, S)
        fast, full, hoist, split = runner.plan.counts
        log(f"[9] {tq.report_line(name.strip(), res, trace, base)}")
        log(f"[9] {name.strip()}: == golden file (every summary key and the "
            f"last and populate rows of every timeline key; integers exact, "
            f"cycles to rtol 1e-5); {runner.plan.n_windows} windows of "
            f"{runner.block}: {fast} fast, {full} full, {hoist} hoist, "
            f"{split} split; {runner.fast_segments} fast segments; launches "
            f"{counts}; under set_sync_debug_mode('error'): populate "
            f"{t2 - t1:.2f} s for {n_pop} steps ({n_pop / (t2 - t1):.1f} "
            f"steps/s), run phase {t3 - t2:.3f} s for {S - n_pop} steps "
            f"({(S - n_pop) / (t3 - t2):.1f} steps/s), whole {t3 - t1:.2f} s "
            f"({S / (t3 - t1):.1f} steps/s); set-up {t1 - t0:.2f} s, result "
            f"{t4 - t3:.2f} s; alloc_scan replayed {replays[name][0]} of "
            f"{replays[name][1]} chunks")
        log(f"[9] {name.strip()}: run phase host time by segment kind "
            f"(issuing the work; the loop never waits on the device): fast "
            f"segments {host['fast']:.4f} s ({segs} launches, "
            f"{host['fast'] / max(segs, 1) * 1e3:.4f} ms each), scan ticks "
            f"{host['scan']:.4f} s ({ticks} ticks, "
            f"{host['scan'] / max(ticks, 1) * 1e3:.3f} ms each), step spans "
            f"{host['steps']:.4f} s; the rest of the run phase's "
            f"{t3 - t2:.4f} s is waiting for the device and the loop itself "
            f"({t3 - t2 - sum(host.values()):.4f} s)")
    return launches, replays


def service_phase(solo10):
    """[service] the simulation service on the card: ``SimQuery`` ->
    ``SimBroker.submit`` / ``drain`` -> one ``sweep_lanes`` call per
    bucket flush -> the lanes' ``BlockedRunner`` and its kernels ->
    futures and the result cache, with ``Telemetry`` on.

    (a) At [10]'s size (the full size, a second 100 s run of [9]'s
    populate loop, would take the script past its time limit): the
    quickstart's two policies on ``benchmark_machine()`` and its
    ``kv_store`` trace at [10]'s footprint and run steps as a
    ``TraceSpec``, each submitted three times (in-flight joins): one
    bucket, one flush, one ``sweep_lanes`` call of 2 lanes, one compile of
    the reference's accounting; each future bitwise against a solo blocked
    run of its policy on the broker's canonical (idle-padded) trace;
    ``alloc_scan`` launches == the steps with a fault, ``fast_window``
    launches == the plan's fast segments (counts set to 0 just before the
    round and read just after).  A second round of the same queries is
    answered from the cache: no ``sweep_lanes`` call, no launch.  The
    exported Perfetto trace passes ``validate_trace_events``; the
    snapshot's counters are printed; wall clock and queries/s, cold
    against cached, beside the solo runs.

    (b) At [10]'s size: the six policies of [10] as queries on [10]'s
    trace (two buckets: the scan period splits them) with mixed
    priorities and one deadline, and the trace idle-padded to the next
    power of two under the first policy (a third bucket, of another
    shape); each future bitwise against [10]'s solo blocked run of its
    policy (``solo10``), the padded one against a solo run made here.
    Then a seeded ``FaultInjector`` poisons one lane of a fresh broker
    (``fail_lane`` at ``sweep.device``): bisection isolates it, its future
    fails with ``PoisonedQueryError`` and the other five equal their
    solo runs.  Returns the launches of (a)'s cold round."""
    import random
    import tempfile

    from repro_torch import quickstart as tq
    from repro_torch.core import (CostConfig, TraceSpec, TieredMemSimulator,
                                  benchmark_machine, fault_step_mask,
                                  pad_trace, sim, workloads)
    from repro_torch.kernels import ops
    from repro_torch.obs import (FaultInjector, Telemetry, fail_lane,
                                 validate_trace_events)
    from repro_torch.service import (PoisonedQueryError, SimBroker,
                                     SimQuery)

    t_phase = time.perf_counter()
    mc = benchmark_machine()
    spec = TraceSpec(workload="memcached", **REDUCED)
    names, pols = zip(*tq.POLICIES)
    queries = [SimQuery(trace=spec, policy=pc, machine=mc)
               for _ in range(3) for pc in pols]
    tel = Telemetry(tracing=True)
    broker = SimBroker(max_lanes=64, max_wait=1e9, telemetry=tel)
    trace = broker.canonical_trace(queries[0])
    solos = [timed_run(TieredMemSimulator(mc=mc, pc=pc), trace)
             for pc in pols]
    fault_steps = int(fault_step_mask(trace, mc).sum())
    # the flush's plan, made by the engine itself (not through
    # sweep_runner, which would record the broker's compile signature)
    segments = sim.BlockedRunner(mc, [CostConfig()] * len(pols), pols,
                                 [trace] * len(pols)).fast_segments
    ops.reset_launches()
    t0 = time.perf_counter()
    futs = broker.submit_many(queries)
    broker.drain()
    cold_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    st, m = broker.stats, tel.metrics
    check((st.flushes, st.lanes_run, st.pad_lanes, st.inflight_joins,
           st.compiles) == (1, 2, 0, 4, 1),
          f"[service] (a) expected one flush of 2 lanes, no pad, 4 joins, "
          f"one compile: {st}")
    check(m.value("sweep.calls", engine="blocked") == 1
          and m.value("sweep.lanes", engine="blocked") == 2,
          "[service] (a) expected one sweep_lanes call of 2 lanes")
    check(counts["alloc_scan"] == fault_steps,
          f"[service] (a) alloc_scan launches {counts['alloc_scan']} != "
          f"{fault_steps} steps with a fault")
    check(counts["fast_window"] == segments > 0,
          f"[service] (a) fast_window launches {counts['fast_window']} != "
          f"{segments} fast segments of the plan")
    for i, f in enumerate(futs):
        check(f.result() is futs[i % len(pols)].result(),
              f"[service] (a) query {i}: not joined onto its lane")
    lanes_bitwise([f.result() for f in futs[:len(pols)]],
                  [r for r, _, _ in solos], "[service] (a)")
    base = tq.run_phase(futs[0].result(), trace)[0]
    for name, f in zip(names, futs):
        log(f"[service] (a) {tq.report_line(name.strip(), f.result(), trace, base)}")

    ops.reset_launches()
    t0 = time.perf_counter()
    futs2 = broker.submit_many(queries)
    broker.drain()
    cached_s = time.perf_counter() - t0
    counts2 = ops.launch_counts()
    check(all(f.from_cache and f.result() is g.result()
              for f, g in zip(futs2, futs)),
          "[service] (a) second round not answered from the cache")
    check(m.value("sweep.calls", engine="blocked") == 1
          and broker.stats.flushes == 1 and not any(counts2.values()),
          f"[service] (a) the cached round ran work: {counts2}")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "service_trace.json"
        check(tel.export_trace(path), "[service] (a) no trace exported")
        obj = json.loads(path.read_text())
    problems = validate_trace_events(obj)
    check(not problems, f"[service] (a) trace: {problems[:5]}")
    spans = [e["name"] for e in obj["traceEvents"] if e.get("ph") == "X"]
    counters = {k: v for k, v in tel.snapshot()["metrics"].items()
                if not isinstance(v, dict)}
    hists = {k: (v["count"], round(v.get("sum", 0.0), 4))
             for k, v in tel.snapshot()["metrics"].items()
             if isinstance(v, dict)}
    n, solo_s = len(queries), [t for _, _, t in solos]
    log(f"[service] (a) {n} queries ({len(pols)} policies x 3) at [10]'s "
        f"size ({spec.build(mc).n_steps} steps, idle-padded to "
        f"{trace.n_steps}) "
        f"through one flush of {st.lanes_run} lanes: each future == its "
        f"solo blocked run bitwise; launches {counts} ({segments} fast "
        f"segments of the plan); cold round {cold_s:.2f} s "
        f"({n / cold_s:.4f} queries/s; the solo runs {solo_s[0]:.2f} and "
        f"{solo_s[1]:.2f} s), cached round {cached_s * 1e3:.3f} ms "
        f"({n / cached_s:.1f} queries/s), launches {counts2}; trace "
        f"{len(obj['traceEvents'])} events, {len(spans)} spans, valid")
    log(f"[service] (a) counters {json.dumps(counters, sort_keys=True)}")
    log(f"[service] (a) histograms (count, sum s) "
        f"{json.dumps(hists, sort_keys=True)}")
    launches = counts

    # (b) [10]'s size: two buckets by scan period, a third by shape
    cases = sim_cases()[:len(ORACLE_POLICIES)]
    mc = cases[0][1]
    trace = workloads.kv_store(mc, **REDUCED)
    padded = pad_trace(trace, sim.pow2ceil(trace.n_steps))
    check(padded.n_steps > trace.n_steps, "[service] (b) nothing to pad")
    qs = [SimQuery(trace=trace, policy=pc, machine=mc, priority=i % 3,
                   deadline=(time.monotonic() + 3600.0 if i == 3 else None))
          for i, (_, _, pc) in enumerate(cases)]
    q_pad = SimQuery(trace=padded, policy=cases[0][2], machine=mc,
                     priority=1)
    b = SimBroker(max_lanes=64, max_wait=1e9)
    t0 = time.perf_counter()
    futs = b.submit_many(qs + [q_pad])
    b.drain()
    burst_s = time.perf_counter() - t0
    pad_solo, _, pad_s = timed_run(TieredMemSimulator(mc=mc, pc=cases[0][2]),
                                   padded)
    lanes_bitwise([f.result() for f in futs], solo10[:len(qs)] + [pad_solo],
                  "[service] (b)")
    check((b.stats.flushes, b.stats.lanes_run) == (3, len(qs) + 1),
          f"[service] (b) expected 3 flushes of {len(qs) + 1} lanes: "
          f"{b.stats}")
    log(f"[service] (b) {len(qs) + 1} queries at [10]'s size ({trace.n_steps}"
        f" steps; the padded one {padded.n_steps}): 3 buckets (scan period "
        f"0 and 16, and the padded shape), each future == its solo blocked "
        f"run bitwise ([10]'s, and one made here for the padded trace in "
        f"{pad_s:.2f} s); {b.stats.flushes} flushes, {b.stats.lanes_run} "
        f"lanes, {b.stats.pad_lanes} pad lanes, {b.stats.compiles} "
        f"compiles; {burst_s:.2f} s ({len(futs) / burst_s:.3f} queries/s)")

    rng = random.Random(22)
    bad_i = rng.choice([i for i, q in enumerate(qs) if q.policy.autonuma])
    digest = b.query_digest(qs[bad_i])
    tel_b = Telemetry()
    b2 = SimBroker(max_lanes=64, max_wait=1e9, telemetry=tel_b,
                   injector=FaultInjector([fail_lane("sweep.device", digest)]),
                   sleep=lambda s: None)
    t0 = time.perf_counter()
    futs = b2.submit_many(qs)
    b2.drain()
    bisect_s = time.perf_counter() - t0
    try:
        futs[bad_i].result()
        check(False, "[service] (b) the poisoned lane resolved")
    except PoisonedQueryError as exc:
        check(exc.digest == digest, f"[service] (b) poisoned {exc.digest}, "
              f"not {digest}")
    good = [i for i in range(len(qs)) if i != bad_i]
    lanes_bitwise([futs[i].result() for i in good], [solo10[i] for i in good],
                  "[service] (b) bisection")
    check(b2.stats.quarantined == 1 and b2.quarantine.digests() == [digest],
          f"[service] (b) quarantine {b2.quarantine.digests()}")
    log(f"[service] (b) fail_lane at sweep.device on query {bad_i} "
        f"({qs[bad_i].policy.label()}, seed 22): PoisonedQueryError with "
        f"its digest {digest}, the other {len(good)} == their solo runs "
        f"bitwise; {tel_b.metrics.value('broker.bisect_runs')} bisection "
        f"runs, {b2.stats.lanes_run} lanes run, {b2.stats.pad_lanes} pad "
        f"lanes, injected {b2.injector.stats()['injected']}; "
        f"{bisect_s:.2f} s")
    log(f"[service] total {time.perf_counter() - t_phase:.1f} s")
    return launches


def oracle_worker(out: str) -> int:
    """[multitenant]'s worker (``chip_smoke.py --oracle-worker OUT``): the
    port's numpy oracle (``repro_torch.core.ref.OracleSim``) on the CPU
    for both policies of the multi-tenant twin at its smoke size; pickles
    each policy's summary and placement arrays into the file OUT."""
    import pickle
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import multitenant_sim as tm
    from repro_torch.core import CostConfig, benchmark_machine
    from repro_torch.core.ref import PLACEMENTS, OracleSim
    mc = benchmark_machine()
    trace = tm.multitenant_trace(mc, "smoke")
    got = {}
    for name, pc in tm.POLICIES:
        t0 = time.perf_counter()
        oracle = OracleSim(mc, CostConfig(), pc)
        oracle.run(trace)
        got[name] = (oracle.summary(),
                     {k: getattr(oracle, a) for k, a in PLACEMENTS},
                     time.perf_counter() - t0)
    with open(out, "wb") as f:
        pickle.dump(got, f)
    return 0


def multitenant_worker(name: str, out: str) -> int:
    """[multitenant]'s card worker (``chip_smoke.py --multitenant-worker
    POLICY OUT``): ``multitenant_sim.run`` of the one policy at the smoke
    size on the card; pickles its (name, result, seconds, launches) into
    the file OUT."""
    import pickle
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import multitenant_sim as tm
    _, runs = tm.run("smoke", names=[name])
    with open(out, "wb") as f:
        pickle.dump(runs[0], f)
    return 0


def multitenant_phase():
    """[multitenant] the twin of examples/multitenant_sim.py
    (``repro_torch.multitenant_sim.run``) on the card at its smoke size:
    ``benchmark_machine()`` at full width (32 threads), the fill apps as
    at the full size and the benchmark app cut to 2^12 pages and 256 run
    steps, one run per policy, each in a worker process of its own
    (``--multitenant-worker``; the two loops are host-bound and leave the
    card idle most of the time, so they run side by side); each held to
    the port's numpy oracle (``core/ref.py``, run on the CPU in a third
    worker meanwhile: summary counters and placement arrays exact, cycles
    to rtol 1e-5) and to the golden file's smoke entry (the JAX package's
    run); launches == steps with a fault; Radiant brings PTE pages home.
    Every worker is waited for, and killed first if the phase fails.
    Returns the launches of each kernel."""
    import os
    import pickle
    import tempfile

    import numpy as np
    from repro_torch import multitenant_sim as tm
    from repro_torch.core import (benchmark_machine, fault_step_mask,
                                  trace_digest)
    from repro_torch.core.ref import PLACEMENTS

    t0 = time.perf_counter()
    mc = benchmark_machine()
    trace = tm.multitenant_trace(mc, "smoke")
    fault_steps = int(fault_step_mask(trace, mc).sum())
    golden = tm.load_golden()["sizes"]["smoke"]
    check(golden["trace"]["digest"] == trace_digest(trace),
          "[multitenant] the trace's digest differs from the golden file's")
    launches = {"alloc_scan": 0, "fast_window": 0}
    me = str(Path(__file__).resolve())
    with tempfile.TemporaryDirectory() as tmp:
        outs = [str(Path(tmp) / f"{i}.pkl") for i in range(3)]
        workers = [subprocess.Popen(
            [sys.executable, me, "--oracle-worker", outs[0]],
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))]
        workers += [subprocess.Popen(
            [sys.executable, me, "--multitenant-worker", name, out])
            for (name, _), out in zip(tm.POLICIES, outs[1:])]
        try:
            for w in workers:
                check(w.wait(timeout=900) == 0,
                      f"[multitenant] a worker ({' '.join(w.args[2:4])}) "
                      f"exited {w.returncode}")
        finally:
            for w in workers:
                if w.poll() is None:
                    w.kill()
                w.wait()
        loaded = []
        for out in outs:
            with open(out, "rb") as f:
                loaded.append(pickle.load(f))
    oracle, runs = loaded[0], loaded[1:]
    bad = tm.golden_mismatches(trace, runs, "smoke")
    check(not bad, f"[multitenant] differs from the golden file: {bad[:8]}")
    for name, res, seconds, counts in runs:
        want, arrays, oracle_s = oracle[name]
        s = res.summary()
        off = [k for k in ORACLE_EXACT if s[k] != want[k]]
        off += [k for k in ORACLE_CYCLES
                if not np.isclose(s[k], want[k], rtol=1e-5, atol=0.0)]
        off += [k for k, _ in PLACEMENTS
                if not np.array_equal(getattr(res.final_state, k), arrays[k])]
        check(not off, f"[multitenant] {name}: card != the port's oracle "
                       f"on {off}")
        check(counts["alloc_scan"] == fault_steps,
              f"[multitenant] {name}: alloc_scan launches "
              f"{counts['alloc_scan']} != {fault_steps} steps with a fault")
        check(counts["fast_window"] > 0,
              f"[multitenant] {name}: no fast_window launch")
        for k in launches:
            launches[k] += counts[k]
        log(f"[multitenant] {tm.report_line(name, res, trace)}")
        log(f"[multitenant] {name}: {trace.n_steps} steps "
            f"({trace.populate_steps} populate, {fault_steps} with a fault) "
            f"x {mc.n_threads} threads in {seconds:.2f} s "
            f"({trace.n_steps / seconds:.1f} steps/s, beside the other "
            f"policy's worker); launches {counts}; == the port's "
            f"oracle ({len(ORACLE_EXACT)} summary counters and "
            f"{len(PLACEMENTS)} placement arrays exact, "
            f"{len(ORACLE_CYCLES)} cycle keys to rtol 1e-5; the oracle "
            f"{oracle_s:.1f} s on the CPU) == the golden file's smoke entry")
    summaries = {name: res.summary() for name, res, _, _ in runs}
    check(tm.pte_pages_come_home(summaries),
          "[multitenant] Radiant's PTE pages did not come home")
    log(f"[multitenant] PTE pages on DRAM: " + ", ".join(
        f"{n} {v['leaf_pages_dram']} ({v['l4_mig_success']} migrated)"
        for n, v in summaries.items())
        + f"; {time.perf_counter() - t0:.1f} s")
    return launches


def cpu_route_worker(case: int, out: str) -> int:
    """Phase [10]'s worker (``chip_smoke.py --cpu-route-worker CASE OUT``):
    pickles ``cpu_route_run(CASE, REDUCED)`` into the file OUT."""
    import pickle
    result = cpu_route_run(case, REDUCED)
    with open(out, "wb") as f:
        pickle.dump(result, f)
    return 0


def model_worker() -> int:
    """[model] in a process of its own (``chip_smoke.py --model-worker``).
    After ``torch.profiler`` has recorded many device activities, every
    later launch of its process costs more host time
    (``chip_model_ab.py``: [9]'s populate a fifth slower after profiling
    16,384 launches and a third after [model], unchanged after profiling
    one launch or after [model]'s CPU work), so [model] is
    neither timed after the profiled phases of this script nor lets its
    own profiled decode steps slow a phase after it."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    model_phase(torch.device("cuda"))
    return 0


def live_children() -> list[str]:
    """The command lines of this process's children that are still alive
    (from /proc)."""
    import os
    me, found = str(os.getpid()), []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
            if fields[1] == me and fields[0] != "Z":
                found.append((stat.parent / "cmdline").read_bytes()
                             .replace(b"\0", b" ").decode().strip())
        except (OSError, IndexError):
            pass                                # the process ended meanwhile
    return found


def engines_agree(a, b, what):
    """Two card runs, the blocked engine's ``a`` and the per-step engine's
    (or the other fault path's) ``b``: every state field bitwise, the
    timeline's integer keys exact, its f32 keys bitwise or, if not, to
    rtol 1e-6.  Returns "bitwise" or "rtol 1e-6" for the f32 keys."""
    import numpy as np
    fa, fb = dict(state_fields(a.final_state)), dict(state_fields(b.final_state))
    check(fa.keys() == fb.keys(), f"{what}: fields")
    bad = [k for k in fa if not (fa[k].dtype == fb[k].dtype
                                 and np.array_equal(fa[k], fb[k]))]
    check(not bad, f"{what}: state fields differ: {bad}")
    exact = True
    for k, x in a.timeline.items():
        y = b.timeline[k]
        check(x.dtype == y.dtype and x.shape == y.shape, f"{what}: tl/{k}")
        if np.array_equal(x, y):
            continue
        exact = False
        check(x.dtype.kind == "f" and np.allclose(x, y, rtol=1e-6, atol=0.0),
              f"{what}: timeline {k} differs")
    return "bitwise" if exact else "rtol 1e-6"


def timed_run(sim, trace):
    """(result, runner, seconds) of one run on the card, the loop under the
    sync check."""
    import torch
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner = sim.runner(trace)
    ops.reset_launches()
    with sync_error():
        runner.advance()
    torch.cuda.synchronize()
    return runner.result(), runner, time.perf_counter() - t0


def cpu_route_phase(width=8):
    """[10] per case, the card's blocked run against its per-step run
    (``debug=True``; ``engines_agree``) and against the port's own CPU
    route, field for field over the final state and the timeline, at a
    reduced size; the CPU runs go to worker processes (this script with
    ``--cpu-route-worker``, ``width`` at a time) while the card runs every
    case, and are read once the card is done with all of them.  Every
    worker is waited for, and killed first if the phase fails, so none
    outlives it.  Then one small case (``benchmark_machine()``,
    footprint 2^8, 16 run steps) adds the sequential fault path against
    the batched one on the card.  Returns how the f32 timeline keys held
    between the engines."""
    import os
    import pickle
    import tempfile

    from repro_torch.core import (TieredMemSimulator, benchmark_machine,
                                  bhi_mig, fault_step_mask, workloads)
    from repro_torch.kernels import ops

    cases = sim_cases()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")     # the CPU route only
    procs: list[subprocess.Popen] = []
    held, solo = [], []

    def top_up(tmp):
        while (len(procs) < len(cases)
               and sum(p.poll() is None for p in procs) < width):
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--cpu-route-worker", str(len(procs)),
                 str(Path(tmp) / f"{len(procs)}.pkl")], env=env))

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            top_up(tmp)
            ran = []
            for name, mc, pc in cases:
                trace = workloads.kv_store(mc, **REDUCED)
                fault_steps = int(fault_step_mask(trace, mc).sum())
                card, runner, blocked_s = timed_run(
                    TieredMemSimulator(mc=mc, pc=pc), trace)
                solo.append(card)
                counts = ops.launch_counts()
                check(counts["alloc_scan"] == fault_steps,
                      f"[10] {name}: alloc_scan launches != steps with a fault")
                check(counts["fast_window"] == runner.fast_segments,
                      f"[10] {name}: fast_window launches != fast segments")
                per_step, _, per_step_s = timed_run(
                    TieredMemSimulator(mc=mc, pc=pc, engine="per_step",
                                       debug=True), trace)
                held.append(engines_agree(
                    card, per_step, f"[10] {name}: blocked vs per-step"))
                ran.append((trace, runner, counts, blocked_s, per_step_s))
                top_up(tmp)
            for i, (name, _, _) in enumerate(cases):
                trace, runner, counts, blocked_s, per_step_s = ran[i]
                card = solo[i]
                while len(procs) <= i or procs[i].poll() is None:
                    top_up(tmp)
                    time.sleep(0.2)
                top_up(tmp)
                rc = procs[i].returncode
                check(rc == 0, f"[10] {name}: the CPU route's worker "
                      f"exited with {rc}")
                with open(Path(tmp) / f"{i}.pkl", "rb") as f:
                    state, timeline, cpu_s = pickle.load(f)
                fields = dict(state_fields(card.final_state))
                cpu_fields = dict(state_fields(state))
                check(fields.keys() == cpu_fields.keys(),
                      f"[10] {name}: fields")
                bad = [k for k in fields
                       if not same_arrays(fields[k], cpu_fields[k])]
                bad += [f"timeline.{k}" for k in timeline
                        if not same_arrays(card.timeline[k], timeline[k])]
                check(not bad, f"[10] {name}: card != CPU route on {bad}")
                s = card.summary()
                log(f"[10] {name}: card blocked == card per-step (state "
                    f"bitwise, integer timeline keys exact, f32 keys "
                    f"{held[i]}) == CPU route on all {len(fields)} "
                    f"state fields and {len(timeline)} timeline keys; "
                    f"{trace.n_steps} steps, windows {runner.plan.counts}, "
                    f"{counts['fast_window']} fast_window launches, faults "
                    f"{s['faults']}, data migrations {s['data_migrations']}, "
                    f"l4 {s['l4_mig_success']}, shadows {s['shadow_pages']}, "
                    f"oom {s['oom_killed']}; card blocked {blocked_s:.2f} s, "
                    f"per-step {per_step_s:.2f} s, CPU {cpu_s:.2f} s (one "
                    f"worker thread)")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
    held += sweep_cases(cases, solo)
    mc = benchmark_machine()
    trace = workloads.kv_store(mc, 1 << 8, run_steps=16)
    pc = bhi_mig()
    batched, _, batched_s = timed_run(TieredMemSimulator(mc=mc, pc=pc), trace)
    seq, _, seq_s = timed_run(TieredMemSimulator(
        mc=mc, pc=pc, phase_b="sequential", debug=True), trace)
    how = engines_agree(batched, seq, "[10] sequential vs batched")
    check(seq.summary()["faults"] > 0, "[10] the small case has no fault")
    log(f"[10] sequential fault path == batched on the card "
        f"(benchmark_machine(), footprint 2^8, 16 run steps, "
        f"{pc.label()}, {trace.n_steps} steps, {seq.summary()['faults']} "
        f"faults): state bitwise, timeline f32 keys {how}; sequential "
        f"{seq_s:.2f} s, batched {batched_s:.2f} s")
    log(f"[10] total {time.perf_counter() - t0:.1f} s")
    return held, solo


def lanes_bitwise(got, want, what):
    """Each sweep lane ``got[i]`` == the solo run ``want[i]``, bit for bit:
    every state field and every timeline key."""
    import numpy as np
    for i, (a, b) in enumerate(zip(got, want)):
        fa, fb = dict(state_fields(a.final_state)), dict(state_fields(b.final_state))
        check(fa.keys() == fb.keys(), f"{what}: lane {i}: fields")
        bad = [k for k in fa if not (fa[k].dtype == fb[k].dtype
                                     and np.array_equal(fa[k], fb[k]))]
        bad += [f"timeline.{k}" for k in a.timeline
                if not (a.timeline[k].dtype == b.timeline[k].dtype
                        and np.array_equal(a.timeline[k], b.timeline[k]))]
        check(not bad, f"{what}: lane {i} ({b.policy_label}) != its solo run "
              f"on {bad}")


def timed_sweep(mc, ccs, pols, traces, what, lane_sharding=None):
    """(lanes, seconds) of one ``sweep_lanes`` on the card, the loop under
    the sync check, with ``alloc_scan`` launches == the union's steps with
    a fault and ``fast_window`` launches == the plan's fast segments.
    With a ``lane_sharding``, the run must be a lane mesh's (one engine
    per device), and its engines' fast segments are summed."""
    import numpy as np
    import torch
    from repro_torch.core import fault_step_mask
    from repro_torch.core.sweep import LaneMeshRunner, sweep_runner
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner = sweep_runner(mc, ccs, pols, traces, lane_sharding=lane_sharding)
    engines = [runner]
    if lane_sharding is not None:
        check(isinstance(runner, LaneMeshRunner),
              f"{what}: lane_sharding={lane_sharding!r} did not run a lane "
              f"mesh")
        engines = runner.runners
    ops.reset_launches()
    with sync_error():
        runner.advance()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    union = np.zeros(traces[0].n_steps, bool)
    for tr in traces:
        union |= fault_step_mask(tr, mc)
    check(counts["alloc_scan"] == int(union.sum()),
          f"{what}: alloc_scan launches {counts['alloc_scan']} != "
          f"{int(union.sum())} steps where a lane faults")
    check(counts["fast_window"] == sum(e.fast_segments for e in engines),
          f"{what}: fast_window launches != fast segments")
    return runner.results(), seconds, counts, runner.plan.counts


def quickstart_lanes():
    """[10] the quickstart's two policies (Linux first-touch and Radiant
    BHi+Mig: a scan every 512 steps, so whole fast windows, which [10]'s
    policies, scanning every 16 steps, never run in a sweep) at [10]'s
    size: one 2-lane sweep, each lane bitwise against its solo blocked run
    made here.  Then telemetry on the card: ``sweep_lanes`` and one
    ``TieredMemSimulator`` run (BHi+Mig) with a tracing ``Telemetry``,
    each against the same call without one: the same results bit for bit
    and the same number of synchronising device operations
    (``counted_syncs``: telemetry adds no device read), the window
    counters equal to the plan's counts, one ``window.*`` span per window
    and the trace valid."""
    from repro_torch import quickstart as tq
    from repro_torch.core import (CostConfig, TieredMemSimulator,
                                  benchmark_machine, sweep_lanes, workloads)
    from repro_torch.obs import Telemetry, validate_trace_events

    mc = benchmark_machine()
    trace = workloads.kv_store(mc, **REDUCED)
    names, pols = zip(*tq.POLICIES)
    pols, L, S = list(pols), len(pols), trace.n_steps
    what = "[10] 2-lane sweep of the quickstart's policies"
    solos = [timed_run(TieredMemSimulator(mc=mc, pc=pc), trace)
             for pc in pols]
    want = [r for r, _, _ in solos]
    lanes, sec, counts, plan = timed_sweep(mc, [CostConfig()] * L, pols,
                                           [trace] * L, what)
    check(counts["fast_window"] > 0, f"{what}: no fast segment")
    lanes_bitwise(lanes, want, what)
    solo_s = [t for _, _, t in solos]
    log(f"{what} ({', '.join(n.strip() for n in names)}; {S} steps): each "
        f"lane == its solo blocked run bitwise (every state field and "
        f"timeline key); windows {plan}, launches {counts}; {sec:.3f} s "
        f"({L * S / sec:.1f} lane-steps/s) against the solo runs' "
        f"{solo_s[0]:.3f} / {solo_s[1]:.3f} s")

    def with_telemetry(run, label):
        """(result on, result off, syncs on, syncs off, the Telemetry)."""
        off, n_off = counted_syncs(lambda: run(None))
        tel = Telemetry(tracing=True)
        on, n_on = counted_syncs(lambda: run(tel))
        check(n_on == n_off > 0, f"{label}: {n_on} synchronising operations "
              f"with telemetry, {n_off} without")
        problems = validate_trace_events(tel.tracer.to_trace_json())
        check(not problems, f"{label}: trace {problems[:5]}")
        return on, off, n_on, tel

    def windows_recorded(tel, prefix, label):
        m, names = tel.metrics, tel.tracer.span_names()
        got = [m.value(f"{prefix}.windows_{k}")
               for k in ("fast", "event", "hoist", "split")]
        n_fast, _, n_hoist, n_split = plan
        check((got[0], got[2], got[3]) == (n_fast, n_hoist, n_split)
              and sum(n.startswith("window.") for n in names)
              == got[0] + got[1] > 0,
              f"{label}: windows recorded {got}, the plan's {plan}")
        return got

    args = (mc, [CostConfig()] * L, pols, [trace] * L)
    label = f"{what}, sweep_lanes"
    on, off, n_sweep, tel = with_telemetry(
        lambda t: sweep_lanes(*args, telemetry=t), label)
    lanes_bitwise(off + on, want + want, label)
    m = tel.metrics
    check(m.value("sweep.calls", engine="blocked") == 1
          and m.value("sweep.lanes", engine="blocked") == L
          and tel.tracer.span_names().count("sweep.device") == 1,
          f"{label}: sweep counters {tel.metrics.snapshot()}")
    sweep_windows = windows_recorded(tel, "sweep", label)

    label = f"{what}, TieredMemSimulator ({names[1].strip()})"
    on, off, n_sim, tel = with_telemetry(
        lambda t: TieredMemSimulator(mc=mc, pc=pols[1],
                                     telemetry=t).run(trace), label)
    lanes_bitwise([off, on], [want[1], want[1]], label)
    check(tel.metrics.value("sim.runs", engine="blocked") == 1
          and tel.tracer.span_names().count("sim.run") == 1,
          f"{label}: sim counters {tel.metrics.snapshot()}")
    windows_recorded(tel, "sim", label)
    log(f"{what}: with a tracing Telemetry, sweep_lanes and "
        f"TieredMemSimulator.run give the same results bitwise and make the "
        f"same synchronising device operations as without one ({n_sweep} "
        f"and {n_sim}: the results' reads to the host); windows recorded "
        f"(fast, event, hoist, split) {sweep_windows} == the plan's, one "
        f"window span each, traces valid")


def sweep_cases(cases, solo):
    """[10]'s sweeps on the card, at [10]'s size, each lane bitwise against
    the solo blocked run of its case: one 6-lane sweep of the six
    ``benchmark_machine()`` policies, one 2-lane sweep of ``tpp()`` and
    ``nomad()`` on ``cxl_machine()`` (``solo`` holds [10]'s solo runs, in
    ``cases`` order), which runs again with ``lane_sharding="auto"`` (on
    one card the lane mesh of one device, run as a mesh: bitwise and with
    the same launches as without); the quickstart's two policies, with
    telemetry (``quickstart_lanes``); a 2-trace grid of 4 lanes with a
    mid-run free in one trace and three CostConfigs (against 4 solo runs made here);
    then a machine of 33 to 64 ways (``WIDE_CACHES``), blocked against
    per-step.  Returns how its f32 timeline keys held
    (``engines_agree``)."""
    import numpy as np
    from repro_torch.core import (CostConfig, PolicyConfig, TieredMemSimulator,
                                  benchmark_machine, bhi_mig, workloads)
    for lo, hi, what in ((0, 6, "[10] 6-lane sweep of the six "
                                "benchmark_machine() policies"),
                         (6, 8, "[10] 2-lane sweep of tpp() and nomad() on "
                                "cxl_machine()")):
        mc = cases[lo][1]
        trace = workloads.kv_store(mc, **REDUCED)
        pols = [pc for _, _, pc in cases[lo:hi]]
        lanes, sec, counts, plan = timed_sweep(mc, [CostConfig()] * len(pols),
                                               pols, [trace] * len(pols), what)
        lanes_bitwise(lanes, solo[lo:hi], what)
        log(f"{what}: each lane == its solo blocked run bitwise (every state "
            f"field and timeline key); windows {plan}, launches {counts}; "
            f"{sec:.2f} s for {len(pols)} lanes")
        if lo == 6:     # the lane mesh of the one card, run as a mesh
            mesh_what = f"{what}, lane_sharding='auto'"
            got, sec, mesh_counts, mesh_plan = timed_sweep(
                mc, [CostConfig()] * len(pols), pols, [trace] * len(pols),
                mesh_what, lane_sharding="auto")
            lanes_bitwise(got, lanes, mesh_what)
            check(mesh_counts == counts and mesh_plan == plan,
                  f"{mesh_what}: launches {mesh_counts}, windows "
                  f"{mesh_plan} != the unsharded sweep's {counts}, {plan}")
            log(f"{mesh_what} (a lane mesh of 1 device): each lane == the "
                f"unsharded sweep's bitwise; windows {mesh_plan}, launches "
                f"{mesh_counts}, the unsharded sweep's; {sec:.2f} s")
    quickstart_lanes()

    mc = benchmark_machine()
    a = workloads.kv_store(mc, **REDUCED, name="a")
    b = workloads.kv_store(mc, **REDUCED, seed=3, name="b")
    seg = (np.arange(mc.n_map) >= REDUCED["footprint"] // 2).astype(np.int32)
    free = np.full(b.n_steps, -1, np.int32)
    free[b.populate_steps + REDUCED["run_steps"] // 4] = 1   # upper half exits
    b = dataclasses.replace(b, seg_of_map=seg, free_seg=free)
    costs = [CostConfig(),
             CostConfig(llc_hit=55, stlb_hit=7, cpu_work=31, nvmm_read=900,
                        fault_base=700, migrate_fixed=900, copy_lines=24,
                        data_stall_frac=0.25, mig_cost_scale=0.1,
                        leaf_llc_hit=0.5, upper_llc_hit=0.2),
             CostConfig(dram_read=200, nvmm_write=1300, alloc_slow=3000,
                        zero_lines=8, tlb_flush=600, data_stall_frac=0.9,
                        leaf_llc_hit=0.1, upper_llc_hit=0.6)]
    p2, p3 = (PolicyConfig(**ORACLE_POLICIES[i]) for i in (2, 3))
    lane_args = [(costs[0], p2, a), (costs[1], p3, b), (costs[2], p3, a),
                 (costs[2], p2, b)]
    what = "[10] 2-trace grid, a mid-run free, three CostConfigs"
    ccs, pols, trs = zip(*lane_args)
    lanes, sec, counts, plan = timed_sweep(mc, list(ccs), list(pols),
                                           list(trs), what)
    solos = [timed_run(TieredMemSimulator(mc=mc, cc=c, pc=p), t)[0]
             for c, p, t in lane_args]
    lanes_bitwise(lanes, solos, what)
    sums = [r.summary() for r in lanes]
    check(len({x["total_cycles"] for x in sums}) == len(lanes),
          f"{what}: two lanes give the same cycles")
    mapped = [x["data_pages_dram"] + x["data_pages_nvmm"] for x in sums]
    check(mapped[1] < mapped[0], f"{what}: the free left {mapped[1]} pages "
          f"mapped, the trace without it {mapped[0]}")
    log(f"{what}: 4 lanes (trace, costs, policy) each == its solo blocked "
        f"run bitwise; windows {plan}, launches {counts}; {sec:.2f} s")

    mc = dataclasses.replace(benchmark_machine(), **WIDE_CACHES)
    trace = workloads.kv_store(mc, **REDUCED)
    pc = bhi_mig()                  # a tick every 512 steps: fast windows
    blk, runner, blk_s = timed_run(TieredMemSimulator(mc=mc, pc=pc), trace)
    ps, _, ps_s = timed_run(TieredMemSimulator(mc=mc, pc=pc,
                                               engine="per_step", debug=True),
                            trace)
    how = engines_agree(blk, ps, "[10] 33-64 ways: blocked vs per-step")
    s = blk.summary()
    check(runner.fast_segments > 0, "[10] 33-64 ways: no fast segment")
    log(f"[10] 33-64 ways {WIDE_CACHES}, {pc.label()}: card blocked == card "
        f"per-step (state bitwise, f32 timeline keys {how}); windows "
        f"{runner.plan.counts}, {runner.fast_segments} fast segments, stlb "
        f"hits {s['stlb_hits']}, walks {s['walks']}; blocked {blk_s:.2f} s, "
        f"per-step {ps_s:.2f} s")
    return [how]


def steady_state_phase():
    """The steady-state trace of benchmarks/steady_state.py at half its run
    steps (``kv_store(benchmark_machine(), 1 << 12, run_steps=1024,
    seed=10)``; the script's time limit)
    under Linux first-touch and BHi+Mig at ``autonuma_period`` 512: the
    blocked and the per-step engine's wall clock (each loop under the sync
    check), the two runs held equal as in [10]; then, over the run phase
    of a third blocked run (its populate windows first, unprofiled: they
    are most of the profiler's events), device activities per step, the
    device's idle share and N1's device time per launch (profiler) against
    an empty kernel and its byte bound at 64 rows."""
    import torch
    from repro_torch.core import (TieredMemSimulator, benchmark_machine,
                                  bhi_mig, linux_default, workloads)
    from repro_torch.core.sim import DEFAULT_BLOCK
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import pt_walk as pt_walk_mod
    mc = benchmark_machine()
    trace = workloads.kv_store(mc, 1 << 12, run_steps=1024, seed=10,
                               name="steady")
    S = trace.n_steps
    for name, pc in (("linux_default", linux_default()),
                     ("bhi_mig", bhi_mig())):
        pc = dataclasses.replace(pc, autonuma=True, autonuma_period=512,
                                 autonuma_budget=256)
        blk, runner, blk_s = timed_run(TieredMemSimulator(mc=mc, pc=pc), trace)
        n1 = ops.launch_counts()["fast_window"]
        check(n1 == runner.fast_segments > 0,
              f"steady {name}: fast_window launches {n1} != fast segments")
        ps, _, ps_s = timed_run(TieredMemSimulator(
            mc=mc, pc=pc, engine="per_step", debug=True), trace)
        how = engines_agree(blk, ps, f"steady {name}: blocked vs per-step")
        again = TieredMemSimulator(mc=mc, pc=pc).runner(trace)
        pop_windows = -(-trace.populate_steps // again.block)
        again.advance(pop_windows)
        prof = profiled_window(again, again.plan.n_windows - pop_windows)
        check(prof["fast_window"][0] == n1,
              f"steady {name}: {prof['fast_window'][0]} fast_window launches "
              f"in the profiled run phase != {n1}")
        log(f"[steady] {name}: {S} steps ({trace.populate_steps} populate), "
            f"windows {runner.plan.counts} (fast, full, hoist, split), "
            f"{n1} fast_window launches; blocked {blk_s:.3f} s "
            f"({S / blk_s:.1f} steps/s), per-step {ps_s:.3f} s "
            f"({S / ps_s:.1f} steps/s), {ps_s / blk_s:.2f}x; blocked == "
            f"per-step (state bitwise, f32 timeline keys {how}); profiler, "
            f"run phase ({prof['steps']} steps): {prof['per_step']:.2f} "
            f"device activities per step, idle {prof['idle']:.4f}, "
            f"fast_window {prof['fast_window'][1]:.7f} ms per launch over "
            f"the {prof['fast_window_recorded']} of its "
            f"{prof['fast_window'][0]} launches that the profiler recorded")
    floor = device_ms(lambda: pt_walk_mod.empty_cuda(torch.device("cuda")))
    moved = fast_window_bytes(ref.fast_window_inputs(
        mc, 1, DEFAULT_BLOCK, mc.n_threads, seed=99))
    log(f"[steady] an empty kernel {floor:.7f} ms (the floor of one launch); "
        f"fast_window's bytes bound at a full window ({DEFAULT_BLOCK} rows) "
        f"{moved / HBM_BYTES_PER_S * 1e3:.9f} ms ({moved} B)")


# -- [model]: the model stack's serving path ----------------------------------

# Card against the CPU route, rtol = atol: the CPU tests' whole-model
# tolerances at reduced() (f32 1e-4; bf16 the JAX suite's ATOL, 0.12 and
# rwkv 0.35, with a mean below 0.02); rwkv in f32 1e-2, because its
# parallel time-mix rounds each step's output to bf16 (as the reference
# does) and where the card's sum order flips one such rounding that step
# moves by 2^-8 of itself: [model] (a) shows the cause by running rwkv in
# f32 again with the steps kept in f32, held to 1e-4; at full width f32
# 1e-5 (4.1e-6 measured on the H100), which TF32 products exceed: (b)
# runs them once with TF32 on and requires that they fail it
MODEL_TOL = {"float32": 1e-4, "bfloat16": 0.12}
MODEL_TOL_RWKV = {"float32": 1e-2, "bfloat16": 0.35}
FULL_F32_TOL = 1e-5
BF16_MEAN = 0.02


def model_batch(models, cfg, B, S, kind, seed):
    """tests/test_models.py's batch for ``cfg``, drawn with numpy on the
    CPU (tokens, stubbed frontend embeddings, M-RoPE positions)."""
    import numpy as np
    import torch
    r = np.random.default_rng(seed)
    out = {}
    for k, v in models.input_specs(cfg, S, B, kind).items():
        if v.dtype == torch.int32:
            out[k] = torch.from_numpy(r.integers(0, cfg.vocab, tuple(v.shape))
                                      .astype(np.int32))
        else:
            out[k] = torch.from_numpy((r.standard_normal(tuple(v.shape))
                                       * 0.02).astype(np.float32)).to(v.dtype)
    if "mrope_pos" in out:
        out["mrope_pos"] = torch.arange(S, dtype=torch.int32)[None, :, None] \
            .expand(B, S, 3).contiguous()
    return out


def held(got, want, tol, what, mean=None):
    """``got`` (card) against ``want`` (CPU) to rtol = atol = ``tol`` and,
    where given, a mean error below ``mean``; returns the max error."""
    import torch
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    err = (g - w).abs()
    ok = g.shape == w.shape and bool(torch.isfinite(g).all()) \
        and bool((err <= tol + tol * w.abs()).all())
    if mean is not None:
        ok = ok and float(err.mean()) < mean
    check(ok, f"{what}: max abs err {float(err.max()):.4g} mean "
              f"{float(err.mean()):.4g} against the tolerance {tol:g}"
              + (f" (mean {mean:g})" if mean is not None else ""))
    return float(err.max())


def model_phase(dev):
    """[model]: (a) every arch at ``reduced()`` on the card against the
    CPU route on the same seeded params, f32 and bf16: ``lm_loss``,
    prefill logits and one decode step (hubert: forward and loss);
    (b) Qwen1.5-0.5B at full width, bf16, seeded params: prefill of 8 x 512
    tokens, 64 greedy decode steps with the tokens on the card and the
    loop under the sync check, a teacher-forced 2 x 64 prompt (decode
    against ``forward`` at every position), card against CPU in f32 on a
    2 x 32 prompt and 4 decode steps; (c) prefill and decode tokens/s,
    host ms a decode step, device activities a step and the device's idle
    share over profiled decode steps, beside the step's byte bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs, models
    from repro_torch.kernels import ops
    from repro_torch.models import rwkv
    from repro_torch.models.modules import tree_leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()

    def on(tree, device):
        return tree_map(lambda a: a.to(device), tree)

    # (a) the ten archs at reduced(), card against CPU
    worst = {}
    for arch in configs.ARCH_IDS:
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(configs.reduced(configs.get_config(arch)),
                                      dtype=dtype)
            tol = (MODEL_TOL_RWKV if cfg.rwkv else MODEL_TOL)[dtype]
            mean = BF16_MEAN if dtype == "bfloat16" else None
            cpu = models.make_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
            gpu = on(cpu, dev)
            batch = model_batch(models, cfg, 2, 64, "train", 1)
            gbatch = on(batch, dev)
            what = f"[model] (a) {arch} {dtype}"
            errs = [held(models.lm_loss(cfg, gpu, gbatch),
                         models.lm_loss(cfg, cpu, batch), tol,
                         f"{what} lm_loss", mean)]
            if cfg.has_decode:
                pre = {k: v for k, v in batch.items() if k != "targets"}
                errs.append(held(models.prefill(cfg, gpu, on(pre, dev))[0],
                                 models.prefill(cfg, cpu, pre)[0], tol,
                                 f"{what} prefill logits", mean))
                toks = torch.arange(2, dtype=torch.int32)
                st_g = models.init_decode_state(cfg, 2, 68, device=dev)
                st_c = models.init_decode_state(cfg, 2, 68, device="cpu")
                errs.append(held(
                    models.decode_step(cfg, gpu, st_g, toks.to(dev), 64)[1],
                    models.decode_step(cfg, cpu, st_c, toks, 64)[1], tol,
                    f"{what} decode logits", mean))
            else:
                h_g = models.forward(cfg, gpu, gbatch)[0]
                errs.append(held(h_g, models.forward(cfg, cpu, batch)[0], tol,
                                 f"{what} forward", mean))
            worst[arch, dtype] = (max(errs), tol)
            if cfg.rwkv and dtype == "float32":
                # the cause of rwkv's f32 tolerance: with each step's output
                # kept in f32 the card holds the f32 tolerance of the rest
                rwkv.YS_DTYPE = torch.float32
                try:
                    f32_steps = max(
                        held(models.lm_loss(cfg, gpu, gbatch),
                             models.lm_loss(cfg, cpu, batch), MODEL_TOL[dtype],
                             f"{what} lm_loss, steps in f32"),
                        held(models.prefill(cfg, gpu, on(pre, dev))[0],
                             models.prefill(cfg, cpu, pre)[0], MODEL_TOL[dtype],
                             f"{what} prefill logits, steps in f32"))
                finally:
                    rwkv.YS_DTYPE = torch.bfloat16
    for arch in configs.ARCH_IDS:
        log(f"[model] (a) {arch}: card vs CPU, max abs err f32 "
            f"{worst[arch, 'float32'][0]:.3g} (tol {worst[arch, 'float32'][1]:g})"
            f", bf16 {worst[arch, 'bfloat16'][0]:.3g} (tol "
            f"{worst[arch, 'bfloat16'][1]:g}, mean < {BF16_MEAN:g})")
    log(f"[model] (a) rwkv6-3b f32 with the time-mix steps kept in f32 (not "
        f"rounded to bf16): max abs err {f32_steps:.3g} (tol "
        f"{MODEL_TOL['float32']:g})")
    # the MoE layer's sequence chunks (S = 2 x seq_chunk), as the F8
    # repair left them: card against CPU
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.modules import init_params
    moe_errs = []
    for mlp, shared, top_k in (("swiglu", True, 1), ("squared_relu", False, 2)):
        for dtype in ("float32", "bfloat16"):
            specs = moe_mod.moe_param_specs(64, 32, 4, mlp, shared, dtype)
            w = init_params(specs, torch.Generator().manual_seed(2), "cpu")
            x = (torch.randn((2, 16, 64), generator=torch.Generator()
                             .manual_seed(3)) * 0.5).to(getattr(torch, dtype))
            kw = dict(top_k=top_k, capacity_factor=1.0, mlp=mlp, seq_chunk=8)
            got = moe_mod.moe_apply(on(w, dev), x.to(dev), **kw)
            want = moe_mod.moe_apply(w, x, **kw)
            moe_errs += [held(got[0], want[0], MODEL_TOL[dtype],
                              f"[model] (a) moe_apply {mlp} {dtype} in two "
                              f"sequence chunks",
                              BF16_MEAN if dtype == "bfloat16" else None),
                         held(got[1], want[1], MODEL_TOL["float32"],
                              f"[model] (a) moe_apply {mlp} {dtype} aux")]
    log(f"[model] (a) moe_apply in two sequence chunks (S 16, seq_chunk 8; "
        f"swiglu with a shared expert and top-1, squared_relu and top-2; f32 "
        f"and bf16): card vs CPU max abs err {max(moe_errs):.3g}")
    log(f"[model] (a) {time.perf_counter() - t0:.1f} s")

    # (b) Qwen1.5-0.5B at full width, bf16
    cfg = configs.get_config("qwen1.5-0.5b")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = models.make_params(cfg, gen, dev)
    n_params = sum(a.numel() for a in tree_leaves(params))
    w_bytes = sum(a.numel() * a.element_size() for a in tree_leaves(params))
    B, S, NEW, PROF = 8, 512, 64, 8
    prompt = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev,
                           dtype=torch.int32)
    ops.reset_launches()
    # warm-up: PyTorch and cuBLAS load their kernels at first use
    models.prefill(cfg, params, {"tokens": prompt[:, :64]})
    warm = models.init_decode_state(cfg, B, 8, device=dev)
    for i in range(2):
        models.decode_step(cfg, params, warm, prompt[:, i], i)
    del warm
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, kvs = models.prefill(cfg, params, {"tokens": prompt})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    prefill_s = statistics.median(times)
    check(tuple(logits.shape) == (B, cfg.vocab)
          and bool(torch.isfinite(logits.float()).all()),
          f"[model] (b) prefill logits {tuple(logits.shape)} not finite")
    state = models.init_decode_state(cfg, B, S + NEW + PROF, device=dev)
    state["pos0"]["k"][:, :, :S] = kvs[0][0]
    state["pos0"]["v"][:, :, :S] = kvs[0][1]
    del kvs
    tok = logits.argmax(-1)
    pos = torch.full((), S, dtype=torch.int64, device=dev)
    out = torch.empty((B, NEW), dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with sync_error():
        for i in range(NEW):
            state, lg = models.decode_step(cfg, params, state, tok, pos)
            tok = lg.argmax(-1)
            out[:, i] = tok
            pos += 1
        enqueue_s = time.perf_counter() - t1
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t1
    counts = ops.launch_counts()
    check(not any(counts.values()), f"[model] (b) the model path launched "
                                    f"one of the port's kernels: {counts}")
    check(bool(((out >= 0) & (out < cfg.vocab)).all())
          and bool(torch.isfinite(lg.float()).all()),
          "[model] (b) decode tokens out of range or logits not finite")
    written = state["pos0"]["k"][:, :, S + NEW - 1].float().abs().sum()
    check(float(written) > 0, "[model] (b) the last step wrote no K")
    # device activities and idle share over PROF more steps (profiler)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(PROF):
            state, lg = models.decode_step(cfg, params, state, tok, pos)
            tok = lg.argmax(-1)
            pos += 1
        torch.cuda.synchronize()
    events = device_events(prof)
    per_step, idle = len(events) / PROF, idle_share(events)
    kernel_names = {e.name for e in events}
    del state, prof, events
    torch.cuda.empty_cache()
    # the byte bound of a decode step: the weights once, the K and V
    # positions it reads (the mean length over the 64 steps), its logits
    kv_bytes = 2 * cfg.n_layers * B * (S + NEW / 2) * cfg.n_kv_heads \
        * cfg.head_dim * 2
    bound_ms = (w_bytes + kv_bytes + B * cfg.vocab * 2) / HBM_BYTES_PER_S * 1e3
    # prefill's operations bound: the products (the LM head on the last
    # token only) and the attention scores and sums over the causal half
    # (query i reads keys 0..i: S (S + 1) / 2 pairs)
    d, L = cfg.d_model, cfg.n_layers
    layer_params = 4 * d * d + 3 * d * cfg.d_ff
    prefill_ops = 2 * L * layer_params * B * S + 2 * L * B * S * (S + 1) * d \
        + 2 * B * d * cfg.vocab
    prefill_bound_ms = prefill_ops / 989e12 * 1e3

    # teacher-forced: decode logits against forward's at every position
    toks = torch.randint(0, cfg.vocab, (2, 64), generator=gen, device=dev,
                         dtype=torch.int32)
    h, _, _ = models.forward(cfg, params, {"tokens": toks}, remat_policy="none")
    full = h @ params["embed"].T
    st = models.init_decode_state(cfg, 2, 64, device=dev)
    dec = []
    for i in range(64):
        st, lg = models.decode_step(cfg, params, st, toks[:, i], i)
        dec.append(lg)
    tol = MODEL_TOL["bfloat16"]
    tf_err = held(torch.stack(dec, dim=1), full, tol, "[model] (b) "
                  "teacher-forced decode against forward", BF16_MEAN)
    tf_mean = float((torch.stack(dec, dim=1).float() - full.float()).abs()
                    .mean())
    del params, st, h, full, dec
    torch.cuda.empty_cache()

    # card against CPU in f32 at full width: a 2 x 32 prompt, 4 decode
    # steps; then the card again with TF32 products, which must fail the
    # tolerance (the check sees TF32)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p_g = models.make_params(cfg32, torch.Generator(device=dev).manual_seed(1),
                             dev)
    p_c = on(p_g, "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 36), generator=gen, device=dev,
                         dtype=torch.int32)
    errs = []
    for params_, device, tf32 in ((p_g, dev, False),
                                  (p_c, torch.device("cpu"), False),
                                  (p_g, dev, True)):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        t_ = toks.to(device)
        lg, kvs = models.prefill(cfg32, params_, {"tokens": t_[:, :32]})
        st = models.init_decode_state(cfg32, 2, 36, device=device)
        st["pos0"]["k"][:, :, :32] = kvs[0][0]
        st["pos0"]["v"][:, :, :32] = kvs[0][1]
        outs = [lg]
        for i in range(4):
            st, lg = models.decode_step(cfg32, params_, st, t_[:, 32 + i],
                                        32 + i)
            outs.append(lg)
        errs.append(outs)
    torch.backends.cuda.matmul.allow_tf32 = False
    card, cpu_, card_tf32 = errs
    f32_err = max(held(g, c, FULL_F32_TOL, f"[model] (b) f32 full width, "
                       f"card vs CPU, logits {i}")
                  for i, (g, c) in enumerate(zip(card, cpu_)))
    tf32_err, tf32_fails = 0.0, False
    for g, c in zip(card_tf32, cpu_):
        e = (g.float().cpu() - c).abs()
        tf32_err = max(tf32_err, float(e.max()))
        tf32_fails |= bool((e > FULL_F32_TOL + FULL_F32_TOL * c.abs()).any())
    check(tf32_fails, f"[model] (b) f32 full width with TF32 products: max "
                      f"abs err {tf32_err:.4g} passes the tolerance "
                      f"{FULL_F32_TOL:g}, which then cannot see TF32")
    del p_g, p_c, errs, card, cpu_, card_tf32, st, kvs
    torch.cuda.empty_cache()

    log(f"[model] (b) Qwen1.5-0.5B full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}, tied, QKV bias, bf16): {n_params} params, "
        f"{w_bytes / 1e9:.3f} GB; prefill {B} x {S}, {NEW} greedy decode "
        f"steps under the sync check, tokens {out[0, :8].tolist()}...; launches "
        f"of the port's kernels {counts}")
    log(f"[model] (b) teacher-forced 2 x 64 decode vs forward: max abs err "
        f"{tf_err:.4g} (tol {tol:g} rtol and atol), mean {tf_mean:.4g}"
        f" (< {BF16_MEAN:g}); f32 card vs CPU, 2 x 32 prompt + 4 steps: max "
        f"abs err {f32_err:.4g} (tol {FULL_F32_TOL:g}); the same with TF32 "
        f"products {tf32_err:.4g}, which fails it")
    log(f"[model] (c) prefill {prefill_s * 1e3:.3f} ms, {B * S / prefill_s:.1f} "
        f"tokens/s (operations bound {prefill_bound_ms:.4f} ms, "
        f"{prefill_ops / 1e12:.3f} TFLOP at 989 TFLOP/s bf16); decode "
        f"{decode_s / NEW * 1e3:.4f} ms a step, {B * NEW / decode_s:.1f} "
        f"tokens/s, host {enqueue_s / NEW * 1e3:.4f} ms a step (enqueue); "
        f"byte bound {bound_ms:.4f} ms a step ({w_bytes} B of weights, "
        f"{kv_bytes:.0f} B of K and V), {decode_s / NEW * 1e3 / bound_ms:.1f}"
        f" times it")
    log(f"[model] (c) profiled decode steps ({PROF}): {per_step:.1f} device "
        f"activities a step, {len(kernel_names)} distinct, idle share "
        f"{idle:.4f}")
    log(f"[model] total {time.perf_counter() - t0:.1f} s")


# -- [train] the model stack's training path ----------------------------------

# one train step, card against the CPU route, at the step's tolerances of
# tests/test_torch_training.py, with lr 1e-3 from the first step so that
# the update shows in the params (Adam's first step moves an element by
# about lr): the loss and the params after the step to rtol = atol =
# MODEL_TOL (f32 1e-4; bf16 the JAX suite's ATOL; rwkv MODEL_TOL_RWKV)
# plus 2 lr (where an element's grad lies within rounding of 0, the step
# moves it by about lr either way), and the mean error of each param leaf
# the step moved to UPDATE_TOL of the mean move (a step that skips the
# update, or moves by the wrong grads, gives about 1); the grad norm
# (relative) and the moments (0.1 and 0.05 of the clipped grad and its
# square) to MOMENT_TOL of each leaf's largest value, in bf16 with a mean
# error below BF16_MEAN of it; in bf16 the MoE archs' expert weights by
# that mean only (bf16 rounding swaps a token's near-tied experts, which
# tests/test_torch_training.py shows against the reference run op by op)
TRAIN_LR = 1e-3
MOMENT_TOL = {"float32": 1e-4, "bfloat16": 0.12}
UPDATE_TOL = {"float32": 1e-3, "bfloat16": 0.25}
# rwkv rounds its time-mix steps to bf16 (as the reference does) and its
# group norm amplifies the flip of one such rounding by the card's sum
# order, so its train step is held to limits of about twice the largest of
# three seeds' readings on the H100 (PERF.md), for the moments' (max,
# mean) error of each leaf's largest value, the params' mean error of the
# mean move and the grad norm; in f32 (a) runs it once more with the steps
# kept in f32, which leaves only the sum order to show
RWKV_TOL = {
    "float32": dict(m_max=0.15, m_mean=1e-2, update=0.03, gnorm=0.04),
    "f32 steps": dict(m_max=1e-3, m_mean=4e-5, update=5e-3, gnorm=2e-4),
    "bfloat16": dict(m_max=0.65, m_mean=0.04, update=0.15, gnorm=0.1)}
RWKV_SEEDS = (0, 1, 2)
MOE_ARCHS = ("llama4-maverick-400b-a17b", "llama4-scout-17b-16e",
             "jamba-v0.1-52b")
BF16_FLOPS, F32_FLOPS = 989e12, 67e12    # H100 SXM dense peaks (data sheet)


def leaf_err(got, want) -> tuple[float, float]:
    """(max, mean) |got - want| over the leaf's largest |want|."""
    import torch
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    check(g.shape == w.shape and bool(torch.isfinite(g).all()),
          f"leaf of shape {tuple(g.shape)} against {tuple(w.shape)}, "
          f"or not finite")
    scale = max(float(w.abs().max()), 1e-30)
    d = (g - w).abs()
    return float(d.max()) / scale, float(d.mean()) / scale


def train_state(params, opt_state) -> dict:
    """{path: tensor} of params, moments and step, in the reference's
    checkpoint order."""
    from repro_torch.checkpoint.ckpt import _flatten
    return _flatten({"params": params, "opt": opt_state})


def step_held(got, want, before, arch, dtype, what, rwkv_mode=None) -> dict:
    """A card step's (params, opt_state, metrics) against the CPU's from
    the params ``before`` it, at the module's tolerances (rwkv's at
    ``RWKV_TOL[rwkv_mode or dtype]``); returns the readings: the params'
    largest error over their tolerance, the largest mean error over the
    mean move, the share of param elements in leaves the step moved, the
    moments' largest (max, mean) error of the leaf's largest value, and
    the grad norm's relative error."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.ckpt import _flatten
    rwkv = arch == "rwkv6-3b"
    tol = (MODEL_TOL_RWKV if rwkv else MODEL_TOL)[dtype]
    lim = RWKV_TOL[rwkv_mode or dtype] if rwkv else dict(
        m_max=MOMENT_TOL[dtype], update=UPDATE_TOL[dtype],
        gnorm=MOMENT_TOL[dtype],
        m_mean=BF16_MEAN if dtype == "bfloat16" else None)
    (gp, go, gm), (wp, wo, wm) = got, want
    r = dict(loss=held(gm["loss"], wm["loss"], tol, f"{what} loss"),
             params=0.0, update=0.0, moved=0.0, m_max=0.0, m_mean=0.0)
    lr = float(wm["lr"])
    check(float(gm["lr"]) == lr == float(np.float32(TRAIN_LR)),
          f"{what} lr {lr}")
    gs, ws, bs = train_state(gp, go), train_state(wp, wo), \
        _flatten({"params": before})
    check(list(gs) == list(ws), f"{what} state keys")
    n_moved = n_all = 0
    for k in ws:
        g, w = gs[k].detach().float().cpu(), ws[k].detach().float()
        if k.startswith("params/"):
            d = (g - w).abs()
            bound = 2 * lr + tol + tol * w.abs()
            check(g.shape == w.shape and bool(torch.isfinite(g).all())
                  and bool((d <= bound).all()),
                  f"{what} {k}: max abs err {float(d.max()):.4g} against "
                  f"2 lr + the tolerance {tol:g}")
            r["params"] = max(r["params"], float((d / bound).max()))
            move = float((w - bs[k].float()).abs().mean())
            n_all += w.numel()
            if move >= lr / 4:
                n_moved += w.numel()
                ratio = float(d.mean()) / move
                check(ratio <= lim["update"],
                      f"{what} {k}: mean error {float(d.mean()):.4g}, "
                      f"{ratio:.4g} of the step's mean move {move:.4g}, "
                      f"tolerance {lim['update']:g}")
                r["update"] = max(r["update"], ratio)
        elif k == "opt/step":
            check(int(gs[k]) == int(ws[k]) == 1, f"{what} step")
        else:
            mx, mean = leaf_err(g, w)
            r["m_mean"] = max(r["m_mean"], mean)
            if lim["m_mean"] is not None:
                check(mean < lim["m_mean"],
                      f"{what} {k}: mean error {mean:.4g} of the leaf's "
                      f"largest, limit {lim['m_mean']:g}")
            if arch in MOE_ARCHS and dtype == "bfloat16" and "/moe/w_" in k:
                continue
            check(mx <= lim["m_max"], f"{what} {k}: max error {mx:.4g} of "
                                      f"the leaf's largest, tolerance "
                                      f"{lim['m_max']:g}")
            r["m_max"] = max(r["m_max"], mx)
    r["moved"] = n_moved / n_all
    check(r["moved"] >= 0.5, f"{what}: the step moved leaves holding only "
                             f"{r['moved']:.3f} of the params")
    r["gnorm"] = abs(float(gm["grad_norm"]) / float(wm["grad_norm"]) - 1)
    check(r["gnorm"] <= lim["gnorm"],
          f"{what} grad norm {float(gm['grad_norm'])} against "
          f"{float(wm['grad_norm'])}, tolerance {lim['gnorm']:g}")
    return r


def one_step(cfg, params, batch, device, **tc):
    """One ``make_train_step`` step on copies of ``params`` on ``device``
    (TrainConfig ``tc``, lr TRAIN_LR from the first step unless ``tc``
    gives ``opt``)."""
    from repro_torch.models.modules import tree_map
    from repro_torch.training import optimizer as topt
    from repro_torch.training import train as ttrain
    tc.setdefault("opt", topt.OptConfig(lr=TRAIN_LR, warmup_steps=1))
    p = tree_map(lambda a: a.detach().clone().to(device), params)
    st = topt.init_opt_state(p)
    step = ttrain.make_train_step(cfg, ttrain.TrainConfig(**tc),
                                  device=device)
    return step(p, st, {k: v.to(device) for k, v in batch.items()})


def train_bound_ms(cfg, B, S) -> tuple[float, float]:
    """The operations bound of one train step of a dense decoder (ms, and
    TFLOP): the products (6 x the product params x tokens: QKV, output,
    MLP and the tied LM head) at the bf16 peak, and attention's scores
    and sums over the causal half (forward and twice it backward) at the
    f32 peak, which the port runs them in (no TF32); no recomputation."""
    d, L, ff = cfg.d_model, cfg.n_layers, cfg.d_ff
    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    layer = d * hq + 2 * d * hkv + hq * d + 3 * d * ff
    bf16 = 6.0 * (L * layer + d * cfg.vocab) * B * S
    f32 = 3 * 2 * 2.0 * B * L * hq * S * (S + 1) / 2
    return (bf16 / BF16_FLOPS + f32 / F32_FLOPS) * 1e3, (bf16 + f32) / 1e12


def train_phase(dev):
    """[train]: (a) ``train_data`` and ``train_archs``, with (c)'s two
    launcher processes (``kill_and_resume``) running beside them on a
    thread, and [dist]'s CPU route in its processes, both waited for
    before (b) starts, so that nothing shares the card or the cores with
    (b)'s timing; (b) ``train_full_width``; (c) ``train_resume``; (d)
    ``train_example``; [dist] (``dist_run``, with (a)'s two-microbatch
    steps as its one-device steps and the CPU route's results); then
    (b)'s device activities and idle share over 3 profiled steps, last,
    so that the profiler slows no phase after it.  The temporary files
    are removed, and the processes ended, whatever happens."""
    import os
    import shutil
    import tempfile
    import threading
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    killed = {"dir": os.path.join(tmp, "killed")}

    def launcher_runs():
        t = time.perf_counter()
        try:
            killed["run"] = kill_and_resume(killed["dir"])
        except BaseException as exc:        # raised again on the main thread
            killed["error"] = exc
        killed["s"] = time.perf_counter() - t

    launcher = threading.Thread(target=launcher_runs)
    launcher.start()
    # [dist]'s CPU route, one thread a process, beside (a) on the cores
    # that (a) and the launcher leave
    cpu_out = [os.path.join(tmp, f"dist_cpu{i}.pt")
               for i in range(DIST_CPU_WORKERS)]
    cpu = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--dist-cpu-worker", out, str(i)])
           for i, out in enumerate(cpu_out)]
    try:
        train_data(dev)
        ones = train_archs(dev)
        launcher.join()
        if "error" in killed:
            raise killed["error"]
        for p in cpu:
            p.wait(timeout=600)
        profiled = train_full_width(dev)
        train_resume(dev, tmp, killed)
        train_example(tmp)
        t_dist = time.perf_counter()
        dist_run(ones, cpu, cpu_out)
        t_dist = time.perf_counter() - t_dist
        profiled()
    finally:
        launcher.join()
        for p in cpu:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[train] total {time.perf_counter() - t0 - t_dist:.1f} s (and "
        f"[dist] {t_dist:.1f} s)")


def train_data(dev):
    """[train] (a): ``batch_at``, ``powf`` and the bias corrections, card
    against CPU bit for bit; the learning rate within an ulp of its peak
    (torch's ``cos`` on each); the CPU's are held to the reference's by
    the CPU tests."""
    import numpy as np
    import torch

    from repro_torch import libm
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.training import optimizer as topt
    for vocab in (512, 32768, 151936):
        dc = DataConfig(vocab=vocab, seq_len=512, global_batch=8)
        for step in range(16):
            got, want = batch_at(dc, step, device=dev), \
                batch_at(dc, step, device="cpu")
            check(all(torch.equal(got[k].cpu(), want[k]) for k in want),
                  f"[train] (a) batch_at card != CPU at vocab {vocab}, "
                  f"step {step}")
    draws = 1.0 - torch.arange(1 << 24, dtype=torch.float32) / float(1 << 24)
    check(torch.equal(libm.powf(draws.to(dev), -10.0).cpu().view(torch.int32),
                      libm.powf(draws, -10.0).view(torch.int32)),
          "[train] (a) powf card != CPU on the 2^24 draws")
    steps = torch.arange(10001, dtype=torch.int32)
    lr_err = 0.0
    for opt in (topt.OptConfig(),
                topt.OptConfig(lr=3e-3, warmup_steps=20, total_steps=30)):
        for b in (opt.b1, opt.b2):
            check(torch.equal(topt._bias_correction(b, steps.to(dev)).cpu()
                              .view(torch.int32),
                              topt._bias_correction(b, steps)
                              .view(torch.int32)),
                  f"[train] (a) bias correction card != CPU ({opt})")
        ulp = float(np.spacing(np.float32(opt.lr)))
        d = float((topt.schedule(opt, steps.to(dev)).cpu()
                   - topt.schedule(opt, steps)).abs().max()) / ulp
        check(d <= 1.0, f"[train] (a) the learning rate card against CPU: "
                        f"{d} ulps of its peak ({opt})")
        lr_err = max(lr_err, d)
    log(f"[train] (a) card == CPU bit for bit: batch_at at vocab 512, 32,768 "
        f"and 151,936 (16 steps of 8 x 512 each), powf on all 2^24 draws "
        f"of u, both bias corrections over steps 0-10,000 (two "
        f"OptConfigs); the learning rate within {lr_err:g} ulps of its "
        f"peak (tolerance 1)")


def train_archs(dev):
    """[train] (a): every arch at ``reduced()``, f32 and bf16, B, S = 2,
    64: one train step on the card against the CPU route on the same
    params and batch (rwkv at RWKV_SEEDS, and in f32 again with its steps
    kept in f32); on the card, under deterministic algorithms, the three
    remat policies bitwise equal and two microbatches against one.
    Returns the two-microbatch steps (f32, seed 0) by arch: [dist] (a)'s
    one-device steps."""
    import torch

    from repro_torch import configs, models
    from repro_torch.models import rwkv
    from repro_torch.models.modules import tree_leaves
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    worst, rwkv_reads, remat_same, ones = {}, [], 0, {}
    for arch in configs.ARCH_IDS:
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(configs.reduced(configs.get_config(arch)),
                                      dtype=dtype)
            for seed in RWKV_SEEDS if cfg.rwkv else (0,):
                cpu = models.make_params(
                    cfg, torch.Generator().manual_seed(seed), "cpu")
                batch = model_batch(models, cfg, 2, 64, "train", 1 + seed)
                what = f"[train] (a) {arch} {dtype} seed {seed}"
                pols = ("full", "dots", "none") if seed == 0 else ("full",)
                card = {pol: one_step(cfg, cpu, batch, dev, remat_policy=pol)
                        for pol in pols}
                want = one_step(cfg, cpu, batch, torch.device("cpu"))
                r = step_held(card["full"], want, cpu, arch, dtype, what)
                if seed == 0:
                    worst[arch, dtype] = r
                if cfg.rwkv:
                    rwkv_reads.append((dtype, seed, r))
                if cfg.rwkv and dtype == "float32":
                    rwkv.YS_DTYPE = torch.float32
                    try:
                        f32_steps = step_held(
                            one_step(cfg, cpu, batch, dev),
                            one_step(cfg, cpu, batch, torch.device("cpu")),
                            cpu, arch, dtype, f"{what}, steps in f32",
                            rwkv_mode="f32 steps")
                    finally:
                        rwkv.YS_DTYPE = torch.bfloat16
                    rwkv_reads.append(("float32, steps in f32", seed,
                                       f32_steps))
                base = train_state(*card["full"][:2])
                for pol in pols[1:]:
                    other = train_state(*card[pol][:2])
                    check(all(torch.equal(other[k], base[k]) for k in base)
                          and all(torch.equal(card[pol][2][k],
                                              card["full"][2][k])
                                  for k in card["full"][2]),
                          f"{what}: remat {pol!r} differs from 'full'")
                    remat_same += 1
                if dtype == "float32" and seed == 0:
                    ones[arch] = two = one_step(cfg, cpu, batch, dev,
                                                microbatches=2)
                    # tests/test_training.py's microbatching criterion
                    check(abs(float(two[2]["loss"])
                              / float(card["full"][2]["loss"]) - 1) <= 2e-2,
                          f"{what}: two microbatches' loss")
                    for a, b in zip(tree_leaves(two[0]),
                                    tree_leaves(card["full"][0])):
                        check(float((a.detach().float() - b.detach().float())
                                    .abs().max()) <= 3e-2,
                              f"{what}: two microbatches' params")
                del card, want
    torch.use_deterministic_algorithms(False)

    def reads(r):
        return (f"loss {r['loss']:.3g}, params {r['params']:.3g} of their "
                f"tolerance, mean error {r['update']:.3g} of the mean move "
                f"(moved leaves {r['moved']:.3f} of the params), moments "
                f"max {r['m_max']:.3g} mean {r['m_mean']:.3g} of the leaf's "
                f"largest, grad norm {r['gnorm']:.3g}")
    for arch in configs.ARCH_IDS:
        for dtype in ("float32", "bfloat16"):
            log(f"[train] (a) {arch} {dtype}: one step at lr {TRAIN_LR:g}, "
                f"card vs CPU: {reads(worst[arch, dtype])}")
    for dtype, seed, r in rwkv_reads:
        log(f"[train] (a) rwkv6-3b {dtype} seed {seed}: {reads(r)}")
    log(f"[train] (a) tolerances: params rtol = atol = f32 "
        f"{MODEL_TOL['float32']:g}, bf16 {MODEL_TOL['bfloat16']:g} (rwkv "
        f"{MODEL_TOL_RWKV['float32']:g} / {MODEL_TOL_RWKV['bfloat16']:g}) "
        f"+ 2 lr, mean error of the mean move f32 "
        f"{UPDATE_TOL['float32']:g}, bf16 {UPDATE_TOL['bfloat16']:g}; "
        f"moments and grad norm f32 {MOMENT_TOL['float32']:g}, bf16 "
        f"{MOMENT_TOL['bfloat16']:g} with mean < {BF16_MEAN:g}; rwkv "
        f"{RWKV_TOL}")
    log(f"[train] (a) remat 'dots' and 'none' bitwise equal to 'full' on "
        f"the card in {remat_same} of {remat_same} cases; two microbatches "
        f"within tests/test_training.py's tolerance of one; "
        f"{time.perf_counter() - t0:.1f} s")
    return ones


def train_full_width(dev):
    """[train] (b): Qwen1.5-0.5B at full width, bf16 params, f32 moments,
    remat "full", ``launch.train``'s optimizer defaults: 30 steps of 8 x
    512 tokens from ``data.batch_at`` under the sync check, the losses
    finite and falling, ms a step and tokens/s, the peak memory of one
    step under each policy, the card against the CPU in f32 on 2 x 32
    tokens.  Returns the closure that profiles 3 of its steps, which the
    phase calls last."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs, models
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels import ops
    from repro_torch.models.modules import tree_leaves
    from repro_torch.training import optimizer as topt
    from repro_torch.training import train as ttrain
    t1 = time.perf_counter()
    cfg = configs.get_config("qwen1.5-0.5b")
    B, S, STEPS = 8, 512, 30
    opt = topt.OptConfig(lr=3e-3, warmup_steps=20, total_steps=STEPS)
    dc = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B)

    def fresh():
        p = models.make_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               dev)
        return p, topt.init_opt_state(p)

    params, state = fresh()
    n_params = sum(a.numel() for a in tree_leaves(params))
    step_fn = ttrain.make_train_step(cfg, ttrain.TrainConfig(
        remat_policy="full", opt=opt), device=dev)
    batch_at(dc, 0, device=dev)            # the lookup tables, copied once
    ops.reset_launches()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(STEPS + 1)]
    losses, host = [], []
    with sync_error():
        events[0].record()
        for i in range(STEPS):
            h0 = time.perf_counter()
            params, state, met = step_fn(params, state,
                                         batch_at(dc, i, device=dev))
            events[i + 1].record()
            host.append(time.perf_counter() - h0)
            losses.append(met["loss"])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(not any(counts.values()), f"[train] (b) the training path "
                                    f"launched one of the port's kernels: "
                                    f"{counts}")
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses))
          and np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2,
          f"[train] (b) losses not finite or not falling: {losses}")
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(STEPS)]
    med_ms = statistics.median(step_ms[10:])
    host_ms_ = statistics.median(host[10:]) * 1e3
    bound_ms, tflop = train_bound_ms(cfg, B, S)
    # peak memory of one step under each policy (steps 31-33)
    peaks = {}
    for pol in ("none", "dots", "full"):
        f = ttrain.make_train_step(cfg, ttrain.TrainConfig(
            remat_policy=pol, opt=opt), device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        params, state, _ = f(params, state, batch_at(dc, STEPS, device=dev))
        torch.cuda.synchronize()
        peaks[pol] = (torch.cuda.max_memory_allocated(), resident)
    del params, state, met
    torch.cuda.empty_cache()
    # the card against the CPU in f32 at full width, 2 x 32 tokens
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = models.make_params(cfg32, torch.Generator(device=dev).manual_seed(1),
                             dev)
    small = batch_at(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2),
                     0, device="cpu")
    kw = dict(remat_policy="full", opt=opt)
    card32 = one_step(cfg32, p32, small, dev, **kw)
    cpu32 = one_step(cfg32, p32, small, torch.device("cpu"), **kw)
    f32_loss = held(card32[2]["loss"], cpu32[2]["loss"], FULL_F32_TOL,
                    "[train] (b) f32 full width loss")
    gs, ws = train_state(*card32[:2]), train_state(*cpu32[:2])
    # Adam's first step moves an element by lr * g / (|g| + eps): by about
    # lr either way where g lies within its rounding of 0, so a param may
    # differ by up to 2 lr there; the moments hold the grads themselves
    lr1 = float(cpu32[2]["lr"])
    f32_params, f32_mean = 0.0, 0.0
    for k in ws:
        if k.startswith("params/"):
            d = (gs[k].detach().float().cpu() - ws[k].detach().float()).abs()
            f32_params = max(f32_params, float(d.max()))
            f32_mean = max(f32_mean, float(d.mean()))
    check(f32_params <= 2 * lr1 + FULL_F32_TOL and f32_mean <= 1e-8,
          f"[train] (b) f32 params: max abs err {f32_params:.4g} (2 lr "
          f"{2 * lr1:.4g}), mean {f32_mean:.4g}")
    f32_moments = 0.0
    for k in ws:
        if k.startswith("opt/") and k != "opt/step":
            mx, _ = leaf_err(gs[k], ws[k])
            check(mx <= MOMENT_TOL["float32"], f"[train] (b) f32 {k}: {mx}")
            f32_moments = max(f32_moments, mx)
    del p32, card32, cpu32, gs, ws
    torch.cuda.empty_cache()
    log(f"[train] (b) Qwen1.5-0.5B full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, tied, QKV bias; bf16 params, f32 "
        f"moments, remat 'full', lr 3e-3, warmup 20): {n_params} params; "
        f"{STEPS} steps of {B} x {S} tokens under the sync check, launches "
        f"of the port's kernels {counts}; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (first 5 mean {np.mean(losses[:5]):.4f}, last 5 "
        f"{np.mean(losses[-5:]):.4f})")
    log(f"[train] (b) {med_ms:.3f} ms a step (median of steps 11-30, CUDA "
        f"events), {B * S / med_ms * 1e3:.1f} tokens/s; host {host_ms_:.3f} "
        f"ms to issue a step; operations bound {bound_ms:.4f} ms ({tflop:.3f} "
        f"TFLOP: products at 989 TFLOP/s bf16, attention at 67 TFLOP/s f32), "
        f"{med_ms / bound_ms:.1f} times it; steps {[round(x, 1) for x in step_ms]}")
    log("[train] (b) peak memory of one step: " + ", ".join(
        f"{pol} {peak / 2**30:.3f} GiB ({(peak - res) / 2**30:.3f} above the "
        f"{res / 2**30:.3f} GiB resident)" for pol, (peak, res) in peaks.items()))
    log(f"[train] (b) f32 full width, one step on 2 x 32 tokens, card vs "
        f"CPU: loss err {f32_loss:.3g} (tol {FULL_F32_TOL:g}), params max "
        f"{f32_params:.3g} (2 lr + {FULL_F32_TOL:g} = "
        f"{2 * lr1 + FULL_F32_TOL:.3g}) mean {f32_mean:.3g} (1e-8), moments "
        f"{f32_moments:.3g} of the leaf's largest (tol "
        f"{MOMENT_TOL['float32']:g}); (b) {time.perf_counter() - t1:.1f} s")

    def profiled():
        params, state = fresh()
        for i in range(2):
            params, state, _ = step_fn(params, state,
                                       batch_at(dc, i, device=dev))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(2, 5):
                params, state, _ = step_fn(params, state,
                                           batch_at(dc, i, device=dev))
            torch.cuda.synchronize()
        events_ = device_events(prof)
        log(f"[train] (b) profiled steps (3): {len(events_) / 3:.1f} device "
            f"activities a step, {len({e.name for e in events_})} distinct, "
            f"idle share {idle_share(events_):.4f}")
    return profiled


def kill_and_resume(ckpt_dir: str) -> tuple:
    """tests/test_launch.py:66 on the card: ``python -m
    repro_torch.launch.train`` (reduced Qwen1.5-0.5B, 12 steps, a
    checkpoint every 4) killed once its first checkpoint lands, then
    relaunched with ``--resume auto`` to the end; returns the checkpoint
    before the kill, and the relaunch's exit code and output.  Neither
    process outlives the call."""
    import os
    from repro_torch.checkpoint import ckpt
    args = [sys.executable, "-m", "repro_torch.launch.train",
            "--arch", "qwen1.5-0.5b", "--reduced", "--steps", "12",
            "--global-batch", "4", "--seq-len", "32",
            "--ckpt-dir", ckpt_dir, "--ckpt-every", "4",
            "--resume", "auto", "--log-every", "2"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.Popen(args, env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
                         stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 300
        while time.time() < deadline and p.poll() is None \
                and ckpt.latest_step(ckpt_dir) is None:
            time.sleep(0.2)
    finally:
        p.kill()
        p.wait()
    first = ckpt.latest_step(ckpt_dir)
    r = subprocess.run(args, env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    return first, r.returncode, r.stdout + r.stderr


def train_resume(dev, tmp, killed):
    """[train] (c): the result of ``kill_and_resume`` (``killed``: its
    checkpoint directory, result and seconds), then in one process 8
    steps + checkpoint + restore + 4 steps bitwise equal to 12 steps
    under deterministic algorithms."""
    import os
    import torch

    from repro_torch import configs, models
    from repro_torch.checkpoint import ckpt
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.training import optimizer as topt
    from repro_torch.training import train as ttrain
    t2 = time.perf_counter()
    d = killed["dir"]
    first, rc, out = killed["run"]
    check(first is not None and first >= 4,
          f"[train] (c) no checkpoint before the kill ({first})")
    check(rc == 0, f"[train] (c) relaunch exited {rc}: {out}")
    check("resumed from step" in out and ckpt.latest_step(d) == 12,
          f"[train] (c) relaunch did not resume to step 12: {out}")
    resumed_line = next(x for x in out.splitlines()
                        if "resumed from step" in x)
    # in one process, under deterministic algorithms
    torch.use_deterministic_algorithms(True)
    rcfg = configs.reduced(configs.get_config("qwen1.5-0.5b"))
    rdc = DataConfig(vocab=rcfg.vocab, seq_len=32, global_batch=4)
    ropt = topt.OptConfig(lr=3e-3, warmup_steps=20, total_steps=12)
    rstep = ttrain.make_train_step(rcfg, ttrain.TrainConfig(opt=ropt),
                                   device=dev)

    def start():
        p_ = models.make_params(rcfg, torch.Generator().manual_seed(0),
                                dev)
        return p_, topt.init_opt_state(p_)

    def run(p_, s_, steps):
        for i in steps:
            p_, s_, m_ = rstep(p_, s_, batch_at(rdc, i, device=dev))
        return p_, s_, m_

    p_a, s_a, m_a = run(*start(), range(12))
    p_b, s_b, _ = run(*start(), range(8))
    ckpt.save(os.path.join(tmp, "inproc"), 8, {"params": p_b, "opt": s_b})
    back = ckpt.restore(os.path.join(tmp, "inproc"), 8,
                        {"params": p_b, "opt": s_b}, dev)
    del p_b, s_b
    p_b, s_b, m_b = run(back["params"], back["opt"], range(8, 12))
    torch.use_deterministic_algorithms(False)
    a_, b_ = train_state(p_a, s_a), train_state(p_b, s_b)
    same = [k for k in a_ if torch.equal(a_[k], b_[k])]
    check(len(same) == len(a_) and float(m_a["loss"]) == float(m_b["loss"]),
          f"[train] (c) resumed != uninterrupted in "
          f"{sorted(set(a_) - set(same))}")
    log(f"[train] (c) killed after its step-{first} checkpoint, "
        f"relaunched: '{resumed_line}', ended at step "
        f"{ckpt.latest_step(d)}; in one process 8 steps + checkpoint + "
        f"restore + 4 steps == 12 steps bitwise in {len(same)} of "
        f"{len(a_)} leaves (deterministic algorithms), last loss "
        f"{float(m_b['loss']):.6f}; the launcher's two processes "
        f"{killed['s']:.1f} s (beside (a)), the rest "
        f"{time.perf_counter() - t2:.1f} s")


# train_100m's steps in [train] (d): its settings run 300, but at about
# 0.41 s a step on the card (host-bound) they would take the script past
# its time limit (since [dist] was added, 100 do too); 20 still log twice,
# and its checkpoint interval is cut to them so that it writes one
STEPS_100M = 20


def train_example(tmp):
    """[train] (d): ``repro_torch.train_100m`` at its settings but
    ``STEPS_100M`` steps: its loss falls; ms a step from its logged
    tokens/s."""
    import contextlib
    import io
    import math
    import os
    import re

    import numpy as np

    from repro_torch import configs, models, train_100m
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import train as launch
    from repro_torch.models.modules import tree_leaves
    t3 = time.perf_counter()
    configs.REGISTRY[train_100m.CONFIG.name] = train_100m.CONFIG
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        argv = train_100m.argv(STEPS_100M, os.path.join(tmp, "100m"))
        argv[argv.index("--ckpt-every") + 1] = str(STEPS_100M)
        final = launch.main(argv)
    wall = time.perf_counter() - t3
    lines = [x for x in out.getvalue().splitlines() if x.startswith("step ")]
    for x in lines:
        log(f"[train] (d) {x}")
    logged = [(int(m.group(1)), float(m.group(2)), float(m.group(3)))
              for m in (re.match(r"step (\d+): loss=([0-9.]+) .*tok/s=(\d+)",
                                 x) for x in lines)]
    check(len(logged) >= 2 and np.isfinite(final)
          and logged[-1][1] < logged[0][1] - 1.0,
          f"[train] (d) train_100m's loss did not fall: {lines}")
    saved = ckpt.latest_step(os.path.join(tmp, "100m"))
    check(saved == STEPS_100M, f"[train] (d) its checkpoint is at {saved}")
    tok_s = statistics.median(t for _, _, t in logged[1:])
    n100 = sum(math.prod(s.shape) for s in tree_leaves(
        models.param_specs(train_100m.CONFIG)))
    log(f"[train] (d) train_100m (qwen-100m: {n100} params, 16 x 256 "
        f"tokens, 2 microbatches, lr 1e-3, a checkpoint after "
        f"{STEPS_100M} steps; {STEPS_100M} of its 300 steps): "
        f"loss {logged[0][1]:.4f} at step {logged[0][0]} -> "
        f"{logged[-1][1]:.4f} at step {logged[-1][0]}; "
        f"{16 * 256 / tok_s * 1e3:.3f} ms a step at the logged median "
        f"{tok_s:.0f} tokens/s; {STEPS_100M} steps in {wall:.1f} s with its "
        f"checkpoint at step {saved}")


def train_worker() -> int:
    """[train] and [dist] in a process of their own (``chip_smoke.py
    --train-worker``), for the same reason as [model]: the profiled steps
    must slow no later phase.  Started with ``CUBLAS_WORKSPACE_CONFIG``
    set, so that [train] (a) and (c) and [dist] (a) can ask for
    deterministic algorithms."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    train_phase(torch.device("cuda"))
    return 0


# -- [dist] the mesh half of the training path ---------------------------------
DIST_TC = dict(microbatches=2, seq_shard=True)    # [dist] (a)'s TrainConfig
DIST_STEPS = 3                                    # [dist] (b)'s steps a run
DIST_DECODE = 4                                   # [dist] (b)'s decode steps


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def plain(tree):
    """A tree of DTensors (and tensors) as plain tensors, gathered whole."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.modules import tree_map
    if isinstance(tree, (list, tuple)):
        return type(tree)(plain(t) for t in tree)
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


def mesh_step(cfg, params, batch, mesh, rules=None, **tc):
    """One ``make_train_step`` step on a mesh: copies of ``params`` laid
    out by ``rules`` (default: ``DEFAULT_RULES``), lr TRAIN_LR from the
    first step; returns (params, opt_state, metrics) as plain tensors."""
    from repro_torch import models
    from repro_torch.distributed import sharding as sh
    from repro_torch.models.modules import tree_map
    from repro_torch.training import optimizer as topt
    from repro_torch.training import train as ttrain
    dev = mesh.device_type
    p = tree_map(lambda a: a.detach().clone().to(dev), params)
    st = topt.init_opt_state(p)
    specs = models.param_specs(cfg)
    p = sh.distribute(p, sh.param_shardings(specs, mesh, rules))
    st = sh.distribute(st, sh.opt_state_shardings(specs, mesh, rules))
    step = ttrain.make_train_step(cfg, ttrain.TrainConfig(
        opt=topt.OptConfig(lr=TRAIN_LR, warmup_steps=1), **tc), mesh)
    return plain(step(p, st, {k: v.to(dev) for k, v in batch.items()}))


def compressed_step(cfg, params, batch, mesh):
    """One int8 ``make_compressed_train_step`` step on a mesh (plain
    params, the same on every rank), lr TRAIN_LR from the first step."""
    from repro_torch.models.modules import tree_map
    from repro_torch.training import optimizer as topt
    from repro_torch.training import train as ttrain
    dev = mesh.device_type
    p = tree_map(lambda a: a.detach().clone().to(dev), params)
    step = ttrain.make_compressed_train_step(cfg, ttrain.TrainConfig(
        compress_grads="int8", opt=topt.OptConfig(lr=TRAIN_LR,
                                                  warmup_steps=1)), mesh)
    return step(p, topt.init_opt_state(p),
                {k: v.to(dev) for k, v in batch.items()})


# the int8 compressed step, card against CPU: a grad element whose f32
# value differs in its last bits may round to the next int8 quantum of the
# shared scale (max |g| / 127), which moves its first moment by (1 - b1)
# of a quantum and its second by up to twice that, relative to the leaf's
# largest, and its param by up to 2 lr (Adam's first step)
COMPRESSED_QUANTA = 2


# against a plain bf16 step, whose clip rounds each grad to bf16 (within
# 2^-8 of itself, so its square within 2^-7), its moments may differ by
# that too
BF16_CLIP_ROUNDING = 2.0 ** -7


def compressed_held(got, want, what, extra=0.0) -> dict:
    """An int8 compressed step's (params, opt_state, metrics) against
    another's: loss to 1e-4, params to 2 lr + 1e-4, moments to
    COMPRESSED_QUANTA int8 quanta of the leaf's largest (plus ``extra``
    of it); the readings."""
    import torch
    gs, ws = train_state(*got[:2]), train_state(*want[:2])
    r = dict(loss=held(got[2]["loss"], want[2]["loss"], 1e-4, f"{what} loss"),
             params=0.0, moments=0.0)
    for k in ws:        # on ``got``'s device: at full width, gigabytes
        g = gs[k].detach().float()
        w = ws[k].detach().float().to(g.device)
        check(g.shape == w.shape and bool(torch.isfinite(g).all()),
              f"{what} {k}: shape {tuple(g.shape)} against "
              f"{tuple(w.shape)}, or not finite")
        d = float((g - w).abs().max())
        if k.startswith("params/"):
            check(d <= 2 * TRAIN_LR + 1e-4, f"{what} {k}: max abs err {d:.4g}")
            r["params"] = max(r["params"], d)
        elif k != "opt/step":
            mx = d / max(float(w.abs().max()), 1e-30)
            check(mx <= COMPRESSED_QUANTA / 127 + extra + 1e-4,
                  f"{what} {k}: max error {mx:.4g} of the leaf's largest")
            r["moments"] = max(r["moments"], mx)
    return r


def dist_cases():
    """[dist] (a)'s cases: each arch at ``reduced()`` in f32, its params
    (seed 0) and batch (B, S = 2, 64), on the CPU."""
    import torch

    from repro_torch import configs, models
    for arch in configs.ARCH_IDS:
        cfg = dataclasses.replace(configs.reduced(configs.get_config(arch)),
                                  dtype="float32")
        yield arch, cfg, models.make_params(
            cfg, torch.Generator().manual_seed(0), "cpu"), \
            model_batch(models, cfg, 2, 64, "train", 1)


DIST_CPU_WORKERS = 5       # [dist]'s CPU route: processes, cases split


def dist_cpu_worker(out: str, part: int) -> int:
    """[dist]'s CPU route (``chip_smoke.py --dist-cpu-worker OUT PART``):
    the mesh step of every DIST_CPU_WORKERS-th [dist] (a) case from
    ``part`` (part 0 also the int8 compressed step of Qwen1.5-0.5B's), on
    a one-rank gloo (1, 1) mesh, saved to OUT.  The steps are bound by
    DTensor's Python dispatch, so the cases run in processes side by
    side, each with its share of the cores."""
    import os
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import sharding as sh
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // DIST_CPU_WORKERS))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = sh.make_mesh((1, 1), ("data", "model"), "cpu")
        res = {}
        for i, (arch, cfg, params, batch) in enumerate(dist_cases()):
            if i % DIST_CPU_WORKERS == part:
                res[arch] = mesh_step(cfg, params, batch, mesh, **DIST_TC)
            if part == 0 and arch == "qwen1.5-0.5b":
                res["compressed"] = compressed_step(cfg, params, batch, mesh)
        torch.save(res, out)
    finally:
        dist.destroy_process_group()
    return 0


def dist_run(ones, cpu, cpu_out) -> None:
    """[dist] in [train]'s process, after [train] (d): a one-rank NCCL
    process group on the card and its (1, 1) mesh; ``ones`` holds
    [train] (a)'s two-microbatch one-device steps, which are [dist] (a)'s
    (``seq_shard`` is the identity off a mesh), and ``cpu`` the CPU
    route's processes (started beside [train] (a)), each writing its
    file of ``cpu_out``."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1,
                            device_id=dev)
    try:
        dist_phase(dev, cpu, cpu_out, tmp, ones)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[dist] total {time.perf_counter() - t0:.1f} s")


def dist_phase(dev, cpu, cpu_out, tmp, ones):
    """[dist]: (a) each reduced arch's mesh step on the card's (1, 1) NCCL
    mesh against its one-device step (``ones``; bitwise) and against the CPU
    route's gloo mesh ([train] (a)'s tolerances); (b) Qwen1.5-0.5B at
    full width on the mesh under three layouts against the one-device
    step, and its int8 compressed step; (c) checkpoints; (d) the
    launcher's device check and the kernels' launch counts."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch import configs, models
    from repro_torch.checkpoint import ckpt
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch
    from repro_torch.models.modules import tree_leaves, tree_map
    from repro_torch.training import optimizer as topt
    from repro_torch.training import train as ttrain
    mesh = sh.make_mesh((1, 1), ("data", "model"), "cuda")
    backend = dist.get_backend(mesh.get_group("data"))
    check(backend == "nccl", f"[dist] the mesh's backend is {backend}")
    # -- (a) the reduced archs
    t1 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    card, bitwise, differ = {}, [], {}
    for arch, cfg, params, batch in dist_cases():
        card[arch] = got = mesh_step(cfg, params, batch, mesh, **DIST_TC)
        want = ones[arch]
        gs, ws = train_state(*got[:2]), train_state(*want[:2])
        same = all(torch.equal(gs[k], ws[k]) for k in ws) and all(
            torch.equal(got[2][k], want[2][k]) for k in want[2])
        if same:
            bitwise.append(arch)
        else:
            differ[arch] = step_held(
                got, tuple(tree_map(lambda t: t.cpu(), x) for x in want),
                params, arch, "float32",
                f"[dist] (a) {arch} mesh vs one device")
    torch.use_deterministic_algorithms(False)
    cpu_res = {}
    for p, out in zip(cpu, cpu_out):
        p.wait(timeout=600)
        check(p.returncode == 0, f"[dist] the CPU route exited {p.returncode}")
        cpu_res.update(torch.load(out))
    worst = {}
    for arch, cfg, params, batch in dist_cases():
        worst[arch] = step_held(card[arch], cpu_res[arch], params, arch,
                                "float32", f"[dist] (a) {arch} card vs CPU "
                                           f"mesh")
    for arch, cfg, params, batch in dist_cases():
        if arch == "qwen1.5-0.5b":
            comp_r = compressed_held(
                compressed_step(cfg, params, batch, mesh),
                cpu_res["compressed"], "[dist] (a) int8 compressed step "
                                       "card vs CPU")
    log(f"[dist] (a) ten reduced archs in f32, one step ({DIST_TC}) on the "
        f"card's one-rank NCCL (1, 1) mesh: bitwise equal to the one-device "
        f"step in {len(bitwise)} of 10"
        + (f" (the rest within [train] (a)'s tolerances: "
           + ", ".join(f"{a}: params {r['params']:.3g} of the tolerance, "
                       f"loss {r['loss']:.3g}" for a, r in differ.items())
           + ")" if differ else "")
        + "; card vs the CPU route's gloo mesh: " + ", ".join(
            f"{a} loss {r['loss']:.3g} params {r['params']:.3g}"
            for a, r in worst.items())
        + f"; the int8 compressed step card vs CPU: loss {comp_r['loss']:.3g}"
          f", params {comp_r['params']:.3g} (2 lr + 1e-4: "
          f"{2 * TRAIN_LR + 1e-4:g}), moments {comp_r['moments']:.4g} of the "
          f"leaf's largest ({COMPRESSED_QUANTA} int8 quanta: "
          f"{COMPRESSED_QUANTA / 127:.4g}); "
          f"{time.perf_counter() - t1:.1f} s")
    # -- (b) Qwen1.5-0.5B at full width
    t1 = time.perf_counter()
    cfg = configs.get_config("qwen1.5-0.5b")
    B, S = 8, 512
    opt = topt.OptConfig(lr=3e-3, warmup_steps=20, total_steps=30)
    dc = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B)
    specs = models.param_specs(cfg)
    base = models.make_params(cfg, torch.Generator(device=dev).manual_seed(0),
                              dev)
    batch_at(dc, 0, device=dev)            # the lookup tables, copied once

    def run(rules=None, seq_shard=False, on_mesh=True):
        p = tree_map(lambda a: a.detach().clone(), base)
        st = topt.init_opt_state(p)
        tc = ttrain.TrainConfig(microbatches=2, seq_shard=seq_shard,
                                remat_policy="full", opt=opt)
        if on_mesh:
            p = sh.distribute(p, sh.param_shardings(specs, mesh, rules))
            st = sh.distribute(st, sh.opt_state_shardings(specs, mesh, rules))
            step = ttrain.make_train_step(cfg, tc, mesh)
        else:
            step = ttrain.make_train_step(cfg, tc, device=dev)
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(DIST_STEPS + 1)]
        losses = []
        torch.cuda.synchronize()
        ev[0].record()
        for i in range(DIST_STEPS):
            p, st, m = step(p, st, batch_at(dc, i, device=dev))
            ev[i + 1].record()
            losses.append(m["loss"])
        torch.cuda.synchronize()
        ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(DIST_STEPS)]
        if on_mesh:
            check(all(isinstance(x, DTensor) for x in tree_leaves(p)),
                  "[dist] (b) the mesh step's params are not all DTensors")
        return p, st, [float(x) for x in losses], ms

    ops.reset_launches()
    one_p, one_st, one_losses, one_ms = run(on_mesh=False)
    want = train_state(one_p, one_st)
    layouts = {}
    for name, rules, seq in (("DEFAULT_RULES", sh.DEFAULT_RULES, False),
                             ("FSDP_RULES", sh.FSDP_RULES, False),
                             ("DEFAULT_RULES + seq_shard", sh.DEFAULT_RULES,
                              True)):
        p, st, losses, ms = run(rules, seq)
        got = train_state(*plain((p, st)))
        off = [k for k in want if not torch.equal(got[k], want[k])]
        err = max(float((got[k].detach().float() - want[k].detach().float())
                        .abs().max()) for k in want if k.startswith("params/"))
        # on a (1, 1) mesh every op is the one-device op: bitwise
        check(losses == one_losses and not off,
              f"[dist] (b) {name}: not bitwise equal to the one-device step "
              f"(losses {losses} against {one_losses}; {len(off)} leaves "
              f"differ, params max abs err {err:.4g})")
        layouts[name] = statistics.median(ms[1:])
        if name == "DEFAULT_RULES":
            mesh_state = (p, st)
        else:
            del p, st
    counts = ops.launch_counts()
    check(not any(counts.values()), f"[dist] (b) the mesh path launched one "
                                    f"of the port's kernels: {counts}")
    # the int8 compressed step at DP 1, full width, against one plain step
    small = {k: v.to(dev) for k, v in batch_at(dc, 0, device=dev).items()}
    tc1 = ttrain.TrainConfig(opt=topt.OptConfig(lr=TRAIN_LR, warmup_steps=1))
    pc = tree_map(lambda a: a.detach().clone(), base)
    comp = ttrain.make_compressed_train_step(cfg, dataclasses.replace(
        tc1, compress_grads="int8"), mesh)(pc, topt.init_opt_state(pc), small)
    pw = tree_map(lambda a: a.detach().clone(), base)
    ref1 = ttrain.make_train_step(cfg, tc1, device=dev)(
        pw, topt.init_opt_state(pw), small)
    # at DP 1 the sync is the int8 round trip of the rank's own grads:
    # each element within half a quantum, so the moments within
    # COMPRESSED_QUANTA of the leaf's largest, plus the plain step's bf16
    # rounding of its clipped grads, and the params within 2 lr
    check(float(comp[2]["loss"]) == float(ref1[2]["loss"]),
          f"[dist] (b) int8 compressed step at DP 1: loss "
          f"{float(comp[2]['loss'])} against {float(ref1[2]['loss'])}")
    comp_r = compressed_held(comp, ref1, "[dist] (b) int8 compressed step "
                                         "at DP 1 vs the plain step",
                             extra=BF16_CLIP_ROUNDING)
    del pc, pw, comp, ref1
    log(f"[dist] (b) Qwen1.5-0.5B full width, bf16, remat 'full', 2 "
        f"microbatches of 4 x {S}, {DIST_STEPS} steps, lr 3e-3 warmup 20; "
        f"one device: {statistics.median(one_ms[1:]):.3f} ms a step (median "
        f"of steps 2-{DIST_STEPS}), losses {[round(x, 4) for x in one_losses]}")
    for name, ms in layouts.items():
        log(f"[dist] (b) mesh (1, 1) NCCL, {name}: {ms:.3f} ms a step "
            f"({ms / statistics.median(one_ms[1:]):.2f} times one device: "
            f"DTensor's host cost), bitwise equal to one device")
    log(f"[dist] (b) int8 compressed step at DP 1, full width: loss equal "
        f"to the plain step's, params max abs err {comp_r['params']:.4g} "
        f"(2 lr + 1e-4: {2 * TRAIN_LR + 1e-4:g}), moments "
        f"{comp_r['moments']:.4g} of the leaf's largest ({COMPRESSED_QUANTA} "
        f"int8 quanta and the plain step's bf16 rounding: "
        f"{COMPRESSED_QUANTA / 127 + BF16_CLIP_ROUNDING:.4g}); launches of "
        f"the port's kernels {counts}; {time.perf_counter() - t1:.1f} s")
    # one Qwen1.5-0.5B decode step after another on the mesh, the cache
    # laid out by kv_cache_sharding (model.on_cache_shards), against the
    # one-device steps: bitwise on the (1, 1) mesh
    from torch.distributed.tensor.experimental import implicit_replication
    t1 = time.perf_counter()
    serve = sh.distribute(tree_map(lambda a: a.detach().clone(), base),
                          sh.param_shardings(specs, mesh))
    one_st = models.init_decode_state(cfg, B, 64, device=dev)
    mesh_st = sh.distribute(models.init_decode_state(cfg, B, 64, device=dev),
                            sh.kv_cache_sharding(mesh, one_st))
    toks = torch.randint(0, cfg.vocab, (DIST_DECODE, B), device=dev,
                         dtype=torch.int32, generator=torch.Generator(
                             device=dev).manual_seed(5))
    ops.reset_launches()
    with torch.no_grad(), implicit_replication():
        for t in range(DIST_DECODE):
            one_st, want_l = models.decode_step(cfg, base, one_st, toks[t], t)
            mesh_st, got_l = models.decode_step(cfg, serve, mesh_st, toks[t],
                                                t)
            check(isinstance(got_l, DTensor)
                  and torch.equal(plain(got_l), want_l),
                  f"[dist] (b) decode step {t} on the mesh: logits not "
                  f"bitwise equal to one device's")
    check(all(isinstance(x, DTensor) for x in tree_leaves(mesh_st))
          and all(torch.equal(a, b) for a, b in zip(
              tree_leaves(plain(mesh_st)), tree_leaves(one_st))),
          "[dist] (b) the mesh's decode state differs from one device's")
    check(not any(ops.launch_counts().values()),
          "[dist] (b) the mesh's decode launched one of the port's kernels")
    log(f"[dist] (b) Qwen1.5-0.5B full width, {DIST_DECODE} decode steps of "
        f"B {B} on the mesh (params under DEFAULT_RULES, the cache laid out "
        f"by kv_cache_sharding, model.on_cache_shards): logits and state "
        f"bitwise equal to one device's; {time.perf_counter() - t1:.1f} s")
    del serve, one_st, mesh_st
    # -- (c) checkpoints
    import os
    t1 = time.perf_counter()
    p = mesh_state[0]
    ckpt.save(os.path.join(tmp, "mesh"), DIST_STEPS, p)
    ckpt.save(os.path.join(tmp, "one"), DIST_STEPS, plain(p))
    a, b = (Path(tmp) / d / f"step_{DIST_STEPS}" for d in ("mesh", "one"))
    names = sorted(f.name for f in a.iterdir())
    check(names == sorted(f.name for f in b.iterdir()) and all(
        (a / n).read_bytes() == (b / n).read_bytes() for n in names),
        "[dist] (c) the mesh's checkpoint files differ from one device's")
    back = ckpt.restore(os.path.join(tmp, "mesh"), DIST_STEPS, p,
                        sh.param_shardings(specs, mesh, sh.FSDP_RULES))
    check(all(isinstance(x, DTensor) for x in tree_leaves(back))
          and all(torch.equal(a, b) for a, b in zip(
              tree_leaves(plain(back)), tree_leaves(plain(p)))),
          "[dist] (c) the restore is not bitwise")
    del p, back, mesh_state
    log(f"[dist] (c) the params after (b)'s {DIST_STEPS} DEFAULT_RULES "
        f"steps, {len(names) - 1} leaves, saved from the mesh: files "
        f"byte-equal to a one-device save; restored with FSDP_RULES "
        f"placements bitwise; {time.perf_counter() - t1:.1f} s")
    # -- (d) the launcher on one card
    try:
        launch.main(["--arch", "qwen1.5-0.5b", "--reduced", "--steps", "1",
                     "--data", "2", "--model", "1"])
        raised = ""
    except ValueError as exc:
        raised = str(exc)
    n_dev = torch.cuda.device_count()
    check("needs 2 CUDA devices" in raised and f"{n_dev} visible" in raised,
          f"[dist] (d) launch.train --data 2 --model 1 on {n_dev} card(s) "
          f"did not raise naming the count: {raised!r}")
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"[dist] (d) launch.train --data 2 --model 1: {raised}; the card's "
        f"total_memory {total} B (distributed.sharding.H100_HBM_BYTES "
        f"{sh.H100_HBM_BYTES})")
    check(total == sh.H100_HBM_BYTES or "H100" not in
          torch.cuda.get_device_name(0),
          "[dist] H100_HBM_BYTES is not this H100's total_memory")


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import sass as sass_mod
    from repro_torch.kernels import paged_attention as pa_mod
    from repro_torch.kernels import pt_walk as pt_walk_mod
    from repro_torch.memsys import tiered_kv as tkv
    from repro_torch.serving import serve_tiered as st

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # -- 1. toolchain and card ------------------------------------------------
    card = card_line()
    log(f"[1] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"[1] nvidia-smi: {card}")

    # -- 2. build -------------------------------------------------------------
    built = build.build()
    log(f"[2] built {built.path.name} in {built.seconds:.2f} s")
    # one line per kernel entry: its (mangled) name, registers and spills
    name = spill = ""
    for line in built.log.splitlines():
        if "Function properties for" in line:
            name = line.split("for", 1)[1].strip()
        elif "spill stores" in line:
            spill = line.strip()
        elif "registers" in line:
            log(f"[2]   ptxas: {name}: {line.split(':', 1)[1].strip()}; "
                f"{spill}")
    # the fast window's f32 chain must be separate roundings: no FMA
    _, sass = sass_mod.opcodes(build.CSRC / "fast_window.cu")
    for kname, opc in sass.items():
        check(opc["FFMA"] == 0 and opc["FFMA32I"] == 0,
              f"{kname}: {opc['FFMA']} FFMA in the SASS of fast_window.cu")
        log(f"[2] fast_window.cu SASS {kname}: {sum(opc.values())} "
            f"instructions, FFMA {opc['FFMA']}, FMUL {opc['FMUL']}, "
            f"FADD {opc['FADD']}")

    # -- 3. kernels against their plain versions ------------------------------
    gen = torch.Generator(device="cpu").manual_seed(0)
    err = {"pt_walk": 0.0, "block_copy": 0.0}

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    def walk_case(rows, n_leaf, max_leaf, fanout, n, strided=False):
        """``strided``: entries as the engine passes them, the slot column
        of a [n_leaf, F, 2] (tier, slot) table."""
        upper = randint(-1, n_leaf, (rows, max_leaf))
        ltier = randint(-1, 2, (n_leaf,))
        if strided:
            lent = randint(-1, 4096, (n_leaf, fanout, 2))[:, :, 1]
        else:
            lent = randint(-1, 4096, (n_leaf, fanout))
        vb = randint(0, max_leaf * fanout, (n,))
        got = ops.pt_walk(upper, ltier, lent, vb)
        want = ref.pt_walk_ref(upper, ltier, lent, vb)
        for g, w in zip(got, want):
            check(torch.equal(g, w), f"pt_walk {rows}x{max_leaf} n={n}")
            err["pt_walk"] = max(err["pt_walk"], float((g - w).abs().max()))
        return upper, ltier, lent, vb

    def copy_case(G, p_src, p_dst, tail, m, dtype):
        src = torch.randn((G, p_src) + tail, generator=gen).to(dtype).to(dev)
        dst = torch.randn((G, p_dst) + tail, generator=gen).to(dtype).to(dev)
        ids = torch.stack([torch.randperm(p_src, generator=gen)[:m],
                           torch.randperm(p_dst, generator=gen)[:m]],
                          1).to(torch.int32).to(dev)
        want = ref.block_copy_ref(src, dst.clone(), ids)
        got = ops.block_copy(src, dst, ids)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"block_copy {G}x{p_src}->{p_dst} m={m}")
        err["block_copy"] = max(err["block_copy"],
                                float((got.float() - want.float()).abs().max()))

    geo = configs.KV
    tail = (geo.block_size, geo.kv_heads, geo.head_dim)
    # the decode tick's walk: 4 active rows, FANOUT 64, max_blocks queries
    for burst in (st.SERVE_TIERED, st.PRESSURE):
        max_blocks = -(-burst.max_seq // geo.block_size)
        max_leaf = -(-max_blocks // tkv.FANOUT)
        walk_case(burst.active_slots, burst.n_seqs * max_leaf, max_leaf,
                  tkv.FANOUT, max_blocks, strided=True)
    # tests/test_kernels.py's walk shapes (n_leaf, fanout, n)
    for n_leaf, fanout, n in [(4, 64, 256), (16, 64, 512), (8, 128, 1024),
                              (8, 128, 512), (8, 128, 768), (8, 64, 5),
                              (8, 64, 100), (8, 64, 300), (8, 64, 257),
                              (8, 64, 769)]:
        walk_case(1, n_leaf, n_leaf, fanout, n)
    # queries past the upper row and below zero, a leaf id past the table:
    # JAX's answer (tests/test_torch_kernels.py holds it to the TPU kernel)
    oor = [torch.tensor(a, dtype=torch.int32, device=dev) for a in (
        [5, -1, 0, 1], [0, 1, 1], [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]],
        [0, 5, 17, 40, -1, -100, -17, 3])]
    tier, slot = ops.pt_walk(*oor)
    check(tier.tolist() == [1, -1, 1, 1, 1, 1, 1, 1]
          and slot.tolist() == [8, -1, 5, 4, 7, 8, 11, 11],
          f"pt_walk out-of-range queries: {tier.tolist()} {slot.tolist()}")
    # the migration copy at full width: cold -> hot and hot -> cold pools
    copy_case(geo.n_groups, 2048, 256, tail, 10, geo.dtype)
    copy_case(geo.n_groups, 48, 1024, tail, 8, geo.dtype)
    # tests/test_kernels.py's copy shapes (P, bs, KH, Dh, M), f32 and bf16
    for dtype in (torch.float32, torch.bfloat16):
        for P, bs, KH, Dh, M in [(8, 8, 1, 128, 1), (16, 16, 2, 128, 5),
                                 (32, 8, 4, 256, 12)]:
            copy_case(1, P, P, (bs, KH, Dh), M, dtype)
    # block_copy_pools: 1 and 2 pool pairs in one launch, at the serving
    # width at M = 1, 6, 128, and blocks of 2.5 and 1.25 chunks (40 KiB
    # bf16, 20 KiB f32) with id pairs outside the pools (JAX's answer:
    # counted from the end once, sources clamped, destinations dropped).
    # ``free`` destinations at the pool's top are left to the bad pairs, so
    # no destination repeats (with a repeat the last writer is undefined)
    def pools_case(n_pairs, G, p_src, p_dst, tail, m, dtype, bad=(), free=0):
        srcs = [torch.randn((G, p_src) + tail, generator=gen).to(dtype).to(dev)
                for _ in range(n_pairs)]
        dsts = [torch.randn((G, p_dst) + tail, generator=gen).to(dtype).to(dev)
                for _ in range(n_pairs)]
        ids = torch.stack([torch.randperm(p_src, generator=gen)[:m],
                           torch.randperm(p_dst - free, generator=gen)[:m]],
                          1).to(torch.int32).to(dev)
        if bad:
            ids = torch.cat([ids, torch.tensor(bad, dtype=torch.int32,
                                               device=dev)])
        want = [ref.block_copy_ref(s, d.clone(), ids) for s, d in zip(srcs, dsts)]
        got = ops.block_copy_pools(list(zip(srcs, dsts)), ids)
        torch.cuda.synchronize()
        what = f"block_copy_pools {n_pairs} pairs {G}x{p_src}->{p_dst} {tail} m={m}"
        for g, w in zip(got, want):
            check(torch.equal(g, w), what)
            err["block_copy"] = max(err["block_copy"],
                                    float((g.float() - w.float()).abs().max()))

    for n_pairs in (1, 2):
        for m in (1, 6, 128):
            pools_case(n_pairs, geo.n_groups, 256, 160, tail, m, geo.dtype)
        # copies 39 -> 23, 39 -> 22, 3 -> 21, 0 -> 20, 39 -> 19; drops
        # (0, 24) and (0, -25)
        pools_case(n_pairs, 3, 40, 24, (20, 16, 64), 6, torch.bfloat16,
                   bad=[[40, 23], [-1, 22], [0, 24], [3, -3], [-45, -4],
                        [0, -25], [77, 19]], free=5)
        pools_case(n_pairs, 1, 12, 9, (5, 16, 64), 4, torch.float32)
    torch.cuda.empty_cache()

    # the tick's walk: row ids gathered, walked and reduced to a flag per
    # row in one launch, at both bursts' tick shapes, for each tier value
    def walk_any_case(r, n_seqs, n_leaf, max_leaf, fanout, n, tier):
        upper = randint(-1, n_leaf, (n_seqs, max_leaf))
        ltier = randint(-1, 2, (n_leaf,))
        lent = randint(-1, 4096, (n_leaf, fanout, 2))[:, :, 1]
        vb = randint(0, max_leaf * fanout, (n,))
        rows = randint(0, n_seqs, (r,))
        got = ops.pt_walk_rows_any(upper, rows, ltier, lent, vb, tier)
        want = ref.pt_walk_rows_any_ref(upper, rows, ltier, lent, vb, tier)
        check(torch.equal(got, want), f"pt_walk_rows_any {r} of {n_seqs} "
                                      f"rows n={n} tier={tier}")
        err["pt_walk"] = max(err["pt_walk"], float((got - want).abs().max()))

    for burst in (st.SERVE_TIERED, st.PRESSURE):
        max_blocks = -(-burst.max_seq // geo.block_size)
        max_leaf = -(-max_blocks // tkv.FANOUT)
        for tier in (tkv.HOT, tkv.COLD, -1):
            walk_any_case(burst.active_slots, burst.n_seqs,
                          burst.n_seqs * max_leaf, max_leaf, tkv.FANOUT,
                          max_blocks, tier)
    for r, n_seqs, n_leaf, max_leaf, n in [(1, 3, 8, 8, 512), (33, 40, 12, 40, 200),
                                           (4, 16, 16, 1, 1000)]:
        walk_any_case(r, n_seqs, n_leaf, max_leaf, 64, n, tkv.COLD)
    # out-of-range queries and row ids (negative: counted from the end)
    # through the flags: row 0 reads tier 1 at every valid query
    oor_upper = torch.stack([oor[0], torch.full_like(oor[0], -1)])
    for rows, t, want in (([0, 1, 0], 1, [1, 0, 1]), ([1, -2, 5], -1, [1, 1, 1]),
                          ([0, -1], 0, [0, 0])):
        rows = torch.tensor(rows, dtype=torch.int32, device=dev)
        got = ops.pt_walk_rows_any(oor_upper, rows, *oor[1:], t)
        plain = ref.pt_walk_rows_any_ref(oor_upper, rows, *oor[1:], t)
        check(got.tolist() == plain.tolist() == want,
              f"pt_walk_rows_any out of range: {got.tolist()} "
              f"{plain.tolist()} want {want}")
    log(f"[3] kernels equal their plain versions on the card "
        f"(max abs err {err})")
    torch.cuda.empty_cache()

    # -- 4. the served bursts (the main path) ---------------------------------
    runs = [("serve_tiered", st.SERVE_TIERED, True),
            ("kv_tiering/radiant", st.PRESSURE, True),
            ("kv_tiering/immobile", st.PRESSURE, False)]
    served, launches = {}, {"pt_walk": 0, "block_copy": 0}
    # warm-up at reduced width: PyTorch loads its CUDA kernels lazily, and
    # the first burst's clock should not carry that one-time cost
    st.serve(st.PRESSURE, geometry=configs.REDUCED)
    # blocks moved by each migration, kept on the card (no sync) and read
    # after the burst: the count that block_copy's launches must equal
    migrate = tkv.migrate_sequence
    moved_by = []

    def counted_migrate(kv, *args, **kwargs):
        before = kv.stats[tkv.STAT_BLK_PROMOTE] + kv.stats[tkv.STAT_BLK_DEMOTE]
        migrate(kv, *args, **kwargs)
        moved_by.append(kv.stats[tkv.STAT_BLK_PROMOTE]
                        + kv.stats[tkv.STAT_BLK_DEMOTE] - before)
        return kv

    tkv.migrate_sequence = counted_migrate
    for name, burst, radiant in runs:
        moved_by.clear()
        ops.reset_launches()
        res = st.serve(burst, radiant=radiant)
        counts = ops.launch_counts()
        migrations = int((torch.stack(moved_by) > 0).sum())
        s = res.stats
        kvs = [int(x) for x in res.engine.kv.stats]
        n_req = len(burst.prompts)
        log(f"[4] {name}: requests {n_req} ticks {s.steps} tokens {s.tokens} "
            f"swaps {s.swaps_in}/{s.swaps_out} cold_walks {s.cold_walks} "
            f"violations {res.violations} kv.stats {kvs} launches {counts} "
            f"prefill {res.prefill_s:.3f} s decode {res.decode_s:.3f} s "
            f"({res.tokens_per_s:.1f} tok/s)")
        check(all(r.state == "done" for r in res.engine.requests.values()),
              f"{name}: requests left undone")
        check(s.tokens == n_req * burst.max_new, f"{name}: tokens {s.tokens}")
        if radiant:
            check(s.cold_walks == 0, f"{name}: cold_walks {s.cold_walks}")
            check(res.violations == 0, f"{name}: violations {res.violations}")
        else:
            check(s.cold_walks > 0, f"{name}: immobile tables walked no "
                                    f"cold leaf page")
        check(counts["pt_walk"] == s.steps,
              f"{name}: pt_walk launches {counts['pt_walk']} != ticks {s.steps}")
        moved = kvs[tkv.STAT_BLK_PROMOTE] + kvs[tkv.STAT_BLK_DEMOTE]
        log(f"[4] {name}: {len(moved_by)} migrations, {migrations} moved "
            f"blocks ({moved} blocks in all)")
        check(migrations > 0 and counts["block_copy"] == migrations,
              f"{name}: block_copy launches {counts['block_copy']} != "
              f"{migrations} migrations that moved blocks")
        for k in launches:
            launches[k] += counts[k]
        served[name] = (res, counts, moved)
    tkv.migrate_sequence = migrate
    torch.cuda.empty_cache()

    # -- 5. the pressure bursts again on the CPU, through the plain versions --
    for name, burst, radiant in runs[1:]:
        cpu = st.serve(burst, radiant=radiant, device="cpu")
        gpu = served[name][0]
        check(dataclasses.asdict(cpu.stats) == dataclasses.asdict(gpu.stats),
              f"{name}: EngineStats differ from the CPU run")
        for f in tkv.FIELDS:
            check(torch.equal(getattr(gpu.engine.kv, f).cpu(),
                              getattr(cpu.engine.kv, f)),
                  f"{name}: field {f} differs from the CPU run")
        log(f"[5] {name}: card state == CPU state on all {len(tkv.FIELDS)} "
            f"fields (CPU decode {cpu.decode_s:.3f} s)")
    del cpu, gpu
    served = {k: v for k, v in served.items() if k == "serve_tiered"}
    torch.cuda.empty_cache()

    # -- 6. timing ------------------------------------------------------------
    def walk_bytes(upper, lent, vb):
        """Bytes the walk must move on these inputs, each word once: the
        upper rows and the queries, the tier of each leaf page reached and
        each entry gathered, both [R, N] outputs."""
        fanout = lent.shape[1]
        vbl = vb.long()
        li = vbl // fanout
        leaf = upper.long()[:, li.clamp(max=upper.shape[1] - 1)]
        ok = (li < upper.shape[1]) & (leaf >= 0) & (leaf < lent.shape[0])
        reached = leaf[ok]
        entries = (leaf * fanout + vbl % fanout)[ok]
        return 4 * (upper.numel() + vb.numel() + reached.unique().numel()
                    + entries.unique().numel() + 2 * leaf.numel())

    # pt_walk at the serve_tiered decode tick's shape and entry layout
    b = st.SERVE_TIERED
    max_blocks = -(-b.max_seq // geo.block_size)
    max_leaf = -(-max_blocks // tkv.FANOUT)
    upper, ltier, lent, vb = walk_case(b.active_slots, b.n_seqs * max_leaf,
                                       max_leaf, tkv.FANOUT, max_blocks,
                                       strided=True)
    walk = dict(
        ms=device_ms(lambda: ops.pt_walk(upper, ltier, lent, vb)),
        plain_ms=device_ms(lambda: ref.pt_walk_ref(upper, ltier, lent, vb)),
        call_ms=host_ms(lambda: ops.pt_walk(upper, ltier, lent, vb)),
        bound_ms=walk_bytes(upper, lent, vb) / HBM_BYTES_PER_S * 1e3,
        library_ms=None,
        shape=f"R={upper.shape[0]} max_leaf={max_leaf} "
              f"n_leaf={ltier.numel()} F={tkv.FANOUT} N={vb.numel()}")

    # the decode tick's whole walk over the engine's table (n_seqs rows, R
    # of them active): four separate ops (gather the rows, walk, compare,
    # reduce) against one launch of pt_walk_rows_any; the eager
    # host time of each is the engine's call, row-id copy and flag read
    # included
    table = randint(-1, b.n_seqs * max_leaf, (b.n_seqs, max_leaf))
    rids = list(range(0, b.n_seqs, b.n_seqs // b.active_slots))
    idx = torch.tensor(rids, dtype=torch.int32, device=dev)
    idx64 = idx.long()

    def tick_old(rows=idx64):
        tier, _ = ops.pt_walk(table[rows], ltier, lent, vb)
        return (tier == tkv.COLD).any(dim=1)

    def tick_new(rows=idx):
        return ops.pt_walk_rows_any(table, rows, ltier, lent, vb, tkv.COLD)

    check(tick_old().tolist() == [bool(f) for f in tick_new().tolist()],
          "the tick's walk: four ops and one launch disagree")

    def walk_any_bytes(table, rows, vb):
        """Bytes the tick's walk must move: the row ids, the upper rows they
        name, the queries, the tier of each leaf page reached, the flags."""
        li = (vb.long() // lent.shape[1]).clamp(max=table.shape[1] - 1)
        leaf = table.long()[rows.long()][:, li]
        reached = leaf[leaf >= 0].clamp(max=ltier.numel() - 1).unique()
        return 4 * (2 * rows.numel() + rows.numel() * table.shape[1]
                    + vb.numel() + reached.numel())

    tick = dict(
        ms=device_ms(tick_new), old_ms=device_ms(tick_old),
        floor_ms=device_ms(lambda: pt_walk_mod.empty_cuda(dev)),
        plain_ms=device_ms(lambda: ref.pt_walk_rows_any_ref(
            table, idx, ltier, lent, vb, tkv.COLD)),
        call_ms=host_ms(lambda: [bool(f) for f in tick_new(
            torch.tensor(rids, dtype=torch.int32, device=dev)).tolist()]),
        old_call_ms=host_ms(lambda: tick_old(
            torch.tensor(rids, device=dev)).tolist()),
        bound_ms=walk_any_bytes(table, idx, vb) / HBM_BYTES_PER_S * 1e3,
        library_ms=None,
        shape=f"R={len(rids)} of {b.n_seqs} rows, max_leaf={max_leaf} "
              f"n_leaf={ltier.numel()} F={tkv.FANOUT} N={vb.numel()}")

    # block_copy at the serve_tiered burst's mean blocks per migration, cold
    # -> hot at full width, K and V pools in one launch, and one pool at
    # that M and at M = 128; id sets rotate so the 50 MB L2 does not serve
    # reuse
    res, counts, moved = served["serve_tiered"]
    m = max(1, round(moved / counts["block_copy"]))
    del served, res
    torch.cuda.empty_cache()
    cold = [torch.randn((geo.n_groups, b.n_cold) + tail, dtype=geo.dtype,
                        device=dev, generator=torch.Generator(
                            device=dev).manual_seed(seed)) for seed in (1, 2)]
    hot = [torch.zeros((geo.n_groups, b.n_hot) + tail, dtype=geo.dtype,
                       device=dev) for _ in range(2)]
    block_bytes = cold[0][:, 0].numel() * cold[0].element_size()

    def id_sets(m, k=32):
        return [torch.stack([torch.randperm(b.n_cold, generator=gen)[:m],
                             torch.randperm(b.n_hot, generator=gen)[:m]],
                            1).to(torch.int32).to(dev) for _ in range(k)]

    def copy_times(m, n_pairs):
        pairs = list(zip(cold, hot))[:n_pairs]
        cyc = itertools.cycle(id_sets(m))

        def plain():
            ids = next(cyc)
            for src, dst in pairs:
                ref.block_copy_ref(src, dst, ids)

        def library():                   # one indexed assignment, one pool
            ids = next(cyc)
            pairs[0][1][:, ids[:, 1]] = pairs[0][0][:, ids[:, 0]]

        def kernel():                    # ops.block_copy for one pair
            ids = next(cyc)
            if n_pairs == 1:
                ops.block_copy(*pairs[0], ids)
            else:
                ops.block_copy_pools(pairs, ids)

        def per_pool():                  # one ops.block_copy call per pool
            ids = next(cyc)
            for src, dst in pairs:
                ops.block_copy(src, dst, ids)

        return dict(ms=device_ms(kernel), plain_ms=device_ms(plain),
                    library_ms=device_ms(library) if n_pairs == 1 else None,
                    call_ms=host_ms(kernel), per_pool_call_ms=host_ms(per_pool),
                    bound_ms=(2 * n_pairs * m * block_bytes + 8 * m)
                    / HBM_BYTES_PER_S * 1e3,
                    shape=f"{n_pairs} pool pair(s), G={geo.n_groups} "
                          f"P={b.n_cold}->{b.n_hot} block={tail} {geo.dtype} "
                          f"M={m}")

    copy = copy_times(m, 2)
    one = copy_times(m, 1)
    big = copy_times(128, 1)
    for name, t in (("pt_walk", walk), ("the tick's walk (pt_walk_rows_any)", tick),
                    ("block_copy_pools (K and V)", copy),
                    ("block_copy (one pool)", one),
                    ("block_copy (one pool, M=128)", big)):
        log(f"[6] {name} [{t['shape']}]: kernel {t['ms']:.7f} ms "
            f"(eager call {t['call_ms']:.5f} ms) plain {t['plain_ms']:.5f} ms "
            f"library {t['library_ms']} bound {t['bound_ms']:.7f} ms "
            f"({t['bound_ms'] / t['ms']:.3f} of the bound)")
    log(f"[6] the tick's walk: one launch {tick['ms']:.7f} ms against the "
        f"four separate ops {tick['old_ms']:.7f} ms (device, in a graph); "
        f"eager engine call {tick['call_ms']:.5f} ms against "
        f"{tick['old_call_ms']:.5f} ms; an empty kernel {tick['floor_ms']:.7f}"
        f" ms (the floor of one launch)")
    log(f"[6] block_copy eager host time, K and V at M={m}: one "
        f"block_copy_pools call {copy['call_ms']:.5f} ms against one "
        f"block_copy call per pool {copy['per_pool_call_ms']:.5f} ms")
    gbps = 2 * 128 * block_bytes / big["ms"] / 1e6
    log(f"[6] block_copy M=128 moves {gbps:.0f} GB/s "
        f"({gbps / (HBM_BYTES_PER_S / 1e9):.3f} of 3.35 TB/s)")
    del cold, hot
    log(f"[6] total wall {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()

    # -- 7. paged attention through ops.paged_attention -----------------------
    from repro_torch.configs import qwen1_5_0_5b, qwen2_5_14b
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in f32
    # tests/test_kernels.py's tolerances; f16 (not in the JAX tests) 1e-2,
    # its reason in tests/test_torch_paged_attention.py
    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 1e-2}
    err["paged_attention"] = 0.0
    row_worst = dict.fromkeys(ref.ATTN_ROW_TOL, 0.0)

    def attn_inputs(*args):
        return ref.paged_attention_inputs(*args, device=dev)

    def attn_check(what, args, got=None, kernel=True):
        """``got`` against the plain version; ``kernel``: ``got`` came from
        the kernel, so its error counts in the ``kernels`` line, and a
        16-bit result is also held, row by row, to the f32 answer on its
        own inputs (``ref.ATTN_ROW_TOL``)."""
        if got is None:
            got = ops.paged_attention(*args)
        want = ref.paged_attention_public(*args)
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype
              and bool(torch.isfinite(got).all()), f"{what}: shape or dtype "
              f"{tuple(got.shape)} {got.dtype}, or non-finite values")
        diff = (got.float() - want.float()).abs()
        t = tol[got.dtype]
        close = bool((diff <= t + t * want.float().abs()).all())
        rel, limit = 0.0, ref.ATTN_ROW_TOL.get(got.dtype)
        if kernel and limit is not None:
            want32 = ref.paged_attention_public(*[
                a.float() if a.is_floating_point() else a for a in args])
            rel = float(ref.attention_row_error(got, want32).max())
            row_worst[got.dtype] = max(row_worst[got.dtype], rel)
        check(close and (limit is None or rel <= limit),
              f"{what}: max abs err {float(diff.max()):.4g} "
              f"({'within' if close else 'over'} the elementwise tolerance "
              f"{t:g}); largest row error {rel:.4g} of the row's rms "
              f"against the f32 answer (limit {limit})")
        if kernel:
            err["paged_attention"] = max(err["paged_attention"],
                                         float(diff.max()))
        return float(diff.max())

    # (a) test shapes: test_paged_attention_sweep's, groups that run on
    # larger instances (G = 3, 7, 12 on 4, 8 and two chunks of 8), head
    # dims 80 and 192 on the 128 and 256 instances, blocks of 4 and 12
    # positions, -1 entries past each length, and rows with
    # lengths == 0 (the oracle's uniform mean), in f32, bf16 and f16
    worst = dict.fromkeys(tol, 0.0)
    rng = np.random.default_rng(42)
    for dtype in tol:
        for B, KH, G, Dh, P, bs, NB in ref.ATTN_TEST_SHAPES:
            lengths = rng.integers(1, NB * bs + 1, B)
            args = attn_inputs(B, KH, G, Dh, P, bs, NB, dtype, lengths, B * NB)
            worst[dtype] = max(worst[dtype], attn_check(
                f"attention {B}x{KH}x{G}x{Dh} P{P} bs{bs} NB{NB} {dtype}", args))
        for B, KH, G, Dh, P, bs, NB, lengths in ref.ATTN_FIXED_LENGTHS:
            args = attn_inputs(B, KH, G, Dh, P, bs, NB, dtype, lengths, 8)
            check(bool((args[3] == -1).any()), "no -1 entry in the table")
            got = ops.paged_attention(*args)
            worst[dtype] = max(worst[dtype], attn_check(
                f"attention lengths {lengths} {G}x{Dh} bs{bs} {dtype}", args,
                got))
            if 0 not in lengths:
                continue
            z = lengths.index(0)
            blocks = args[3][z].clamp(min=0)
            mean = args[2][:, blocks].float().reshape(KH, -1, Dh).mean(1)
            check(bool(torch.allclose(got[z].float().reshape(KH, G, Dh),
                                      mean[:, None].expand(KH, G, Dh),
                                      atol=tol[dtype], rtol=tol[dtype])),
                  f"attention lengths == 0 {dtype}: not the uniform mean of V")
    log(f"[7] attention kernel == plain version at the test shapes, -1 "
        f"entries and lengths == 0 (max abs err "
        + ", ".join(f"{str(d)[6:]} {worst[d]:.3g} tol {tol[d]:g}" for d in tol)
        + "; largest row error over the row's rms, against the f32 answer: "
        + ", ".join(f"{str(d)[6:]} {row_worst[d]:.4g} limit "
                    f"{ref.ATTN_ROW_TOL[d]:g}" for d in row_worst) + ")")
    # the split rule's CTAs per SM of the tensor-core kernel, fixed by its
    # shared-memory ring, against the card's occupancy query
    resident = {(d, dh): pa_mod.occupancy(d, dh, dev)
                for d in (torch.bfloat16, torch.float16)
                for dh in (64, 128, 256)}
    check(all(n == pa_mod.ctas_per_sm(d, dh)
              for (d, dh), n in resident.items()),
          f"tensor-core kernel CTAs per SM {resident} differ from "
          f"paged_attention.ctas_per_sm")
    log(f"[7] tensor-core kernel CTAs per SM at head dims 64 / 128 / 256: "
        f"{' / '.join(str(resident[torch.bfloat16, dh]) for dh in (64, 128, 256))}"
        f" (bf16 and f16), as paged_attention.ctas_per_sm sets them")

    # (b) full width, bf16, bs 16, 8 sequences, through ops.paged_attention
    widths = [("Qwen1.5-0.5B", qwen1_5_0_5b.N_HEADS, qwen1_5_0_5b.N_KV_HEADS,
               qwen1_5_0_5b.HEAD_DIM, 256, 2304),
              ("Qwen2.5-14B", qwen2_5_14b.N_HEADS, qwen2_5_14b.N_KV_HEADS,
               qwen2_5_14b.HEAD_DIM, 512, 4352)]
    B, bs = 8, 16
    attn, attn_launches = {}, 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, H, KH, Dh, NB, P in widths:
        lengths = np.random.default_rng(0).integers(1, NB * bs + 1, B)
        lengths[:3] = NB * bs, 1, (lengths[2] - 1) // bs * bs + bs // 2
        args = attn_inputs(B, KH, H // KH, Dh, P, bs, NB, torch.bfloat16,
                           lengths, 0)
        ops.reset_launches()
        out = ops.paged_attention(*args)
        counts = ops.launch_counts()
        check(counts["paged_attention"] == 1,
              f"{name}: {counts['paged_attention']} attention launches for 1 call")
        attn_launches += counts["paged_attention"]
        row_worst[torch.bfloat16] = 0.0
        e = attn_check(f"attention {name} full width", args, out)
        rel = row_worst[torch.bfloat16]
        f32 = [a.float() if a.is_floating_point() else a for a in args]
        e32 = attn_check(f"attention {name} full width f32", f32)
        del f32
        attn[name] = dict(args=args, lengths=lengths, H=H, KH=KH, Dh=Dh, NB=NB)
        per_sm = pa_mod.ctas_per_sm(torch.bfloat16, Dh)
        log(f"[7] {name}: B {B} H {H} KH {KH} Dh {Dh} bs {bs} NB {NB} P {P} "
            f"{args[1].numel() * 2 / 1e6:.1f} MB per pool, lengths "
            f"{lengths.tolist()} launches {counts} out {tuple(out.shape)} "
            f"max abs err bf16 {e:.3g} (tol 2e-2), largest row error "
            f"{rel:.4g} of the row's rms against the f32 answer (limit "
            f"{ref.ATTN_ROW_TOL[torch.bfloat16]:g}), f32 {e32:.3g} (tol "
            f"1e-5); bf16 kernel: {per_sm} CTAs per SM, "
            f"{pa_mod.num_splits(B, KH, H // KH, NB, sms, per_sm)}"
            f" splits of a sequence")
    torch.cuda.empty_cache()

    # (c) timing: kernel, plain version, and SDPA on K/V gathered beforehand
    for name, a in attn.items():
        q, kp, vp, tables, lengths_t = a["args"]
        KH, Dh, NB, H = a["KH"], a["Dh"], a["NB"], a["H"]
        G = H // KH
        n_visit = -(-a["lengths"] // bs)
        elt = kp.element_size()
        touched = (2 * KH * int(n_visit.sum()) * bs * Dh * elt     # K and V
                   + 2 * q.numel() * elt + 4 * int(n_visit.sum()) + 4 * B)
        safe = tables.long().clamp(min=0)
        k_dense = kp[:, safe].movedim(0, 1).reshape(B, KH, NB * bs, Dh)
        v_dense = vp[:, safe].movedim(0, 1).reshape(B, KH, NB * bs, Dh)
        mask = (torch.arange(NB * bs, device=dev)[None, :]
                < lengths_t[:, None])[:, None, None, :]
        q4 = q.reshape(B, KH, G, Dh)
        library = F.scaled_dot_product_attention(q4, k_dense, v_dense,
                                                 attn_mask=mask)
        attn_check(f"attention {name}: SDPA yardstick", a["args"],
                   library.reshape(B, H, Dh), kernel=False)
        a.update(
            ms=device_ms(lambda: ops.paged_attention(q, kp, vp, tables,
                                                     lengths_t)),
            plain_ms=device_ms(lambda: ref.paged_attention_public(
                q, kp, vp, tables, lengths_t), reps=5),
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                q4, k_dense, v_dense, attn_mask=mask), reps=5),
            call_ms=host_ms(lambda: ops.paged_attention(q, kp, vp, tables,
                                                        lengths_t)),
            bound_ms=touched / HBM_BYTES_PER_S * 1e3, bytes=touched)
        del k_dense, v_dense
        log(f"[7] {name} attention: kernel {a['ms']:.5f} ms (eager call "
            f"{a['call_ms']:.5f} ms) plain {a['plain_ms']:.5f} ms library "
            f"(SDPA, gather excluded) {a['library_ms']:.5f} ms bound "
            f"{a['bound_ms']:.5f} ms ({touched} B touched); "
            f"{touched / a['ms'] / 1e6:.0f} GB/s, "
            f"{a['bound_ms'] / a['ms']:.3f} of 3.35 TB/s")
    log(f"[7] total wall {time.perf_counter() - t_start:.1f} s")

    # -- 8-10. the simulator ---------------------------------------------------
    torch.cuda.empty_cache()
    err["alloc_scan"], _, alloc_t = alloc_scan_phase(dev)
    err["fast_window"], window_t = fast_window_phase(dev)
    sim_launches, replays = quickstart_phase()
    log(f"[9] total wall {time.perf_counter() - t_start:.1f} s")
    held, solo10 = cpu_route_phase()
    log(f"[10] blocked vs per-step f32 timeline keys: {held.count('bitwise')} "
        f"of {len(held)} cases bitwise, the rest to rtol 1e-6")
    served = service_phase(solo10)
    log(f"[service] total wall {time.perf_counter() - t_start:.1f} s")
    tenants = multitenant_phase()
    log(f"[multitenant] total wall {time.perf_counter() - t_start:.1f} s")
    # the simulator's main paths: [9]'s solo run, [service] (a)'s broker
    # flush and [multitenant]'s two runs
    launches.update({k: sim_launches[k] + served[k] + tenants[k]
                     for k in sim_launches})
    steady_state_phase()
    log(f"[steady] total wall {time.perf_counter() - t_start:.1f} s")
    launch_count_phase(replays)
    log(f"[10] total wall {time.perf_counter() - t_start:.1f} s")
    # -- [model] the model stack's serving path, in a process of its own
    torch.cuda.empty_cache()
    model = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--model-worker"], timeout=900)
    check(model.returncode == 0, f"[model] exited {model.returncode}")
    log(f"[model] total wall {time.perf_counter() - t_start:.1f} s")
    # -- [train] the model stack's training path and [dist] its mesh half,
    # in a process of their own
    import os
    train = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--train-worker"], timeout=900,
                           env=dict(os.environ,
                                    CUBLAS_WORKSPACE_CONFIG=":4096:8"))
    check(train.returncode == 0, f"[train] exited {train.returncode}")
    log(f"[train] and [dist] total wall {time.perf_counter() - t_start:.1f} s")
    left = live_children()
    check(not left, f"processes this script started are still running: {left}")

    # -- 11. result lines -----------------------------------------------------
    kernels = []
    main = attn["Qwen1.5-0.5B"]
    launches["paged_attention"] = attn_launches
    for name, t, replaces in (
            ("pt_walk", tick, "src/repro/kernels/pt_walk.py:44"),
            ("block_copy", copy, "src/repro/kernels/block_copy.py:25"),
            ("paged_attention", main,
             "src/repro/kernels/paged_attention.py:81"),
            ("alloc_scan", alloc_t,
             "src/repro/core/alloc.py:201 (alloc_many's lax.scan body; no "
             "Pallas original)"),
            ("fast_window", window_t,
             "src/repro/core/sim.py:939-1113 (_build_fast_window but the "
             "f32 row sums; no Pallas original)")):
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=replaces, launches=launches[name],
            max_abs_err=err[name], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by="bytes",
            library_ms=t["library_ms"]))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cpu-route-worker"]:
        sys.exit(cpu_route_worker(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--oracle-worker"]:
        sys.exit(oracle_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--multitenant-worker"]:
        sys.exit(multitenant_worker(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--model-worker"]:
        sys.exit(model_worker())
    if sys.argv[1:2] == ["--dist-cpu-worker"]:
        sys.exit(dist_cpu_worker(sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] == ["--train-worker"]:
        sys.exit(train_worker())
    sys.exit(main())
