"""Batched policy sweeps: N policies x M traces as lanes of one engine
(twin of the JAX package's ``core/sweep.py``).

Every benchmark of the reproduction compares page-table placement
policies on identical access traces.  The reference stacks the policies
(and optionally several same-shape padded traces) into a leading *lane*
axis and vmaps its step over it.  Here the engine itself carries the lane
axis (``sim.Stepper``, ``sim.BlockedRunner``): every state field is
``[L, ...]``, every ``CostConfig`` / ``PolicyConfig`` value a per-lane
tensor, and each step's eager ops, the allocator scan and each fast
window's kernel launch serve all lanes at once, so a sweep pays the
host's per-step work once instead of once per lane.

Two entry points share the engine:

  * :func:`sweep` — the figure-style cross product: N policies x M traces.
  * :func:`sweep_lanes` — one lane per independent ``(cost, policy,
    trace)`` tuple (the service broker's microbatch primitive);
    :func:`sweep_runner` is the same as a run in progress.

Execution is time-blocked by default (``engine="blocked"``): windows are
planned once from the *union* event schedule over the lanes (frees, scan
ticks, faults), so window boundaries are lane-shared and
policy-independent; a lane with no event in a window another lane needs
runs it step by step too, which is exact.  ``engine="per_step"`` keeps
the step-at-a-time reference.

Correctness contract: a sweep lane equals the corresponding
``TieredMemSimulator`` run bit for bit (placements, counters, f32 cycles
and timelines: a solo run is the one-lane case of the same engine, and
the engine's f32 sums do not depend on the lane count), and the JAX
package's sweep lane (integers exact, cycles to float32 rounding).

Constraints, as in the reference: all traces share one ``[steps,
threads]`` shape (``pad_trace``); all AutoNUMA-enabled policies share
``autonuma_period`` (the scan schedule is one host predicate); the scan's
candidate bound is the largest ``autonuma_budget`` of the lanes (or the
``budget`` override, which may only raise it), and each lane's own budget
gates through masks; the allocator's conflict-group bound (``group``)
is the power of two of the lanes' most winners in a step, overridable
upward.

``lane_sharding`` shards the lane axis over devices, as the reference's
lane mesh does: ``None`` runs every lane in one engine on ``device``;
``"auto"`` takes :func:`lane_mesh` of the lane count (the visible CUDA
devices, or ``[device]`` when that is not CUDA); a :class:`LaneMesh`
is taken as it is.  Each device runs one engine over its block of lanes,
the engines advance in lockstep (a window, or for the per-step engine a
step, each in turn, so that the devices' work overlaps), and the results
come out in lane order.  A lane's bits do not depend on the lane count,
so the split is bitwise; on one device ``"auto"`` is the degenerate mesh
of one, run as a mesh.

``telemetry`` (optional :class:`repro_torch.obs.Telemetry`) records the
reference's counters and spans: ``sweep.calls`` / ``sweep.lanes`` per
engine, the window classification (``sweep.windows_*``, or
``sweep.steps`` for the per-step engine) and a ``sweep.prepare`` span
when the lanes' engine is made (:func:`sweep_runner`); the
``sweep.device_seconds`` histogram and, when tracing, a ``sweep.device``
span from the first window's start to the lanes' results on the host
with one ``window.fast`` / ``window.event`` span per window, the time
spread uniformly over the windows (:func:`sweep_lanes`).  The hooks are
host-side and read no device value; the results' own read to the host
is the one wait the span closes on.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..obs import or_null
from .config import CostConfig, MachineConfig, PolicyConfig
from .sim import (DEFAULT_BLOCK, BlockedRunner, RunResult, Stepper, Trace,
                  _normalize_blocked, check_engine, plan_windows, pow2ceil,
                  stack_leaves, window_counters, window_spans)

# The reference compiles one program per distinct signature; this set
# holds the signatures its sweeps would have compiled (see compile_count).
_SIGNATURES = set()


def compile_count() -> int:
    """The number of distinct programs the reference's
    ``sweep()`` / ``sweep_lanes()`` would have compiled for the calls made
    here so far.

    The port compiles nothing per key: its engine runs eager ops and
    kernels built once from the repository's sources.  What it counts is
    the reference's own accounting, so that callers holding a broker to
    "one compile per shape bucket" keep their meaning: one signature per
    distinct (machine, candidate bound, fault path, engine, window size,
    group bound, window geometry, lane count, program shape), with the
    bound, fault path and group normalized where a blocked geometry never
    reads them (``sim._normalize_blocked``), and the program shape the
    window count for the blocked engine (the shape of its compiled scan)
    or the step count for the per-step one.
    """
    return len(_SIGNATURES)


def stack_policies(policies: Sequence[PolicyConfig], device=None
                   ) -> PolicyConfig:
    """Stack N PolicyConfigs into one whose fields are ``[N]`` tensors on
    ``device`` (int32, float32 or bool, as the reference's)."""
    return stack_leaves(policies, device)


@dataclasses.dataclass(frozen=True)
class LaneMesh:
    """A 1-D ``"lanes"`` mesh: the devices a sweep's lane axis is split
    over, block ``i`` of the lanes on ``devices[i]``."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("lanes",)

    @property
    def size(self) -> int:
        return len(self.devices)


def lane_mesh(n_lanes: int, devices=None) -> LaneMesh:
    """A 1-D ``"lanes"`` mesh over the largest device prefix dividing
    ``n_lanes`` (every device on an evenly divisible lane count; one
    device — the degenerate mesh — when nothing divides).  ``devices``
    defaults to the visible CUDA devices (raises without one)."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    while n > 1 and n_lanes % n:
        n -= 1
    return LaneMesh(tuple(devices[:n]))


def check_lane_sharding(lane_sharding) -> None:
    """Raises unless ``lane_sharding`` is ``None``, ``"auto"`` or a
    :class:`LaneMesh`."""
    if not (lane_sharding is None or isinstance(lane_sharding, LaneMesh)
            or (isinstance(lane_sharding, str) and lane_sharding == "auto")):
        raise ValueError(f"lane_sharding must be None, 'auto' or a "
                         f"LaneMesh, got {lane_sharding!r}")


def _resolve_lane_sharding(lane_sharding, n_lanes: int,
                           device) -> Optional[LaneMesh]:
    check_lane_sharding(lane_sharding)
    if lane_sharding is None:
        return None
    if isinstance(lane_sharding, str) and lane_sharding == "auto":
        dev = resolve_device(device)
        return lane_mesh(n_lanes, None if dev.type == "cuda" else [dev])
    if n_lanes % lane_sharding.size:
        raise ValueError(f"{n_lanes} lanes not divisible by the "
                         f"{lane_sharding.size}-device lane mesh")
    return lane_sharding


class LaneMeshRunner:
    """The engines of a lane mesh, one per device over its block of lanes,
    as one run in progress: :meth:`advance` moves them in lockstep,
    :meth:`results` gives a RunResult per lane in lane order.  ``plan``
    is the window plan of the lanes' union schedule (the reference's one
    program over all lanes), for telemetry; each engine runs its own."""

    def __init__(self, runners, plan):
        self.runners = runners
        self.plan = plan

    @staticmethod
    def _left(r) -> int:
        if isinstance(r, BlockedRunner):
            return r.plan.n_windows - r.w
        return r.n_steps - r.s

    def advance(self, n: Optional[int] = None) -> "LaneMeshRunner":
        """The next ``n`` windows (steps, for the per-step engine) of
        every engine, one at a time each in turn; all that are left by
        default."""
        left = max(self._left(r) for r in self.runners)
        for _ in range(left if n is None else min(int(n), left)):
            for r in self.runners:
                if self._left(r):
                    r.advance(1)
        return self

    def results(self) -> "list[RunResult]":
        return [res for r in self.runners for res in r.results()]


def sweep_lanes(mc: MachineConfig,
                ccs: Sequence[CostConfig],
                policies: Sequence[PolicyConfig],
                traces: Sequence[Trace],
                phase_b: str = "batched",
                budget: Optional[int] = None,
                lane_sharding=None,
                engine: str = "blocked",
                block: int = DEFAULT_BLOCK,
                group: Optional[int] = None,
                debug: bool = False,
                telemetry=None,
                device=None,
                ) -> List[RunResult]:
    """Run L independent (cost, policy, trace) lanes as one batched run.

    Lane ``i`` simulates ``traces[i]`` under ``policies[i]`` / ``ccs[i]``;
    all traces must share one ``[steps, threads]`` shape.  ``budget``
    raises the scan's candidate bound above the lanes' largest
    ``autonuma_budget``, ``group`` the allocator's conflict-group bound
    above the lanes' own; neither changes a result.  ``engine`` / ``block``
    select the stepper (see ``core.sim``); the per-step engine and the
    sequential fault path need ``debug=True``.  ``lane_sharding``: ``None``,
    ``"auto"`` or a :class:`LaneMesh` (see the module's docstring).
    ``telemetry``: see the module's docstring.  ``device`` (``None``: the
    CUDA device) holds the lanes' state when there is no lane mesh.
    """
    tel = or_null(telemetry)
    runner = sweep_runner(mc, ccs, policies, traces, phase_b=phase_b,
                          budget=budget, lane_sharding=lane_sharding,
                          engine=engine, block=block, group=group,
                          debug=debug, telemetry=tel, device=device)
    dev_t0 = tel.now()
    wall_t0 = time.perf_counter()
    results = runner.advance().results()
    if tel.enabled:
        tel.histogram("sweep.device_seconds").observe(
            time.perf_counter() - wall_t0)
    if dev_t0 is not None:
        dev_t1 = tel.now()
        tel.add_span("sweep.device", dev_t0, dev_t1, cat="engine",
                     args={"lanes": len(results), "steps": traces[0].n_steps,
                           "engine": engine})
        if engine == "blocked":
            window_spans(tel, runner.plan, dev_t0, dev_t1)
    return results


def sweep_runner(mc: MachineConfig,
                 ccs: Sequence[CostConfig],
                 policies: Sequence[PolicyConfig],
                 traces: Sequence[Trace],
                 phase_b: str = "batched",
                 budget: Optional[int] = None,
                 lane_sharding=None,
                 engine: str = "blocked",
                 block: int = DEFAULT_BLOCK,
                 group: Optional[int] = None,
                 debug: bool = False,
                 telemetry=None,
                 device=None):
    """:func:`sweep_lanes` as a run in progress, as
    ``TieredMemSimulator.runner`` is a run's: the arguments checked, the
    lanes' engine made (a ``sim.BlockedRunner``, or a ``sim.Stepper`` for
    ``engine="per_step"``), nothing run yet; ``advance`` runs windows (or
    steps), ``results`` gives a RunResult per lane.  ``telemetry`` gets
    the call's counters and its ``sweep.prepare`` span here."""
    tel = or_null(telemetry)
    prep_t0 = tel.now()
    check_engine(engine, phase_b, debug)
    if len(policies) == 0:
        raise ValueError("sweep_lanes needs at least one lane")
    mesh = _resolve_lane_sharding(lane_sharding, len(policies), device)

    # the engine checks the lanes, their traces and the overrides
    def engine_of(lanes, dev):
        kw = dict(phase_b=phase_b, device=dev, budget=budget, group=group)
        args = (ccs[lanes], policies[lanes], traces[lanes])
        if engine == "blocked":
            return BlockedRunner(mc, *args, block=block, **kw)
        return Stepper(mc, *args, **kw)

    def stepper_of(r):
        return r.stepper if engine == "blocked" else r

    ccs, policies, traces = list(ccs), list(policies), list(traces)
    L = len(policies)
    if mesh is None:
        runner = engine_of(slice(None), device)
        parts = [stepper_of(runner)]
    else:
        if not len(ccs) == len(traces) == L:
            raise ValueError(f"lane lists disagree: {len(ccs)} costs, "
                             f"{L} policies, {len(traces)} traces")
        per = L // mesh.size
        parts_r = [engine_of(slice(i * per, (i + 1) * per), d)
                   for i, d in enumerate(mesh.devices)]
        parts = [stepper_of(r) for r in parts_r]
    n_steps = parts[0].n_steps
    eff_block = min(int(block), pow2ceil(n_steps))
    eff_budget = max(p.budget for p in parts)
    eff_group = max(p.group for p in parts) if phase_b == "batched" \
        else None
    plan, geom, program = None, None, n_steps
    if engine == "blocked":
        if mesh is None:
            plan = runner.plan
        else:        # the one program's plan, over the union of all lanes
            def union(attr):
                return np.logical_or.reduce([getattr(p, attr) for p in parts])
            plan = plan_windows(union("do_free"), union("do_scan"),
                                union("has_fault"), n_steps, eff_block)
        geom, program = plan.geom, plan.n_windows
    if mesh is not None:
        runner = LaneMeshRunner(parts_r, plan)
    sig = (eff_budget, phase_b, eff_group)
    if engine == "blocked":
        sig = _normalize_blocked(*sig, geom)
    _SIGNATURES.add((mc, *sig, engine, eff_block, geom, L, program,
                     None if mesh is None else mesh.size))
    if tel.enabled:
        tel.counter("sweep.calls", engine=engine).inc()
        tel.counter("sweep.lanes", engine=engine).inc(L)
        if engine == "blocked":
            window_counters(tel, "sweep", plan)
        else:
            tel.counter("sweep.steps").inc(n_steps)
        if prep_t0 is not None:
            tel.add_span("sweep.prepare", prep_t0, tel.now(), cat="engine",
                         args={"lanes": L, "steps": n_steps,
                               "engine": engine})
    return runner


def sweep(mc: MachineConfig,
          cc: Union[CostConfig, Sequence[CostConfig]],
          policies: Sequence[PolicyConfig],
          traces: Union[Trace, Sequence[Trace]],
          phase_b: str = "batched",
          budget: Optional[int] = None,
          lane_sharding=None,
          engine: str = "blocked",
          block: int = DEFAULT_BLOCK,
          debug: bool = False,
          telemetry=None,
          device=None,
          ) -> Union[List[RunResult], List[List[RunResult]]]:
    """Run every (trace, policy) pair as lanes of one batched run.

    Returns a list of RunResults aligned with ``policies`` when ``traces``
    is a single Trace, else a list-of-lists indexed ``[trace][policy]``.
    ``cc`` may be a single CostConfig (shared) or one per policy.  The
    other arguments pass through to :func:`sweep_lanes`.
    """
    single = isinstance(traces, Trace)
    tr_list = [traces] if single else list(traces)
    policies = list(policies)
    P_, M = len(policies), len(tr_list)
    if P_ == 0 or M == 0:
        raise ValueError("sweep needs at least one policy and one trace")

    ccs = list(cc) if isinstance(cc, (list, tuple)) else [cc] * P_
    if len(ccs) != P_:
        raise ValueError("need one CostConfig per policy (or a shared one)")

    # Lane layout: trace-major, policy-minor (lane = trace_idx * P + pol_idx).
    flat = sweep_lanes(
        mc,
        [c for _ in range(M) for c in ccs],
        [p for _ in range(M) for p in policies],
        [tr for tr in tr_list for _ in range(P_)],
        phase_b=phase_b, budget=budget, lane_sharding=lane_sharding,
        engine=engine, block=block, debug=debug, telemetry=telemetry,
        device=device)
    results = [flat[j * P_:(j + 1) * P_] for j in range(M)]
    return results[0] if single else results
