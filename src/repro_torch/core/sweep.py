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
upward.  One device: ``lane_sharding`` must be ``None``, and there is no
``lane_mesh``.  There is no ``telemetry``, as the facade has none.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

from .config import CostConfig, MachineConfig, PolicyConfig
from .sim import (DEFAULT_BLOCK, BlockedRunner, RunResult, Stepper, Trace,
                  _normalize_blocked, check_engine, pow2ceil, stack_leaves)

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
                device=None,
                ) -> List[RunResult]:
    """Run L independent (cost, policy, trace) lanes as one batched run.

    Lane ``i`` simulates ``traces[i]`` under ``policies[i]`` / ``ccs[i]``;
    all traces must share one ``[steps, threads]`` shape.  ``budget``
    raises the scan's candidate bound above the lanes' largest
    ``autonuma_budget``, ``group`` the allocator's conflict-group bound
    above the lanes' own; neither changes a result.  ``engine`` / ``block``
    select the stepper (see ``core.sim``); the per-step engine and the
    sequential fault path need ``debug=True``.  ``lane_sharding`` must be
    ``None`` (one device).  ``device`` (``None``: the CUDA device) holds
    the lanes' state.
    """
    return sweep_runner(mc, ccs, policies, traces, phase_b=phase_b,
                        budget=budget, lane_sharding=lane_sharding,
                        engine=engine, block=block, group=group, debug=debug,
                        device=device).advance().results()


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
                 device=None):
    """:func:`sweep_lanes` as a run in progress, as
    ``TieredMemSimulator.runner`` is a run's: the arguments checked, the
    lanes' engine made (a ``sim.BlockedRunner``, or a ``sim.Stepper`` for
    ``engine="per_step"``), nothing run yet; ``advance`` runs windows (or
    steps), ``results`` gives a RunResult per lane."""
    check_engine(engine, phase_b, debug)
    if lane_sharding is not None:
        raise ValueError(f"lane_sharding must be None: the port runs its "
                         f"lanes on one device, got {lane_sharding!r}")
    if len(policies) == 0:
        raise ValueError("sweep_lanes needs at least one lane")
    # the engine checks the lanes, their traces and the overrides
    kw = dict(phase_b=phase_b, device=device, budget=budget, group=group)
    if engine == "blocked":
        runner = BlockedRunner(mc, ccs, policies, traces, block=block, **kw)
        stp, eff_block, geom = runner.stepper, runner.block, runner.plan.geom
        program = runner.plan.n_windows
    else:
        runner = stp = Stepper(mc, ccs, policies, traces, **kw)
        eff_block = min(int(block), pow2ceil(stp.n_steps))
        geom, program = None, stp.n_steps
    eff_group = stp.group if phase_b == "batched" else None
    sig = (stp.budget, phase_b, eff_group)
    if engine == "blocked":
        sig = _normalize_blocked(*sig, geom)
    _SIGNATURES.add((mc, *sig, engine, eff_block, geom, stp.L, program))
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
        engine=engine, block=block, debug=debug, device=device)
    results = [flat[j * P_:(j + 1) * P_] for j in range(M)]
    return results[0] if single else results
