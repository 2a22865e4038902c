"""Client-side policy-search drivers over the simulation service (twin of
the JAX package's ``service/search.py``).

The archgym-style loop: a search algorithm proposes candidate
configurations, a simulation backend scores them, the algorithm culls and
proposes again.  Here the backend is a :class:`~repro_torch.service.SimBroker`,
so every rung of candidates lands in one shape bucket and runs as one
microbatched ``sweep_lanes`` program — and repeated evaluations (grid
refinements, halving survivors re-scored at longer horizons with the same
spec) hit the content-addressed result cache instead of the device.

Two drivers:

  * :func:`grid_search` — score every candidate on one trace, rank.
  * :func:`successive_halving` — rung 0 scores everyone on a short
    (cheap) trace spec, each following rung keeps the best ``1/eta`` and
    re-scores them on an ``eta``-times longer horizon; the classic
    multi-fidelity budget allocation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..core.config import CostConfig, PolicyConfig, MachineConfig, \
    FIRST_TOUCH, INTERLEAVE, PT_BIND_ALL, PT_BIND_HIGH, PT_FOLLOW_DATA
from ..core.sim import Trace
from ..core.workloads import TraceSpec
from .broker import SimBroker
from .query import SimQuery
from .resilience import ServiceError

DEFAULT_SPACE: Dict[str, Sequence] = {
    "data_policy": (FIRST_TOUCH, INTERLEAVE),
    "pt_policy": (PT_FOLLOW_DATA, PT_BIND_ALL, PT_BIND_HIGH),
    "mig": (False, True),
}


def policy_grid(space: Optional[Dict[str, Sequence]] = None,
                base: Optional[PolicyConfig] = None) -> List[PolicyConfig]:
    """Cartesian product over PolicyConfig field values.

    ``space`` maps field names to candidate values (default: the paper's
    Table-3 axes); ``base`` supplies every unswept field.
    """
    space = dict(DEFAULT_SPACE if space is None else space)
    base = base if base is not None else PolicyConfig()
    grid = [{}]
    for field, values in space.items():
        grid = [dict(g, **{field: v}) for g in grid for v in values]
    return [dataclasses.replace(base, **g) for g in grid]


def grid_search(broker: SimBroker, mc: MachineConfig,
                trace: Union[Trace, TraceSpec],
                policies: Sequence[PolicyConfig],
                cc: Optional[CostConfig] = None,
                objective: str = "total_cycles",
                ) -> List[Tuple[PolicyConfig, float]]:
    """Score every policy on one trace; return (policy, objective) sorted
    ascending (lower is better — objectives are cycle/event counts).

    A candidate whose lane fails with a typed :class:`ServiceError`
    (shed deadline, poisoned, rejected by admission control) is dropped
    from the ranking and counted (``search.dropped_lanes``) instead of
    failing the whole rung — a search over N candidates survives losing
    a few.  Non-service errors still propagate."""
    cc = cc if cc is not None else CostConfig()
    tel = broker.telemetry
    queries = [SimQuery(trace=trace, policy=pc, cost=cc, machine=mc)
               for pc in policies]
    with tel.span("search.grid", args={"candidates": len(queries),
                                       "objective": objective}):
        futs = broker.submit_many(queries)
        broker.drain()
    tel.counter("search.evaluations").inc(len(queries))
    scored = []
    dropped = 0
    for pc, fut in zip(policies, futs):
        try:
            res = fut.result()
        except ServiceError:
            dropped += 1
            continue
        scored.append((pc, float(res.summary()[objective])))
    if dropped:
        tel.counter("search.dropped_lanes").inc(dropped)
    scored.sort(key=lambda t: t[1])
    return scored


def successive_halving(broker: SimBroker, mc: MachineConfig,
                       spec: TraceSpec,
                       policies: Optional[Sequence[PolicyConfig]] = None,
                       cc: Optional[CostConfig] = None,
                       rungs: int = 3, eta: int = 2,
                       objective: str = "total_cycles",
                       ) -> Dict:
    """Multi-fidelity policy search: rung r scores the survivors on
    ``spec`` with ``run_steps * eta**r`` simulated steps, then keeps the
    best ``ceil(n/eta)``.  Returns the winner plus the full history.

    The broker makes each rung one microbatch; because fidelity is part
    of the trace spec (hence the cache key), re-running the search — or
    widening it — only simulates candidates it has never seen at that
    horizon.
    """
    cands = list(policies if policies is not None else policy_grid())
    if not cands:
        raise ValueError("successive_halving needs at least one candidate")
    cc = cc if cc is not None else CostConfig()
    tel = broker.telemetry
    history = []
    for r in range(rungs):
        rung_spec = dataclasses.replace(
            spec, run_steps=spec.run_steps * eta ** r)
        with tel.span("search.rung",
                      args={"rung": r, "run_steps": rung_spec.run_steps,
                            "candidates": len(cands)}):
            scored = grid_search(broker, mc, rung_spec, cands, cc=cc,
                                 objective=objective)
        if not scored:
            raise ServiceError(
                f"successive_halving rung {r}: every candidate lane "
                "failed; nothing left to halve")
        tel.counter("search.rungs").inc()
        history.append({
            "rung": r, "run_steps": rung_spec.run_steps,
            "scores": [(pc.label(), s) for pc, s in scored],
        })
        keep = max((len(cands) + eta - 1) // eta, 1)
        cands = [pc for pc, _ in scored[:keep]]
        if len(cands) == 1 and r < rungs - 1:
            continue                      # still re-score at full fidelity
    best = cands[0]
    return {"best": best, "best_label": best.label(),
            "objective": objective, "history": history}
