"""Service query / future types and their content-addressed identity (twin
of the JAX package's ``service/query.py``).

A :class:`SimQuery` is one independent simulation request.  Its identity
for caching is fully content-addressed: the machine shape, the fault
engine, every cost and policy leaf, and the digest of the (canonical)
trace — never object identity — so two clients asking the same question
share one cache line and one lane.  The port's config dataclasses print
as the reference's do, so a query's key, and its digest, equal the
reference's for an equal query.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple, Union

import torch

from ..core.config import CostConfig, MachineConfig, PolicyConfig
from ..core.sim import RunResult, Trace
from ..core.workloads import TraceSpec, trace_digest


def _leaf_tuple(obj, name: str) -> Tuple:
    """Dataclass -> hashable leaf tuple; rejects traced/stacked leaves
    (service queries are single simulations, not pre-batched bundles)."""
    vals = tuple(getattr(obj, f.name) for f in dataclasses.fields(obj))
    try:
        # a tensor hashes by identity, where a JAX array refuses to
        if any(isinstance(v, torch.Tensor) for v in vals):
            raise TypeError
        hash(vals)
    except TypeError:
        raise ValueError(
            f"{name} for a SimQuery must hold plain Python scalars; got "
            f"array leaves — submit one query per lane and let the broker "
            f"batch them") from None
    return vals


@dataclasses.dataclass(frozen=True)
class SimQuery:
    """One simulation request.

    ``trace`` is either a built :class:`Trace` (used as-is — the caller
    owns its shape) or a :class:`TraceSpec` (service-owned construction:
    the broker builds it once per distinct spec and idle-pads it to a
    power-of-two step count so specs of similar length share a bucket,
    a compile, and a microbatch).

    ``priority`` (higher flushes first) and ``deadline`` (absolute
    broker-clock seconds by which the bucket must flush) drive the
    broker's scheduler; both are identity-irrelevant for caching.

    ``phase_b`` and ``engine`` select the fault engine and the stepper
    (see ``core.sim``); both are part of the query's cache identity and
    of its bucket key (lanes batched into one program must agree).  The
    non-default combinations are reference (oracle) paths and require
    ``debug=True`` — identity-irrelevant, like the scheduler knobs.
    """

    trace: Union[Trace, TraceSpec]
    policy: PolicyConfig
    cost: CostConfig = dataclasses.field(default_factory=CostConfig)
    machine: MachineConfig = dataclasses.field(default_factory=MachineConfig)
    phase_b: str = "batched"
    engine: str = "blocked"
    priority: int = 0
    deadline: Optional[float] = None
    debug: bool = False

    def __post_init__(self):
        if not isinstance(self.trace, (Trace, TraceSpec)):
            raise ValueError(
                f"trace must be a Trace or TraceSpec, got "
                f"{type(self.trace).__name__}")
        if self.phase_b not in ("batched", "sequential"):
            raise ValueError(f"unknown phase_b {self.phase_b!r}")
        if self.engine not in ("blocked", "per_step"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if (self.engine != "blocked" or self.phase_b != "batched") \
                and not self.debug:
            raise ValueError(
                f"engine={self.engine!r} phase_b={self.phase_b!r} are "
                "reference (oracle) paths; pass debug=True to query them")


def query_cache_key(q: SimQuery, canonical: Trace) -> Tuple:
    """Content-addressed identity of a query given its canonical trace."""
    return (q.machine, q.phase_b, q.engine,
            _leaf_tuple(q.cost, "CostConfig"),
            _leaf_tuple(q.policy, "PolicyConfig"), trace_digest(canonical))


def lane_digest(key: Tuple) -> str:
    """Short stable digest of a cache key — the identity that
    ``PoisonedQueryError`` carries, the quarantine deny-list stores, and
    ``fail_lane`` chaos rules match against.  Cache keys are tuples of
    dataclass instances and scalars whose reprs are process-stable, so
    hashing the repr is deterministic across runs."""
    return hashlib.blake2b(repr(key).encode(), digest_size=8).hexdigest()


def spec_cache_key(q: SimQuery, pad_floor: int) -> Tuple:
    """Identity of a spec-addressed query WITHOUT materializing the trace
    — the spec recipe digest (plus the broker's canonical pad floor,
    which determines the padded shape) stands in for the content digest,
    so a cache hit skips trace generation entirely.  The trade-off: a
    spec query and a raw-Trace query with identical content occupy
    separate cache lines."""
    assert isinstance(q.trace, TraceSpec)
    return (q.machine, q.phase_b, q.engine,
            _leaf_tuple(q.cost, "CostConfig"),
            _leaf_tuple(q.policy, "PolicyConfig"),
            ("spec", q.trace.digest(q.machine), pad_floor))


class SimFuture:
    """Handle to a pending (or cached) query result.

    ``result()`` drives the broker until this query's bucket has flushed
    (the broker is synchronous and in-process; a future is "pending"
    exactly while its query waits in an admission bucket for a microbatch
    to fill or come due).  ``result(timeout=...)`` bounds that drive on
    the broker's scheduling clock and raises ``BrokerTimeoutError`` when
    the budget runs out; the future stays pending and can be re-forced.
    A failed query re-raises its typed ``ServiceError`` (poisoned, shed,
    rejected) on every ``result()`` call.
    """

    __slots__ = ("query", "from_cache", "_broker", "_result", "_error")

    def __init__(self, query: SimQuery, broker):
        self.query = query
        self.from_cache = False
        self._broker = broker
        self._result: Optional[RunResult] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._result is not None or self._error is not None

    def result(self, timeout: Optional[float] = None) -> RunResult:
        if not self.done():
            self._broker._force(self, timeout=timeout)
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result

    def _resolve(self, res: RunResult, from_cache: bool = False) -> None:
        self._result = res
        self.from_cache = from_cache

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
