"""Failure vocabulary and resilience primitives for the service layer
(twin of the JAX package's ``service/resilience.py``).

The broker's failure model (see ``service.broker``): a microbatch flush
can fail for three distinct reasons — a *poisoned lane* (one query
deterministically kills the program it rides in), a *transient device
error* (retry with backoff clears it), or *pressure* (deadlines already
blown, admission queue over capacity).  Each gets a typed error so
clients and the search drivers can tell "your query is bad" from "the
service is busy" from "you asked too late", and three small primitives
implement the policy:

  * :class:`Quarantine` — TTL'd deny-list of poisoned query digests, so
    resubmitting a known-bad query fails fast instead of re-poisoning a
    64-lane batch;
  * :class:`CircuitBreaker` — per-bucket consecutive-failure counter
    that trips the bucket into degraded (per-lane, isolating) execution
    and closes again after consecutive clean flushes;
  * :class:`ResilienceConfig` — the knobs, injectable into
    ``SimBroker`` and defaulted for production.

Everything is host-side and clock-injectable: chaos tests drive the TTL
and breaker transitions deterministically with a fake clock.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


class ServiceError(RuntimeError):
    """Base of every typed service-layer failure."""


class PoisonedQueryError(ServiceError):
    """This query (digest) deterministically fails the device program it
    is batched into.  Raised on the isolated lane after bisection, and
    fast on resubmits while the digest is quarantined."""

    def __init__(self, digest: str, cause: Optional[BaseException] = None,
                 quarantined: bool = False):
        self.digest = digest
        self.quarantined = quarantined
        how = "quarantined" if quarantined else "isolated by bisection"
        detail = f": {cause}" if cause is not None else ""
        super().__init__(f"poisoned query {digest} ({how}){detail}")
        if cause is not None:
            self.__cause__ = cause


class DeadlineExceededError(ServiceError):
    """The query's deadline passed before its bucket flushed; the broker
    sheds it instead of silently computing a result nobody wants."""

    def __init__(self, deadline: float, now: float):
        self.deadline = deadline
        self.now = now
        super().__init__(
            f"deadline {deadline:.3f} expired {now - deadline:.3f}s before "
            "flush")


class BrokerOverloadedError(ServiceError):
    """Admission control: the broker is at ``max_pending_lanes`` and this
    query lost the priority comparison."""

    def __init__(self, pending: int, cap: int):
        self.pending = pending
        self.cap = cap
        super().__init__(
            f"broker over admission cap ({pending}/{cap} pending lanes); "
            "lowest-priority work is rejected")


class BrokerTimeoutError(ServiceError):
    """``SimFuture.result(timeout=...)`` ran out of broker-clock budget
    before the future settled (the future stays pending)."""

    def __init__(self, timeout: float):
        self.timeout = timeout
        super().__init__(f"future not settled within {timeout:.3f}s")


@dataclasses.dataclass
class ResilienceConfig:
    """Knobs of the broker's failure policy.

    max_retries        transient whole-batch re-executions before the
                       failure is treated as persistent and bisected.
    backoff_base/cap   exponential backoff between retries:
                       ``min(base * 2**attempt, cap)`` seconds through
                       the broker's injectable ``sleep``.
    breaker_threshold  consecutive failed flushes (per bucket) that trip
                       the bucket into degraded per-lane execution.
    breaker_recovery   consecutive clean degraded flushes that close the
                       breaker again.
    quarantine_ttl     seconds a poisoned digest stays on the deny-list
                       (broker scheduling clock).
    max_pending_lanes  admission cap over all buckets; ``None`` = no cap.
    deadline_grace     slack added to deadlines before flush-time
                       shedding (0 = shed anything strictly past due).
    """

    max_retries: int = 2
    backoff_base: float = 0.01
    backoff_cap: float = 1.0
    breaker_threshold: int = 3
    breaker_recovery: int = 2
    quarantine_ttl: float = 300.0
    max_pending_lanes: Optional[int] = None
    deadline_grace: float = 0.0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1")
        if self.breaker_recovery < 1:
            raise ValueError("breaker_recovery must be >= 1")

    def backoff(self, attempt: int) -> float:
        """Seconds to back off before retry ``attempt`` (0-based)."""
        return min(self.backoff_base * (2 ** attempt), self.backoff_cap)


class Quarantine:
    """TTL'd deny-list of poisoned query digests."""

    def __init__(self, ttl: float):
        self.ttl = ttl
        self._expiry: Dict[str, float] = {}

    def add(self, digest: str, now: float) -> None:
        self._expiry[digest] = now + self.ttl

    def check(self, digest: str, now: float) -> bool:
        """True while ``digest`` is quarantined; expired entries are
        purged on the way through."""
        exp = self._expiry.get(digest)
        if exp is None:
            return False
        if now >= exp:
            del self._expiry[digest]
            return False
        return True

    def purge(self, now: float) -> None:
        for d in [d for d, e in self._expiry.items() if now >= e]:
            del self._expiry[d]

    def __len__(self) -> int:
        return len(self._expiry)

    def digests(self) -> List[str]:
        return sorted(self._expiry)


class CircuitBreaker:
    """Per-key (bucket) consecutive-failure breaker.

    closed --[threshold consecutive failures]--> open (degraded)
    open   --[recovery consecutive clean flushes]--> closed
    """

    def __init__(self, threshold: int, recovery: int):
        self.threshold = threshold
        self.recovery = recovery
        self._failures: Dict[Tuple, int] = {}
        self._successes: Dict[Tuple, int] = {}
        self._open: Dict[Tuple, bool] = {}

    def is_open(self, key: Tuple) -> bool:
        return self._open.get(key, False)

    def record_failure(self, key: Tuple) -> bool:
        """Count one failed flush; returns True when this failure trips
        (or keeps) the breaker open."""
        self._successes[key] = 0
        n = self._failures.get(key, 0) + 1
        self._failures[key] = n
        if n >= self.threshold:
            self._open[key] = True
        return self._open.get(key, False)

    def record_success(self, key: Tuple) -> bool:
        """Count one clean flush; returns True when this success closes
        an open breaker."""
        self._failures[key] = 0
        if not self._open.get(key, False):
            return False
        n = self._successes.get(key, 0) + 1
        self._successes[key] = n
        if n >= self.recovery:
            self._open[key] = False
            self._successes[key] = 0
            return True
        return False

    def open_keys(self) -> List[Tuple]:
        return [k for k, v in self._open.items() if v]
