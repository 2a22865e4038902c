"""Deterministic fault injection for the service stack (twin of the JAX
package's ``obs/inject.py``: the same sites, rules and ``random.Random``
draw order, so one seed gives one schedule in both packages).

Chaos testing a deterministic simulator demands deterministic chaos:
every failure the resilience layer must survive — a device error mid
``sweep_lanes``, a torn disk-cache write, a whole flush falling over —
is representable here as a *named injection site* plus a seeded,
schedule-reproducible :class:`FaultRule`.  Re-running the same plan
against the same submission order reproduces the same failures, so the
chaos suite can pin exact retry/shed/quarantine counter values instead
of asserting "something probably failed".

Sites instrumented in the stack (context keys each site provides):

  ====================  =====================================================
  ``broker.flush``      once per microbatch flush attempt (``bucket=`` label)
  ``sweep.device``      once per ``sweep_lanes`` device execution, including
                        bisection sub-batches (``lanes=`` list of query
                        digests, ``bucket=``)
  ``cache.disk.read``   once per disk-tier lookup (``key=`` digest string)
  ``cache.disk.write``  once per disk-tier spill (``key=`` digest string)
  ====================  =====================================================

Rule modes:

  * ``fail_once(site)`` / ``fail_n(site, n)`` — the next 1/N firings of
    the site raise; transient by default (the broker's bounded retry
    clears them).
  * ``fail_lane(site, digest)`` — raise whenever the matched digest is
    present in the site context (``lanes`` list or ``key``); persistent
    by default — this is how a chaos plan poisons one lane so the
    broker's batch bisection must isolate it.
  * ``fail_rate(site, rate, seed)`` — seeded Bernoulli per firing; the
    draw sequence depends only on the rule's own counter, so identical
    call schedules reproduce identical failures.

``kind="corrupt"`` asks the *site* to corrupt data instead of raising
(the disk tier writes a truncated blob so the self-healing read path
must detect, quarantine and recompute); sites that cannot corrupt treat
it as ``raise``.

The no-op :data:`NULL_INJECTOR` keeps the production path at one
attribute load per site, mirroring ``obs.telemetry.NULL``.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Tuple


class InjectedFault(RuntimeError):
    """Raised by an injection site the active plan told to fail.

    ``transient`` distinguishes a retryable device hiccup from a
    persistent (poison-lane) failure; the broker's retry loop consults
    it before burning backoff budget.
    """

    def __init__(self, site: str, rule: "FaultRule",
                 matched: Optional[str] = None):
        self.site = site
        self.kind = rule.kind
        self.transient = rule.transient
        self.matched = matched
        detail = f" lane={matched}" if matched else ""
        super().__init__(
            f"injected {rule.kind} fault at {site}{detail} "
            f"({'transient' if rule.transient else 'persistent'})")


@dataclasses.dataclass
class FaultRule:
    """One failure clause of a plan.  ``mode``:

    ``once`` / ``times``  fail the next ``times`` firings of the site;
    ``match``             fail every firing whose context contains
                          ``match`` (in ``lanes`` or ``key``);
    ``rate``              seeded Bernoulli(``rate``) per firing.
    """

    site: str
    mode: str = "once"                 # once | times | match | rate
    times: int = 1
    match: Optional[str] = None
    rate: float = 0.0
    kind: str = "raise"                # raise | corrupt
    transient: bool = True
    seed: int = 0

    def __post_init__(self):
        if self.mode not in ("once", "times", "match", "rate"):
            raise ValueError(f"unknown fault mode {self.mode!r}")
        if self.mode == "match" and not self.match:
            raise ValueError("match mode needs a match target")
        if self.kind not in ("raise", "corrupt"):
            raise ValueError(f"unknown fault kind {self.kind!r}")


def fail_once(site: str, **kw) -> FaultRule:
    return FaultRule(site=site, mode="once", times=1, **kw)


def fail_n(site: str, n: int, **kw) -> FaultRule:
    return FaultRule(site=site, mode="times", times=n, **kw)


def fail_lane(site: str, digest: str, transient: bool = False,
              **kw) -> FaultRule:
    return FaultRule(site=site, mode="match", match=digest,
                     transient=transient, **kw)


def fail_rate(site: str, rate: float, seed: int = 0, **kw) -> FaultRule:
    return FaultRule(site=site, mode="rate", rate=rate, seed=seed, **kw)


class FaultInjector:
    """A fault plan armed over the named sites.

    ``fire(site, **context)`` walks the plan's rules for ``site`` in
    order and raises :class:`InjectedFault` on the first one that
    triggers.  Every firing — triggered or not — is counted, and every
    triggered fault is appended to ``log`` so tests can assert the exact
    schedule that was injected.
    """

    def __init__(self, rules: Sequence[FaultRule] = ()):
        self.rules: List[FaultRule] = list(rules)
        self._remaining: Dict[int, int] = {
            i: r.times for i, r in enumerate(self.rules)
            if r.mode in ("once", "times")}
        self._rngs: Dict[int, random.Random] = {
            i: random.Random(r.seed) for i, r in enumerate(self.rules)
            if r.mode == "rate"}
        self.fired: Dict[str, int] = {}      # site -> firings (all)
        self.injected: Dict[str, int] = {}   # site -> faults raised
        self.log: List[Tuple[str, str, Optional[str]]] = []

    def add(self, rule: FaultRule) -> None:
        i = len(self.rules)
        self.rules.append(rule)
        if rule.mode in ("once", "times"):
            self._remaining[i] = rule.times
        if rule.mode == "rate":
            self._rngs[i] = random.Random(rule.seed)

    @staticmethod
    def _matched(rule: FaultRule, context) -> Optional[str]:
        lanes = context.get("lanes") or ()
        for lane in lanes:
            if rule.match in str(lane):
                return str(lane)
        key = context.get("key")
        if key is not None and rule.match in str(key):
            return str(key)
        return None

    def fire(self, site: str, **context) -> None:
        self.fired[site] = self.fired.get(site, 0) + 1
        for i, rule in enumerate(self.rules):
            if rule.site != site:
                continue
            matched = None
            if rule.mode in ("once", "times"):
                if self._remaining.get(i, 0) <= 0:
                    continue
                self._remaining[i] -= 1
            elif rule.mode == "match":
                matched = self._matched(rule, context)
                if matched is None:
                    continue
            else:  # rate
                if self._rngs[i].random() >= rule.rate:
                    continue
            self.injected[site] = self.injected.get(site, 0) + 1
            self.log.append((site, rule.kind, matched))
            raise InjectedFault(site, rule, matched)

    def stats(self) -> Dict[str, object]:
        return {"fired": dict(self.fired), "injected": dict(self.injected),
                "total_injected": sum(self.injected.values())}


class NullInjector(FaultInjector):
    """The production default: every site is a no-op."""

    def __init__(self):
        super().__init__(())

    def add(self, rule: FaultRule) -> None:
        raise RuntimeError("NULL_INJECTOR is shared; build a FaultInjector")

    def fire(self, site: str, **context) -> None:
        pass


NULL_INJECTOR = NullInjector()


def or_null_injector(injector: Optional[FaultInjector]) -> FaultInjector:
    return injector if injector is not None else NULL_INJECTOR
