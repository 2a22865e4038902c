"""The shape-bucketed simulation-query broker (twin of the JAX package's
``service/broker.py``, on the port's lane-batched ``sweep_lanes``).

Turns independent :class:`~repro.service.query.SimQuery` requests into a
small number of batched ``sweep_lanes`` device programs:

  admission   ``submit()`` canonicalizes the query's trace (specs build
              once and idle-pad to a power-of-two step count), computes
              its content-addressed cache key, answers repeats from the
              result cache (zero compiles, zero device work), fails
              quarantined (known-poisoned) digests fast, joins
              duplicates already in flight onto one lane, enforces the
              ``max_pending_lanes`` admission cap (lowest-priority work
              is rejected with ``BrokerOverloadedError``), and otherwise
              enqueues the query in its *bucket*.
  bucketing   a bucket is everything the reference can run as one
              compiled executable: (machine, fault engine, trace step
              count, AutoNUMA scan period).  The AutoNUMA-budget bound
              is computed per flush as the batch maximum rounded up to a
              power of two — per-lane budgets gate through masks, so the
              round-up never changes results, it only keeps the compile
              key stable across bursts with different policy mixes.
  microbatch  a bucket flushes when it holds ``max_lanes`` lanes, when
              its oldest query has waited ``max_wait`` broker-clock
              seconds, when a member's deadline arrives (``pump``), or
              when a caller forces a future (``result()``).  Lanes are
              ordered by (priority, deadline, arrival) and the lane
              count is padded to a power of two so recurring burst sizes
              keep one compile key; pad lanes replicate lane 0 and are
              discarded.
  execution   one ``sweep_lanes`` call per flush — one lane per distinct
              query, every lane on the broker's one ``device`` — then
              every future resolves and every result enters the cache.

The port compiles nothing per key (its engine runs eager ops and the
``alloc_scan`` / ``fast_window`` kernels, built once), so
``stats.compiles`` counts what the reference would have compiled for the
same flushes (``core.sweep.compile_count``): "one compile per shape
bucket" keeps its meaning.

Failure model (see :mod:`repro.service.resilience` for the taxonomy and
:mod:`repro.obs.inject` for the chaos harness that drives it):

  shedding    queries whose deadline already expired at flush time fail
              with ``DeadlineExceededError`` instead of being silently
              computed; fully-shed lanes never reach the device.
  retry       a failed batch execution is retried up to
              ``resilience.max_retries`` times with exponential backoff
              while the error looks transient (injected faults carry an
              explicit flag; real device errors are treated as
              retryable).
  bisection   a persistent batch failure is isolated by bisection: each
              half re-runs as a normal ``sweep_lanes`` call (pow2 lane
              padding keeps compile-key quantization intact), recursing
              into failing halves until the poisoned lane(s) stand
              alone.  Innocent lanes resolve normally; the guilty fail
              with ``PoisonedQueryError`` and their digest enters a
              TTL'd quarantine so resubmits fail fast.
  breaker     ``resilience.breaker_threshold`` consecutive failed
              flushes trip the bucket into *degraded mode* — per-lane
              ``debug=True`` execution, slow but isolating — flipping
              the ``broker.degraded`` gauge; ``breaker_recovery``
              consecutive clean degraded flushes close the breaker.
  liveness    ``pump()``/``drain()`` never propagate a flush failure:
              exceptions route to the affected futures and telemetry,
              other buckets keep flushing, and per-bucket attempt bounds
              guarantee termination even if ``_flush`` itself misbehaves
              (stranded futures are failed, never leaked).

The broker is synchronous and in-process: nothing runs until a bucket
fills, comes due inside ``pump()``/``drain()``, or a future is forced.
That keeps it deterministic (the test suite pins per-query results
bit-identical to direct sequential ``TieredMemSimulator`` runs) while
preserving the surface of an async service.  No path drops to the CPU:
the broker resolves its device once, at construction, and a kernel's
failure fails the futures of its flush like any other error.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.sweep import compile_count as sweep_compile_count
from ..core.sweep import check_lane_sharding, sweep_lanes
from ..core.config import MIG_POLICY_NAMES, MachineConfig
from ..core.sim import RunResult, Trace, pow2ceil as _pow2ceil
from ..core.workloads import TraceSpec
from ..device import resolve_device
from ..obs import or_null
from ..obs.inject import or_null_injector
from .cache import ResultCache
from .query import (SimFuture, SimQuery, lane_digest, query_cache_key,
                    spec_cache_key)
from .resilience import (BrokerOverloadedError, CircuitBreaker,
                         DeadlineExceededError, PoisonedQueryError,
                         Quarantine, ResilienceConfig)


@dataclasses.dataclass
class BrokerStats:
    queries: int = 0
    cache_hits: int = 0
    inflight_joins: int = 0    # duplicate queries merged onto one lane
    flushes: int = 0
    lanes_run: int = 0         # distinct query lanes executed
    pad_lanes: int = 0         # power-of-two padding lanes (discarded)
    compiles: int = 0          # reference compiles across flushes
    retries: int = 0           # transient-failure batch re-executions
    shed: int = 0              # futures failed with DeadlineExceededError
    quarantined: int = 0       # lanes poisoned and deny-listed
    rejected: int = 0          # futures failed by the admission cap

    @property
    def pad_ratio(self) -> float:
        """Discarded padding lanes as a fraction of all executed lanes —
        the padding overhead of pow2 lane quantization."""
        run = self.lanes_run + self.pad_lanes
        return self.pad_lanes / run if run else 0.0

    def as_dict(self) -> Dict[str, float]:
        out = dataclasses.asdict(self)
        out["pad_ratio"] = self.pad_ratio
        return out

    def reset(self) -> None:
        """Zero every counter (measurement-window bookends in benchmarks
        and long-lived services)."""
        for f in dataclasses.fields(self):
            setattr(self, f.name, f.default)


def _bucket_label(bkey: Tuple) -> str:
    """Compact, label-safe bucket identity for metrics/spans (the full
    bucket key embeds a MachineConfig repr)."""
    mc, phase_b, engine, n_steps, period = bkey
    return f"{engine}/{phase_b}/t{mc.n_threads}/s{n_steps}/p{period}"


class _Pending:
    """One future lane: a distinct (machine, engine, cost, policy, trace)
    simulation plus every future waiting on it."""

    __slots__ = ("key", "trace", "query", "futures", "enqueue_t", "admit_t")

    def __init__(self, key, trace: Trace, query: SimQuery,
                 enqueue_t: float, admit_t: Optional[float] = None):
        self.key = key
        self.trace = trace
        self.query = query          # representative (first) query
        self.futures: List[SimFuture] = []
        self.enqueue_t = enqueue_t
        self.admit_t = admit_t      # tracer clock (None unless tracing)

    @property
    def priority(self) -> int:
        return max(f.query.priority for f in self.futures)

    @property
    def deadline(self) -> float:
        ds = [f.query.deadline for f in self.futures
              if f.query.deadline is not None]
        return min(ds) if ds else float("inf")


class SimBroker:
    """See module docstring.  Parameters:

    max_lanes      microbatch capacity per bucket (flush-when-full).
    max_wait       seconds a query may age in an open bucket before
                   ``pump()`` flushes it (the max-wait microbatch flush).
    lane_sharding  passed through to ``sweep_lanes`` — ``None``,
                   ``"auto"`` (shard the lane axis over the visible CUDA
                   devices, or the broker's one device when that is not
                   CUDA), or an explicit ``core.sweep.LaneMesh``.
    pad_steps_floor  smallest power-of-two step count specs are padded
                   to (raw ``Trace`` queries are never reshaped — the
                   caller owns their shape and bucket).
    cache / clock  injectable for sizing and for deterministic tests.
    telemetry      optional :class:`repro.obs.Telemetry`: per-query
                   lifecycle spans (admit → queue → flush → sweep →
                   resolve), queue-wait and flush-latency histograms,
                   per-bucket compile counters, cache and per-policy-
                   family migration counters.  Defaults to the no-op
                   sink; every hook is host-side, so the device work and
                   the results are identical either way.  Note spans use
                   the telemetry clock, while queue-wait *metrics* use
                   the broker's injectable scheduling ``clock``.
    resilience     :class:`~repro.service.resilience.ResilienceConfig`
                   (retry/backoff, breaker, quarantine TTL, admission
                   cap, deadline grace).  Defaults are production-sane.
    injector       optional :class:`~repro.obs.inject.FaultInjector`;
                   armed over the ``broker.flush`` / ``sweep.device``
                   sites here and propagated to the cache's disk sites.
                   Defaults to the no-op injector.
    flight         optional :class:`~repro.obs.FlightRecorder`: every
                   *persistent* failure — poison confirmed, breaker
                   trip, livelock abandon — dumps a postmortem artifact
                   (recent spans, metrics delta, broker state) before
                   the futures settle.  Dumps are best-effort: a
                   recorder error increments ``broker.flight_errors``
                   and never disturbs settlement.
    sleep          injectable backoff sleep (tests pass a recorder).
    device         where every flush runs (``None``: the CUDA device;
                   without CUDA the broker raises, and ``device="cpu"``
                   runs the port's plain versions).
    """

    def __init__(self, max_lanes: int = 64, max_wait: float = 0.25,
                 lane_sharding=None, pad_steps_floor: int = 64,
                 cache: Optional[ResultCache] = None, clock=time.monotonic,
                 telemetry=None, resilience: Optional[ResilienceConfig] = None,
                 injector=None, flight=None, sleep=time.sleep, device=None):
        if max_lanes < 1:
            raise ValueError("max_lanes must be >= 1")
        check_lane_sharding(lane_sharding)
        self.device = resolve_device(device)
        self.max_lanes = max_lanes
        self.max_wait = max_wait
        self.lane_sharding = lane_sharding
        self.pad_steps_floor = pad_steps_floor
        self.cache = cache if cache is not None else ResultCache()
        self.clock = clock
        self.sleep = sleep
        self.telemetry = or_null(telemetry)
        self.injector = or_null_injector(injector)
        if telemetry is not None and hasattr(self.cache, "attach_telemetry"):
            self.cache.attach_telemetry(self.telemetry)
        if injector is not None and hasattr(self.cache, "attach_injector"):
            self.cache.attach_injector(self.injector)
        self.resilience = resilience if resilience is not None \
            else ResilienceConfig()
        self.quarantine = Quarantine(self.resilience.quarantine_ttl)
        self.breaker = CircuitBreaker(self.resilience.breaker_threshold,
                                      self.resilience.breaker_recovery)
        self.flight = flight
        self.stats = BrokerStats()
        # bucket key -> (cache key -> pending lane), insertion-ordered
        self._buckets: Dict[Tuple, Dict[Tuple, _Pending]] = {}
        self._fut_index: Dict[int, Tuple[Tuple, Tuple]] = {}
        # bucket key -> stable trace tid for its queue-wait spans (tid 0
        # is the broker's own track, tid 1 the engine's window track;
        # per-bucket tracks keep concurrent buckets' queue spans from
        # partially overlapping on one line)
        self._bucket_tids: Dict[Tuple, int] = {}

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def canonical_trace(self, q: SimQuery) -> Trace:
        """The exact trace a query simulates (what cache keys hash and
        what a differential test must run sequentially)."""
        if isinstance(q.trace, Trace):
            if q.trace.va.shape[1] != q.machine.n_threads:
                raise ValueError(
                    f"query trace has {q.trace.va.shape[1]} threads, "
                    f"machine has {q.machine.n_threads}")
            return q.trace
        spec = q.trace
        if spec.pad_to == 0:
            natural = spec.build(q.machine)       # memoized in workloads
            spec = dataclasses.replace(
                spec, pad_to=_pow2ceil(natural.n_steps,
                                       self.pad_steps_floor))
        return spec.build(q.machine)

    def query_digest(self, q: SimQuery) -> str:
        """The stable digest quarantine deny-lists and
        ``PoisonedQueryError`` carry (and the ``sweep.device`` injection
        site matches ``fail_lane`` rules against)."""
        if isinstance(q.trace, TraceSpec):
            return lane_digest(spec_cache_key(q, self.pad_steps_floor))
        return lane_digest(query_cache_key(q, self.canonical_trace(q)))

    def _bucket_key(self, q: SimQuery, canonical: Trace) -> Tuple:
        mc: MachineConfig = q.machine
        period = int(q.policy.autonuma_period) if bool(q.policy.autonuma) \
            else 0
        return (mc, q.phase_b, q.engine, canonical.n_steps, period)

    def submit(self, q: SimQuery) -> SimFuture:
        tel = self.telemetry
        self.stats.queries += 1
        tel.counter("broker.queries").inc()
        admit_t0 = tel.now()
        fut = SimFuture(q, self)
        if isinstance(q.trace, TraceSpec):
            # recipe-addressed: a hit skips trace generation entirely
            key = spec_cache_key(q, self.pad_steps_floor)
            canonical = None
        else:
            canonical = self.canonical_trace(q)
            key = query_cache_key(q, canonical)
        hit = self.cache.get(key)
        if hit is not None:
            self.stats.cache_hits += 1
            tel.counter("broker.cache_hits").inc()
            fut._resolve(hit, from_cache=True)
            if admit_t0 is not None:
                tel.add_span("query.admit", admit_t0, tel.now(),
                             args={"cache_hit": True})
            return fut

        digest = lane_digest(key)
        if self.quarantine.check(digest, self.clock()):
            # known-poisoned: fail fast instead of re-poisoning a batch
            tel.counter("broker.quarantine_rejections").inc()
            fut._fail(PoisonedQueryError(digest, quarantined=True))
            return fut

        if canonical is None:
            canonical = self.canonical_trace(q)
        bkey = self._bucket_key(q, canonical)
        pend = self._buckets.get(bkey, {}).get(key)
        if pend is None:
            if not self._admit_lane(q, fut):
                return fut                # rejected: future already failed
            # (re-)resolve the bucket only after admission: eviction may
            # have emptied and dropped this very bucket's dict
            bucket = self._buckets.setdefault(bkey, {})
            pend = _Pending(key, canonical, q, self.clock(),
                            admit_t=tel.now())
            bucket[key] = pend
        else:
            bucket = self._buckets[bkey]
            self.stats.inflight_joins += 1
            tel.counter("broker.inflight_joins").inc()
        pend.futures.append(fut)
        self._fut_index[id(fut)] = (bkey, key)
        if admit_t0 is not None:
            tel.add_span("query.admit", admit_t0, tel.now(),
                         args={"cache_hit": False,
                               "bucket": _bucket_label(bkey)})

        if len(bucket) >= self.max_lanes:
            self._flush(bkey)
        else:
            self.pump()
        return fut

    def _admit_lane(self, q: SimQuery, fut: SimFuture) -> bool:
        """``max_pending_lanes`` admission control: when the broker is at
        capacity, the lowest-priority lane loses — either the newcomer is
        rejected outright, or (when the newcomer outranks it) the lowest
        pending lane is evicted to make room.  Returns False when ``fut``
        was failed with ``BrokerOverloadedError``."""
        cap = self.resilience.max_pending_lanes
        if cap is None or self.pending_lanes() < cap:
            return True
        tel = self.telemetry
        victim_loc = None
        for bk, bucket in self._buckets.items():
            for key, p in bucket.items():
                rank = (p.priority, -p.enqueue_t)   # lowest prio, youngest
                if victim_loc is None or rank < victim_loc[0]:
                    victim_loc = (rank, bk, key)
        if victim_loc is not None and q.priority > victim_loc[0][0]:
            _, bk, key = victim_loc
            victim = self._buckets[bk].pop(key)
            if not self._buckets[bk]:
                del self._buckets[bk]
            err = BrokerOverloadedError(self.pending_lanes() + 1, cap)
            self.stats.rejected += len(victim.futures)
            tel.counter("broker.overload_rejections").inc(
                len(victim.futures))
            self._settle_lane(victim, error=err)
            return True
        self.stats.rejected += 1
        tel.counter("broker.overload_rejections").inc()
        fut._fail(BrokerOverloadedError(self.pending_lanes(), cap))
        return False

    def submit_many(self, queries: Sequence[SimQuery]) -> List[SimFuture]:
        return [self.submit(q) for q in queries]

    def run(self, queries: Sequence[SimQuery]) -> List[RunResult]:
        """Submit a burst, drain every bucket, return aligned results.

        Raises the first failed future's typed error; callers that want
        per-query errors use ``submit_many`` + ``result()``."""
        futs = self.submit_many(queries)
        self.drain()
        return [f.result() for f in futs]

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------
    def _due(self, bucket: Dict[Tuple, _Pending], now: float) -> bool:
        if not bucket:
            return False
        oldest = min(p.enqueue_t for p in bucket.values())
        if now - oldest >= self.max_wait:
            return True
        return min(p.deadline for p in bucket.values()) <= now

    def pump(self, now: Optional[float] = None) -> int:
        """Flush every due bucket (max-wait age or deadline reached),
        highest-priority bucket first; equal priorities tie-break by
        oldest enqueue.  Flush failures route to the affected futures —
        ``pump`` itself never raises them — and per-bucket attempt bounds
        guarantee termination.  Returns the number of flushes."""
        now = self.clock() if now is None else now
        due = [bk for bk, b in self._buckets.items() if self._due(b, now)]
        due.sort(key=lambda bk: (
            -max(p.priority for p in self._buckets[bk].values()),
            min(p.enqueue_t for p in self._buckets[bk].values())))
        n = 0
        for bk in due:
            n += self._drain_bucket(bk)
        return n

    def drain(self) -> None:
        """Flush everything regardless of age/deadline.  Survives any
        flush failure (errors route to futures + telemetry) and always
        terminates: a bucket that will not empty within its bounded
        attempts is abandoned, failing its futures."""
        while any(self._buckets.values()):
            for bk in list(self._buckets):
                self._drain_bucket(bk)

    def _drain_bucket(self, bk: Tuple) -> int:
        """Flush ``bk`` until empty; never raises, never livelocks.
        Returns the number of completed ``_flush`` passes."""
        bucket = self._buckets.get(bk)
        if not bucket:
            return 0
        # each pass retires up to max_lanes lanes; 2x + slack tolerates
        # sheds/evictions racing the count without permitting a livelock
        limit = 2 * ((len(bucket) + self.max_lanes - 1)
                     // self.max_lanes) + 2
        flushes = 0
        last_exc: Optional[BaseException] = None
        for _ in range(limit):
            if not self._buckets.get(bk):
                return flushes
            try:
                self._flush(bk)
                flushes += 1
            except Exception as exc:  # noqa: BLE001 — route, don't raise
                last_exc = exc
                self.telemetry.counter("broker.flush_errors").inc()
        if self._buckets.get(bk):
            self._abandon_bucket(bk, last_exc)
        return flushes

    def _abandon_bucket(self, bk: Tuple, cause: Optional[BaseException]) \
            -> None:
        """Last-resort liveness: fail every future still in ``bk`` and
        drop the bucket, so ``drain``/``pump`` terminate even when
        ``_flush`` keeps raising without retiring lanes."""
        bucket = self._buckets.pop(bk, None)
        if not bucket:
            return
        err = RuntimeError(
            f"bucket {_bucket_label(bk)} failed to flush within bounded "
            "attempts; abandoning its lanes")
        if cause is not None:
            err.__cause__ = cause
        n = 0
        for p in bucket.values():
            n += len(p.futures)
            self._settle_lane(p, error=err)
        self.telemetry.counter("broker.abandoned_futures").inc(n)
        self._flight_dump("broker.abandon", err, bucket=_bucket_label(bk))

    def pending_lanes(self) -> int:
        return sum(len(b) for b in self._buckets.values())

    def degraded_buckets(self) -> List[str]:
        """Labels of buckets currently in degraded (per-lane) mode."""
        return sorted(_bucket_label(bk) for bk in self.breaker.open_keys())

    def _force(self, fut: SimFuture, timeout: Optional[float] = None) \
            -> None:
        loc = self._fut_index.get(id(fut))
        if loc is None:                      # already resolved
            return
        bkey, _ = loc
        t0 = self.clock() if timeout is not None else None
        while not fut.done():
            if timeout is not None and self.clock() - t0 >= timeout:
                from .resilience import BrokerTimeoutError
                raise BrokerTimeoutError(timeout)
            if not self._buckets.get(bkey):
                raise RuntimeError(
                    "future's bucket vanished without resolving it")
            self._flush(bkey)

    # ------------------------------------------------------------------
    # settlement (every path that retires a future goes through here, so
    # _fut_index can never leak a stale id() key)
    # ------------------------------------------------------------------
    def _settle_future(self, fut: SimFuture, result=None, error=None) \
            -> None:
        self._fut_index.pop(id(fut), None)
        if error is not None:
            fut._fail(error)
        else:
            fut._resolve(result)

    def _settle_lane(self, pend: _Pending, result=None, error=None) -> None:
        for f in pend.futures:
            self._settle_future(f, result=result, error=error)

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def _flush(self, bkey: Tuple) -> None:
        bucket = self._buckets.get(bkey)
        if not bucket:
            self._buckets.pop(bkey, None)
            return
        tel = self.telemetry
        blabel = _bucket_label(bkey) if tel.enabled else ""
        flush_t0 = tel.now()
        wall_t0 = time.perf_counter()
        now = self.clock()
        pendings = sorted(
            bucket.values(),
            key=lambda p: (-p.priority, p.deadline, p.enqueue_t))
        batch = pendings[:self.max_lanes]
        for p in batch:
            del bucket[p.key]
        if not bucket:
            del self._buckets[bkey]
        if tel.enabled:
            qwait = tel.histogram("broker.queue_wait_seconds")
            for p in batch:
                # broker scheduling clock, matching max_wait semantics
                qwait.observe(max(now - p.enqueue_t, 0.0))
                if p.admit_t is not None and flush_t0 is not None:
                    tel.add_span("query.queue", p.admit_t, flush_t0,
                                 tid=self._bucket_tid(bkey),
                                 args={"bucket": blabel,
                                       "waiters": len(p.futures)})

        live = self._shed_expired(batch, now)
        if not live:
            return                      # everything shed; nothing to run
        self.stats.flushes += 1
        if tel.enabled:
            tel.counter("broker.flushes", bucket=blabel).inc()

        if self.breaker.is_open(bkey):
            self._flush_degraded(bkey, live, blabel)
        else:
            self._flush_batched(bkey, live, blabel)

        if tel.enabled:
            tel.histogram("broker.flush_seconds").observe(
                time.perf_counter() - wall_t0)
            tel.gauge("broker.pending_lanes").set(self.pending_lanes())
            if flush_t0 is not None:
                tel.add_span("bucket.flush", flush_t0, tel.now(),
                             args={"bucket": blabel, "lanes": len(live)})

    def _shed_expired(self, batch: Sequence[_Pending], now: float) \
            -> List[_Pending]:
        """Deadline enforcement: futures strictly past due fail with
        ``DeadlineExceededError``; lanes with no live waiter left are
        dropped before any device work."""
        grace = self.resilience.deadline_grace
        tel = self.telemetry
        live: List[_Pending] = []
        for p in batch:
            keep: List[SimFuture] = []
            for f in p.futures:
                dl = f.query.deadline
                if dl is not None and dl + grace < now:
                    self.stats.shed += 1
                    tel.counter("broker.deadline_shed").inc()
                    self._settle_future(
                        f, error=DeadlineExceededError(dl, now))
                else:
                    keep.append(f)
            p.futures = keep
            if keep:
                live.append(p)
        return live

    def _flush_batched(self, bkey: Tuple, live: List[_Pending],
                       blabel: str) -> None:
        """The normal path: one batched execution with bounded transient
        retries; a persistent failure trips the breaker and bisects."""
        try:
            results = self._run_with_retries(bkey, live, blabel)
        except Exception as exc:  # noqa: BLE001 — typed handling below
            was_open = self.breaker.is_open(bkey)
            self.breaker.record_failure(bkey)
            self._update_degraded_gauge()
            if not was_open and self.breaker.is_open(bkey):
                self._flight_dump("broker.breaker", exc, bucket=blabel)
            if len(live) == 1:
                self._poison(live[0], exc)
            else:
                mid = (len(live) + 1) // 2
                self._bisect(bkey, live[:mid], blabel)
                self._bisect(bkey, live[mid:], blabel)
            return
        self.breaker.record_success(bkey)
        self._resolve_batch(live, results, blabel)

    def _flush_degraded(self, bkey: Tuple, live: List[_Pending],
                        blabel: str) -> None:
        """Degraded (breaker-open) mode: every lane runs solo with
        ``debug=True`` — slow, but a failure can only take down its own
        lane.  A fully clean pass counts toward breaker recovery."""
        tel = self.telemetry
        tel.counter("broker.degraded_flushes", bucket=blabel).inc()
        clean = True
        for p in live:
            try:
                res = self._run_with_retries(bkey, [p], blabel,
                                             degraded=True)[0]
            except Exception as exc:  # noqa: BLE001
                clean = False
                self._poison(p, exc)
                continue
            self._resolve_batch([p], [res], blabel)
        if clean:
            self.breaker.record_success(bkey)
        else:
            self.breaker.record_failure(bkey)
        self._update_degraded_gauge()

    def _run_with_retries(self, bkey: Tuple, pendings: List[_Pending],
                          blabel: str, degraded: bool = False) \
            -> List[RunResult]:
        """Execute one lane group, retrying transient failures with
        exponential backoff.  Raises the final error when the failure is
        persistent or the retry budget is exhausted."""
        rs = self.resilience
        tel = self.telemetry
        attempt = 0
        while True:
            try:
                self.injector.fire("broker.flush", bucket=blabel)
                return self._run_lanes(bkey, pendings, blabel,
                                       degraded=degraded)
            except Exception as exc:  # noqa: BLE001 — classified below
                tel.counter("broker.flush_failures").inc()
                # injected faults carry an explicit transience flag; real
                # device errors default to retryable
                transient = getattr(exc, "transient", True)
                if not transient or attempt >= rs.max_retries:
                    raise
                delay = rs.backoff(attempt)
                tel.histogram("broker.backoff_seconds").observe(delay)
                self.sleep(delay)
                attempt += 1
                self.stats.retries += 1
                tel.counter("broker.retries").inc()

    def _bisect(self, bkey: Tuple, pendings: List[_Pending],
                blabel: str) -> None:
        """Poison-lane isolation: run the group once as a normal
        ``sweep_lanes`` call; on failure split it, recursing log2-deep
        until single lanes fail alone and are quarantined.  Innocent
        lanes resolve with results bit-identical to a fault-free run."""
        self.telemetry.counter("broker.bisect_runs").inc()
        try:
            results = self._run_lanes(bkey, pendings, blabel)
        except Exception as exc:  # noqa: BLE001
            self.telemetry.counter("broker.flush_failures").inc()
            if len(pendings) == 1:
                self._poison(pendings[0], exc)
                return
            mid = (len(pendings) + 1) // 2
            self._bisect(bkey, pendings[:mid], blabel)
            self._bisect(bkey, pendings[mid:], blabel)
            return
        self._resolve_batch(pendings, results, blabel)

    def _poison(self, pend: _Pending, cause: BaseException) -> None:
        digest = lane_digest(pend.key)
        self.quarantine.add(digest, self.clock())
        self.stats.quarantined += 1
        self.telemetry.counter("broker.quarantined").inc()
        err = PoisonedQueryError(digest, cause=cause)
        self._settle_lane(pend, error=err)
        self._flight_dump("broker.poison", err)

    def _bucket_tid(self, bkey: Tuple) -> int:
        tid = self._bucket_tids.get(bkey)
        if tid is None:
            tid = self._bucket_tids[bkey] = 2 + len(self._bucket_tids)
        return tid

    def _flight_dump(self, site: str, error: BaseException, **extra) -> None:
        """Best-effort postmortem on a persistent failure.  Never raises:
        the black box must not be able to crash the plane."""
        if self.flight is None:
            return
        try:
            state: Dict[str, object] = {
                "stats": self.stats.as_dict(),
                "pending_lanes": self.pending_lanes(),
                "quarantine": self.quarantine.digests(),
                "degraded_buckets": self.degraded_buckets()}
            if self.injector.rules:
                state["faults"] = self.injector.stats()
            state.update(extra)
            self.flight.dump(site, error=error, state=state)
        except Exception:  # noqa: BLE001 — observability stays best-effort
            self.telemetry.counter("broker.flight_errors").inc()

    def _update_degraded_gauge(self) -> None:
        self.telemetry.gauge("broker.degraded").set(
            1 if self.breaker.open_keys() else 0)

    def _run_lanes(self, bkey: Tuple, pendings: List[_Pending],
                   blabel: str, degraded: bool = False) -> List[RunResult]:
        """One ``sweep_lanes`` execution over ``pendings`` on the broker's
        device (pow2 lane padding as always, so compile-key quantization
        holds for full batches and bisection halves alike).  Fires the
        ``sweep.device`` injection site with the group's lane digests."""
        tel = self.telemetry
        mc, phase_b, engine, _, _ = bkey
        qbudget = _pow2ceil(min(
            max(int(p.query.policy.autonuma_budget) for p in pendings),
            mc.n_map))
        # The allocator conflict-group bound is trace-content-derived, so
        # letting sweep_lanes compute it per batch would mint up to
        # log2(T)+1 reference executables per bucket as fault profiles
        # vary across bursts.  Like the budget bound above, brokers trade the scan-
        # depth cut for compile-key stability: pin the bound at its
        # maximum (full thread depth — the pre-blocked-engine status quo
        # for fault steps; per-lane results are unaffected).
        qgroup = mc.n_threads if phase_b == "batched" else None
        ccs = [p.query.cost for p in pendings]
        pcs = [p.query.policy for p in pendings]
        trs = [p.trace for p in pendings]
        # Lane padding replicates lane 0, which is also block-aware: a pad
        # lane adds no new trace, so the union event mask — and with it
        # the windowed shapes the blocked engine compiles for — stays
        # exactly the batch's own, and pow2 lane counts keep quantizing.
        n_pad = _pow2ceil(len(pendings)) - len(pendings)
        for _ in range(n_pad):
            ccs.append(pendings[0].query.cost)
            pcs.append(pendings[0].query.policy)
            trs.append(pendings[0].trace)

        self.injector.fire("sweep.device", bucket=blabel,
                           lanes=[lane_digest(p.key) for p in pendings])
        before = sweep_compile_count()
        results = sweep_lanes(
            mc, ccs, pcs, trs, phase_b=phase_b, budget=qbudget,
            lane_sharding=self.lane_sharding, engine=engine,
            group=qgroup,
            # queries on a reference path already carried debug=True
            # (SimQuery validates); degraded mode always isolates with it
            debug=(degraded or engine != "blocked" or phase_b != "batched"),
            telemetry=tel, device=self.device)
        compiles = sweep_compile_count() - before
        self.stats.compiles += compiles
        self.stats.lanes_run += len(pendings)
        self.stats.pad_lanes += n_pad
        if tel.enabled:
            tel.counter("broker.compiles", bucket=blabel).inc(compiles)
            tel.counter("broker.lanes_run", bucket=blabel).inc(len(pendings))
            tel.counter("broker.pad_lanes", bucket=blabel).inc(n_pad)
        return results[:len(pendings)]

    def _resolve_batch(self, pendings: Sequence[_Pending],
                       results: Sequence[RunResult], blabel: str) -> None:
        tel = self.telemetry
        resolve_t0 = tel.now()
        for p, res in zip(pendings, results):
            self.cache.put(p.key, res)
            self._settle_lane(p, result=res)
        if tel.enabled:
            self._record_summaries(pendings, results)
            if resolve_t0 is not None:
                tel.add_span("query.resolve", resolve_t0, tel.now(),
                             args={"bucket": blabel,
                                   "lanes": len(pendings)})

    def _record_summaries(self, batch: Sequence[_Pending],
                          results: Sequence[RunResult]) -> None:
        """Lift per-policy-family migration totals and per-tier page
        placement out of each lane's ``RunResult.summary()`` into the
        metrics registry (telemetry-on only: summary() walks host state)."""
        tel = self.telemetry
        for p, res in zip(batch, results):
            s = res.summary()
            fam = MIG_POLICY_NAMES.get(int(p.query.policy.mig_policy),
                                       "unknown")
            tel.counter("sim.promotions", family=fam).inc(
                int(s["data_migrations"]))
            tel.counter("sim.demotions", family=fam).inc(
                int(s["demotions"]))
            tel.counter("sim.nomad_aborts", family=fam).inc(
                int(s["nomad_retries"]) + int(s["nomad_shadow_drops"]))
            for t, n in enumerate(s["data_pages_per_tier"]):
                tel.counter("sim.data_pages", tier=t).inc(int(n))
            for t, n in enumerate(s["leaf_pages_per_tier"]):
                tel.counter("sim.leaf_pages", tier=t).inc(int(n))

    def snapshot(self) -> Dict[str, object]:
        """One JSON-friendly dict of everything observable: broker stats,
        cache stats (both tiers), resilience state (quarantine size,
        degraded buckets) and the telemetry snapshot.  The blessed
        artifact payload — replaces ad-hoc ``stats.as_dict()`` readouts."""
        out = {"broker": self.stats.as_dict(),
               "pending_lanes": self.pending_lanes(),
               "quarantine": {"size": len(self.quarantine),
                              "digests": self.quarantine.digests()},
               "degraded_buckets": self.degraded_buckets()}
        if hasattr(self.cache, "stats"):
            out["cache"] = self.cache.stats()
        if self.injector.rules:
            out["faults"] = self.injector.stats()
        out["telemetry"] = self.telemetry.snapshot()
        return out
