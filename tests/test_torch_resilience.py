"""Failure semantics of the port's service layer, chaos-tested: the twins
of tests/test_resilience.py, with the same ``chaos`` markers (and its one
``slow`` test kept ``slow``).

Layers under test, as in the reference:

  * :mod:`repro_torch.obs.inject` — the deterministic fault-injection
    harness (seeded, schedule-reproducible plans; the schedule a seed
    fires equals the reference's, see tests/test_torch_obs.py);
  * :mod:`repro_torch.service.resilience` — quarantine TTL,
    circuit-breaker transitions, retry/backoff policy;
  * the broker's failure paths, with ``broker.sweep_lanes`` stubbed
    (pure control flow): transient retry, poison-lane bisection and
    quarantine, the degraded-mode breaker, deadline shedding, admission
    control, drain liveness, future timeouts, the ``_fut_index`` leak fix;
  * the disk cache's self-healing read path (real files, torn writes);
  * seeded chaos properties against 64-query bursts, under hypothesis
    when it is installed and on fixed seeds always;
  * the end-to-end acceptance burst on the real engine (CPU), ``chaos`` +
    ``slow``.
"""
import dataclasses
import random

import pytest

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                      # property tests skip; the rest run
    HAVE_HYPOTHESIS = False

from repro_torch.obs.inject import (FaultInjector, FaultRule, InjectedFault,
                                    NULL_INJECTOR, fail_lane, fail_n,
                                    fail_once, fail_rate)
from repro_torch.service import SimQuery
from repro_torch.service import broker as broker_mod
from repro_torch.service.cache import DiskCacheTier, ResultCache
from repro_torch.service.resilience import (BrokerOverloadedError,
                                            BrokerTimeoutError,
                                            CircuitBreaker,
                                            DeadlineExceededError,
                                            PoisonedQueryError, Quarantine,
                                            ResilienceConfig, ServiceError)

from test_torch_blocked import assert_bitwise
from test_torch_service import (FakeClock, MIXED_POLICIES, port_history,
                                random_trace, tiny_machine)
from test_torch_service import broker as SimBroker

assert port_history                      # autouse: the port's history to tmp


# ---------------------------------------------------------------------------
# the fault-injection harness itself
# ---------------------------------------------------------------------------
def test_fault_rule_validation():
    with pytest.raises(ValueError, match="mode"):
        FaultRule(site="x", mode="sometimes")
    with pytest.raises(ValueError, match="match"):
        FaultRule(site="x", mode="match")
    with pytest.raises(ValueError, match="kind"):
        FaultRule(site="x", kind="explode")


def test_fail_n_schedule_and_accounting():
    inj = FaultInjector([fail_n("sweep.device", 2)])
    for _ in range(2):
        with pytest.raises(InjectedFault) as ei:
            inj.fire("sweep.device")
        assert ei.value.transient and ei.value.site == "sweep.device"
    inj.fire("sweep.device")             # exhausted: passes
    inj.fire("other.site")               # unrelated site never fails
    assert inj.fired == {"sweep.device": 3, "other.site": 1}
    assert inj.injected == {"sweep.device": 2}
    assert inj.stats()["total_injected"] == 2
    assert len(inj.log) == 2


def test_fail_lane_matches_context():
    inj = FaultInjector([fail_lane("sweep.device", "deadbeef")])
    inj.fire("sweep.device", lanes=["aaaa", "bbbb"])    # no match
    with pytest.raises(InjectedFault) as ei:
        inj.fire("sweep.device", lanes=["aaaa", "deadbeef01"])
    assert not ei.value.transient        # lane poison is persistent
    assert ei.value.matched == "deadbeef01"
    with pytest.raises(InjectedFault):
        inj.fire("sweep.device", key="xx-deadbeef-yy")


def test_fail_rate_is_seed_deterministic():
    def schedule(seed):
        inj = FaultInjector([fail_rate("s", 0.3, seed=seed)])
        out = []
        for _ in range(100):
            try:
                inj.fire("s")
                out.append(0)
            except InjectedFault:
                out.append(1)
        return out

    a, b = schedule(7), schedule(7)
    assert a == b and sum(a) > 0
    assert schedule(8) != a


def test_null_injector_is_inert():
    NULL_INJECTOR.fire("sweep.device", lanes=["x"])
    with pytest.raises(RuntimeError, match="shared"):
        NULL_INJECTOR.add(fail_once("sweep.device"))


# ---------------------------------------------------------------------------
# resilience primitives
# ---------------------------------------------------------------------------
def test_quarantine_ttl():
    q = Quarantine(ttl=10.0)
    q.add("aa", now=100.0)
    q.add("bb", now=105.0)
    assert q.check("aa", 109.0) and len(q) == 2
    assert not q.check("cc", 109.0)
    assert not q.check("aa", 110.0)      # expired exactly at TTL, purged
    assert q.digests() == ["bb"]
    q.purge(1000.0)
    assert len(q) == 0


def test_circuit_breaker_transitions():
    br = CircuitBreaker(threshold=3, recovery=2)
    k = ("bucket",)
    assert not br.record_failure(k) and not br.record_failure(k)
    br.record_success(k)                 # success resets the failure streak
    assert not br.record_failure(k) and not br.record_failure(k)
    assert br.record_failure(k)          # third consecutive: opens
    assert br.is_open(k) and br.open_keys() == [k]
    assert not br.record_success(k)      # 1 of 2 recoveries
    br.record_failure(k)                 # failure resets the success streak
    assert br.is_open(k)
    assert not br.record_success(k)
    assert br.record_success(k)          # 2 consecutive: closes
    assert not br.is_open(k)


def test_resilience_config_backoff_and_validation():
    rs = ResilienceConfig(backoff_base=0.1, backoff_cap=0.5)
    assert [rs.backoff(a) for a in range(4)] == [0.1, 0.2, 0.4, 0.5]
    with pytest.raises(ValueError):
        ResilienceConfig(max_retries=-1)
    with pytest.raises(ValueError):
        ResilienceConfig(breaker_threshold=0)


# ---------------------------------------------------------------------------
# broker failure paths (execution stubbed — pure control flow)
# ---------------------------------------------------------------------------
@pytest.fixture
def stub_exec(monkeypatch):
    """Stub sweep_lanes recording (n_lanes, kwargs) per call."""
    calls = []

    def fake_sweep_lanes(mc, ccs, pcs, trs, **kw):
        calls.append((len(pcs), kw))
        return [f"result-{len(calls)}-{i}" for i in range(len(pcs))]

    monkeypatch.setattr(broker_mod, "sweep_lanes", fake_sweep_lanes)
    return calls


def _broker(injector=None, resilience=None, **kw):
    sleeps = []
    kw.setdefault("max_wait", 1e9)
    b = SimBroker(injector=injector, resilience=resilience,
                  sleep=sleeps.append, **kw)
    b._test_sleeps = sleeps
    return b


@pytest.mark.chaos
def test_transient_fault_retried_with_backoff(stub_exec):
    mc = tiny_machine()
    inj = FaultInjector([fail_n("sweep.device", 2)])
    b = _broker(injector=inj, max_lanes=2,
                resilience=ResilienceConfig(max_retries=2, backoff_base=0.01))
    tr = random_trace(mc, seed=20)
    futs = [b.submit(SimQuery(trace=tr, policy=pc, machine=mc))
            for pc in MIXED_POLICIES[:2]]
    assert [f.result() for f in futs] == ["result-1-0", "result-1-1"]
    assert b.stats.retries == 2 and b.stats.quarantined == 0
    assert b._test_sleeps == [0.01, 0.02]
    assert not b.degraded_buckets()
    assert b._fut_index == {}


@pytest.mark.chaos
def test_persistent_lane_poisoned_by_bisection(stub_exec):
    mc = tiny_machine()
    traces = [random_trace(mc, seed=30 + i, name=f"p{i}") for i in range(4)]
    queries = [SimQuery(trace=tr, policy=MIXED_POLICIES[0], machine=mc)
               for tr in traces]
    probe = SimBroker()                  # digests are broker-independent
    bad_digest = probe.query_digest(queries[2])
    inj = FaultInjector([fail_lane("sweep.device", bad_digest)])
    b = _broker(injector=inj, max_lanes=4)
    futs = b.submit_many(queries)        # 4th submit flushes

    # innocent lanes resolved from the bisection halves, guilty poisoned
    assert futs[0].result() == "result-1-0"
    assert futs[1].result() == "result-1-1"
    assert futs[3].result() == "result-2-0"
    with pytest.raises(PoisonedQueryError) as ei:
        futs[2].result()
    assert ei.value.digest == bad_digest and not ei.value.quarantined
    assert isinstance(ei.value.__cause__, InjectedFault)
    assert [n for n, _ in stub_exec] == [2, 1]   # pairs run; device never
    assert b.stats.retries == 0                  # saw the poisoned lane
    assert b.stats.quarantined == 1

    # resubmit fails fast out of quarantine — no new execution
    with pytest.raises(PoisonedQueryError) as ei:
        b.submit(queries[2]).result()
    assert ei.value.quarantined and len(stub_exec) == 2
    assert b._fut_index == {}


@pytest.mark.chaos
def test_breaker_degrades_bucket_then_recovers(stub_exec):
    mc = tiny_machine()
    inj = FaultInjector([fail_n("broker.flush", 2)])
    b = _broker(injector=inj, max_lanes=1,
                resilience=ResilienceConfig(max_retries=0,
                                            breaker_threshold=2,
                                            breaker_recovery=1))
    qs = [SimQuery(trace=random_trace(mc, seed=40 + i, name=f"d{i}"),
                   policy=MIXED_POLICIES[0], machine=mc) for i in range(3)]
    fa, fb = b.submit(qs[0]), b.submit(qs[1])
    with pytest.raises(PoisonedQueryError):
        fa.result()
    with pytest.raises(PoisonedQueryError):
        fb.result()
    assert len(b.degraded_buckets()) == 1        # breaker tripped open

    # degraded flush: per-lane debug=True execution; clean pass closes it
    fc = b.submit(qs[2])
    assert fc.result() == "result-1-0"
    assert stub_exec[-1][0] == 1 and stub_exec[-1][1]["debug"] is True
    assert b.degraded_buckets() == []
    assert b._fut_index == {}


@pytest.mark.chaos
def test_deadline_shed_at_flush(stub_exec):
    mc = tiny_machine()
    clock = FakeClock()
    b = _broker(max_lanes=64, clock=clock)
    tr = random_trace(mc, seed=50)
    doomed = b.submit(SimQuery(trace=tr, policy=MIXED_POLICIES[0],
                               machine=mc, deadline=clock.now + 2.0))
    alive = b.submit(SimQuery(trace=tr, policy=MIXED_POLICIES[1],
                              machine=mc))
    clock.now += 5.0
    assert b.pump() == 1
    with pytest.raises(DeadlineExceededError) as ei:
        doomed.result()
    assert ei.value.deadline == 1002.0 and ei.value.now == 1005.0
    assert alive.result() == "result-1-0"
    assert b.stats.shed == 1 and b.stats.flushes == 1

    # a fully-shed flush never reaches the device (flush count frozen)
    dead = b.submit(SimQuery(trace=tr, policy=MIXED_POLICIES[2],
                             machine=mc, deadline=clock.now - 1.0))
    assert dead.done()                   # submit's pump sheds it
    with pytest.raises(DeadlineExceededError):
        dead.result()
    assert b.stats.shed == 2 and b.stats.flushes == 1 and len(stub_exec) == 1
    assert b._fut_index == {}


@pytest.mark.chaos
def test_admission_cap_rejects_lowest_priority(stub_exec):
    mc = tiny_machine()
    clock = FakeClock()
    b = _broker(max_lanes=64, clock=clock,
                resilience=ResilienceConfig(max_pending_lanes=2))
    mk = lambda i, prio: SimQuery(  # noqa: E731
        trace=random_trace(mc, seed=60 + i, name=f"a{i}"),
        policy=MIXED_POLICIES[0], machine=mc, priority=prio)
    fa = b.submit(mk(0, 0))
    clock.now += 1.0
    fb = b.submit(mk(1, 0))
    clock.now += 1.0

    # at cap, equal priority: the newcomer loses
    with pytest.raises(BrokerOverloadedError) as ei:
        b.submit(mk(2, 0)).result()
    assert ei.value.cap == 2
    # at cap, higher priority: the youngest lowest-priority lane loses
    fd = b.submit(mk(3, 5))
    with pytest.raises(BrokerOverloadedError):
        fb.result()
    assert b.stats.rejected == 2
    b.drain()
    assert fa.result() == "result-1-1" and fd.result() == "result-1-0"
    assert b.pending_lanes() == 0 and b._fut_index == {}


@pytest.mark.chaos
def test_drain_terminates_when_flush_keeps_raising(stub_exec, monkeypatch):
    """The livelock regression: _flush raising without retiring lanes
    must not loop drain() forever — bounded attempts, then the bucket is
    abandoned and its futures fail."""
    mc = tiny_machine()
    b = _broker(max_lanes=64)
    fut = b.submit(SimQuery(trace=random_trace(mc, seed=70),
                            policy=MIXED_POLICIES[0], machine=mc))

    def broken_flush(bkey):
        raise RuntimeError("flush wedged")

    monkeypatch.setattr(b, "_flush", broken_flush)
    b.drain()                            # must terminate
    assert fut.done()
    with pytest.raises(RuntimeError, match="abandoning") as ei:
        fut.result()
    assert "flush wedged" in str(ei.value.__cause__)
    assert b.pending_lanes() == 0 and b._fut_index == {}


def test_force_raises_when_bucket_vanishes(stub_exec):
    mc = tiny_machine()
    b = _broker(max_lanes=64)
    fut = b.submit(SimQuery(trace=random_trace(mc, seed=71),
                            policy=MIXED_POLICIES[0], machine=mc))
    b._buckets.clear()                   # simulate the broken invariant
    with pytest.raises(RuntimeError, match="vanished"):
        fut.result()


def test_pump_equal_priority_ties_break_oldest_first(stub_exec):
    mc = tiny_machine()
    clock = FakeClock()
    b = SimBroker(max_lanes=64, max_wait=1.0, clock=clock)
    older = b.submit(SimQuery(trace=random_trace(mc, seed=72, steps=48),
                              policy=MIXED_POLICIES[0], machine=mc))
    clock.now += 0.5
    newer = b.submit(SimQuery(trace=random_trace(mc, seed=73, steps=96),
                              policy=MIXED_POLICIES[0], machine=mc))
    clock.now += 1.0                     # both buckets past max_wait
    assert b.pump() == 2
    assert older.result() == "result-1-0"    # oldest enqueue flushed first
    assert newer.result() == "result-2-0"


def test_future_timeout_typed_and_retriable(stub_exec):
    mc = tiny_machine()
    b = _broker(max_lanes=64, clock=FakeClock())
    fut = b.submit(SimQuery(trace=random_trace(mc, seed=74),
                            policy=MIXED_POLICIES[0], machine=mc))
    with pytest.raises(BrokerTimeoutError) as ei:
        fut.result(timeout=0.0)
    assert ei.value.timeout == 0.0
    assert not fut.done()                # still pending, not failed
    assert fut.result(timeout=100.0) == "result-1-0"


def test_fut_index_empty_after_every_settlement_path(stub_exec):
    mc = tiny_machine()
    b = _broker(max_lanes=4)
    tr = random_trace(mc, seed=75)
    qs = [SimQuery(trace=tr, policy=pc, machine=mc) for pc in MIXED_POLICIES]
    futs = b.submit_many(qs)
    assert len(b._fut_index) == 3
    b.drain()
    assert b._fut_index == {}            # resolve path pops (the leak fix)
    again = b.submit_many(qs)            # cache hits never register
    assert all(f.from_cache for f in again) and b._fut_index == {}


# ---------------------------------------------------------------------------
# disk cache: self-healing reads
# ---------------------------------------------------------------------------
def test_disk_cache_quarantines_corrupt_entry_and_reheals(tmp_path):
    tier = DiskCacheTier(tmp_path)
    key = ("k", 1)
    tier.put(key, {"v": 42})
    assert tier.get(key) == {"v": 42}

    f = tier._file(key)
    blob = f.read_bytes()
    f.write_bytes(blob[:len(blob) // 2])         # torn write on disk
    assert tier.get(key) is None                 # detected, not served
    assert tier.corrupt == 1
    assert not f.exists()                        # quarantined to sidecar
    assert (tmp_path / "quarantine" / f.name).exists()
    assert tier.stats()["quarantined"] == 1

    tier.put(key, {"v": 42})                     # recompute-and-rewrite
    assert tier.get(key) == {"v": 42}
    assert tier.corrupt == 1                     # healed: no re-detection


def test_disk_cache_detects_garbage_and_injected_torn_write(tmp_path):
    inj = FaultInjector([fail_once("cache.disk.write", kind="corrupt")])
    tier = DiskCacheTier(tmp_path, injector=inj)
    key = ("k", 2)
    tier.put(key, [1, 2, 3])                     # injected torn write
    assert tier.get(key) is None and tier.corrupt == 1
    tier.put(key, [1, 2, 3])                     # rule exhausted: clean
    assert tier.get(key) == [1, 2, 3]

    # flipped payload byte: checksum catches what framing cannot
    f = tier._file(key)
    blob = bytearray(f.read_bytes())
    blob[-1] ^= 0xFF
    f.write_bytes(bytes(blob))
    assert tier.get(key) is None and tier.corrupt == 2


def test_disk_cache_injected_read_error_is_miss_not_corruption(tmp_path):
    inj = FaultInjector([fail_once("cache.disk.read")])
    tier = DiskCacheTier(tmp_path, injector=inj)
    key = ("k", 3)
    tier.put(key, "value")
    assert tier.get(key) is None                 # injected I/O error
    assert tier.corrupt == 0 and tier.misses == 1
    assert tier.get(key) == "value"              # file was never touched


def test_result_cache_spill_recomputes_through_corruption(tmp_path):
    cache = ResultCache(max_entries=2, spill_dir=tmp_path)
    for i in range(3):                           # overflow the memory LRU
        cache.put(("k", i), f"v{i}")
    assert cache.get(("k", 0)) == "v0"           # promoted back from disk

    f = cache.disk._file(("k", 1))
    f.write_bytes(b"garbage")
    assert cache.get(("k", 1)) is None           # corrupt disk + mem miss
    assert cache.disk.corrupt == 1


# ---------------------------------------------------------------------------
# chaos properties: random seeded fault plans vs 64-query bursts
# ---------------------------------------------------------------------------
def chaos_case(seed):
    rng = random.Random(seed)
    mc = tiny_machine()
    traces = [random_trace(mc, seed=1000 + i, name=f"z{i}")
              for i in range(8)]
    combos = [(tr, pc) for tr in traces for pc in MIXED_POLICIES]

    def det_sweep(mc_, ccs, pcs, trs, **kw):
        # content-determined lane results: identical with and without
        # faults, so survivor comparison is meaningful
        return [f"r:{tr.name}:{pc.label()}" for pc, tr in zip(pcs, trs)]

    clock = FakeClock()
    inj = FaultInjector()
    if rng.random() < 0.7:
        inj.add(fail_n("sweep.device", rng.randint(1, 3)))
    if rng.random() < 0.5:
        inj.add(fail_n("broker.flush", rng.randint(1, 2)))
    if rng.random() < 0.4:
        inj.add(fail_rate("sweep.device", 0.08, seed=seed))
    b = SimBroker(
        max_lanes=8, max_wait=0.5, clock=clock, sleep=lambda s: None,
        injector=inj,
        resilience=ResilienceConfig(max_retries=rng.randint(0, 2),
                                    backoff_base=0.001,
                                    breaker_threshold=2, breaker_recovery=1,
                                    quarantine_ttl=1000.0))
    for _ in range(rng.randint(0, 2)):
        tr, pc = rng.choice(combos)
        inj.add(fail_lane("sweep.device", b.query_digest(
            SimQuery(trace=tr, policy=pc, machine=mc))))

    import repro_torch.service.broker as bmod
    orig = bmod.sweep_lanes
    bmod.sweep_lanes = det_sweep
    try:
        futs, baselines = [], []
        for _ in range(64):
            tr, pc = rng.choice(combos)
            deadline = clock.now - 1.0 if rng.random() < 0.15 else None
            futs.append(b.submit(SimQuery(trace=tr, policy=pc, machine=mc,
                                          deadline=deadline)))
            baselines.append(f"r:{tr.name}:{pc.label()}")
            if rng.random() < 0.2:
                clock.now += rng.uniform(0.0, 0.3)
        b.drain()

        stranded = [f for f in futs if not f.done()]
        assert not stranded, f"{len(stranded)} futures stranded"
        for fut, base in zip(futs, baselines):
            try:
                r = fut.result()
            except ServiceError:
                continue                 # typed failure: acceptable
            assert r == base, "survivor result diverged from fault-free run"
        assert b._fut_index == {}, "settled futures leaked index entries"

        # the broker must come back: clean traffic closes any breaker
        for i in range(10):
            if not b.degraded_buckets():
                break
            clock.now += 1.0
            try:
                b.run([SimQuery(
                    trace=random_trace(mc, seed=7000 + seed % 1000 + i,
                                       name=f"rec{i}"),
                    policy=MIXED_POLICIES[0], machine=mc)])
            except ServiceError:
                pass
        assert not b.degraded_buckets(), "broker stuck in degraded mode"
    finally:
        bmod.sweep_lanes = orig


@pytest.mark.chaos
@pytest.mark.parametrize("seed", range(5))
def test_chaos_fixed_seeds(seed):
    """Deterministic chaos coverage (runs without hypothesis)."""
    chaos_case(seed)


if HAVE_HYPOTHESIS:
    @pytest.mark.chaos
    @settings(max_examples=10, deadline=None)
    @given(st.integers(min_value=0, max_value=10 ** 6))
    def test_chaos_property(seed):
        chaos_case(seed)


# ---------------------------------------------------------------------------
# acceptance: real execution, every failure mode at once, exact counters
# ---------------------------------------------------------------------------
@pytest.mark.chaos
@pytest.mark.slow
def test_chaos_acceptance_64_query_burst(tmp_path):
    """The acceptance burst: a seeded plan injecting a transient device
    failure, one persistent poison lane, two torn disk-cache writes and
    four expired deadlines into a 64-query mixed burst.  Every future
    terminates (result or typed error), innocent results are
    bit-identical to a fault-free run, corrupt cache entries are
    quarantined and recomputed, and the snapshot pins exact counters."""
    mc = tiny_machine()
    policies = [dataclasses.replace(MIXED_POLICIES[0], autonuma=False),
                dataclasses.replace(MIXED_POLICIES[1], autonuma=False,
                                    mig=False),
                dataclasses.replace(MIXED_POLICIES[2], autonuma=False),
                dataclasses.replace(MIXED_POLICIES[0], autonuma=False,
                                    mig=True)]
    traces = [random_trace(mc, seed=300 + i, name=f"c{i}")
              for i in range(16)]
    combos = [(tr, pc) for tr in traces for pc in policies]    # 64 lanes

    # fault-free reference run (its own broker, no injection, no spill)
    ref = SimBroker(max_lanes=64)
    ref_results = ref.run([SimQuery(trace=tr, policy=pc, machine=mc)
                           for tr, pc in combos])

    probe = SimBroker()
    poisoned_digest = probe.query_digest(
        SimQuery(trace=combos[0][0], policy=combos[0][1], machine=mc))
    plan = FaultInjector([
        fail_n("sweep.device", 1),                       # transient hiccup
        fail_lane("sweep.device", poisoned_digest),      # persistent poison
        fail_n("cache.disk.write", 2, kind="corrupt"),   # torn spills
    ])
    clock = FakeClock()
    sleeps = []
    b1 = SimBroker(max_lanes=128, max_wait=1e9, clock=clock,
                   sleep=sleeps.append, injector=plan,
                   cache=ResultCache(spill_dir=tmp_path))
    queries = []
    for i, (tr, pc) in enumerate(combos):
        # the last four queries carry deadlines that expire before flush
        dl = clock.now + 5.0 if i >= 60 else None
        queries.append(SimQuery(trace=tr, policy=pc, machine=mc,
                                deadline=dl))
    futs = b1.submit_many(queries)
    clock.now += 6.0                     # blow the four deadlines
    assert b1.pump() == 1
    b1.drain()

    # zero stranded; exactly one poisoned, four shed, 59 innocent results
    assert all(f.done() for f in futs) and b1._fut_index == {}
    with pytest.raises(PoisonedQueryError) as ei:
        futs[0].result()
    assert ei.value.digest == poisoned_digest
    for i in (60, 61, 62, 63):
        with pytest.raises(DeadlineExceededError):
            futs[i].result()
    for i in range(1, 60):
        assert_bitwise(futs[i].result(), ref_results[i], f"query {i}")

    snap = b1.snapshot()
    assert snap["broker"]["queries"] == 64
    assert snap["broker"]["retries"] == 1        # the transient hiccup
    assert snap["broker"]["shed"] == 4
    assert snap["broker"]["quarantined"] == 1
    assert snap["broker"]["rejected"] == 0
    assert snap["broker"]["flushes"] == 1
    assert snap["broker"]["lanes_run"] == 59     # bisection halves: 30+15+
    assert snap["broker"]["pad_lanes"] == 4      # 7+4+2+1 lanes, 2+1+1 pads
    assert snap["quarantine"] == {"size": 1, "digests": [poisoned_digest]}
    assert snap["degraded_buckets"] == []        # 2 failures < threshold 3
    assert snap["faults"]["injected"] == {"sweep.device": 8,   # 2 batch
                                          "cache.disk.write": 2}  # attempts
    assert snap["faults"]["total_injected"] == 10  # + 5 bisect + 1 leaf
    assert sleeps == [0.01]                       # one backoff before retry
    # resubmitting the poisoned query fails fast while quarantined
    with pytest.raises(PoisonedQueryError) as ei:
        b1.submit(queries[0]).result()
    assert ei.value.quarantined

    # phase 2: a cold broker on the same spill dir self-heals the two
    # torn entries (detected, quarantined, recomputed) and serves the rest
    b2 = SimBroker(max_lanes=128, max_wait=1e9,
                   cache=ResultCache(spill_dir=tmp_path))
    futs2 = b2.submit_many([SimQuery(trace=tr, policy=pc, machine=mc)
                            for tr, pc in combos[1:]])
    b2.drain()
    for fut, ref_res in zip(futs2, ref_results[1:]):
        assert_bitwise(fut.result(), ref_res, "healed")
    assert b2._fut_index == {}
    snap2 = b2.snapshot()
    assert snap2["cache"]["disk"]["corrupt"] == 2
    assert snap2["cache"]["disk"]["quarantined"] == 2
    assert snap2["broker"]["cache_hits"] == 57   # 59 spilled - 2 torn
    assert snap2["broker"]["lanes_run"] == 6     # 2 healed + 4 never-run
    assert snap2["broker"]["flushes"] == 1
