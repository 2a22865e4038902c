"""The port's simulation service (``repro_torch.service``) on the CPU: the
twins of tests/test_service.py, at its sizes.

The contract chain, as in the reference: a broker lane == a
``sweep_lanes`` lane == a sequential ``TieredMemSimulator`` run.  On the
port the last link is bitwise (every state field and timeline key, f32
cycles included: a solo run is the one-lane case of the same engine), and
the real-engine cases are also held against the JAX package's broker on
the same queries (integers exact, cycles to ``rtol=1e-5``,
``assert_same_run``) with the same stats (compiles, cache hits, in-flight
joins, pad lanes).  Query keys and their digests equal the reference's.
The scheduler cases stub the executor through ``broker.sweep_lanes``, as
the reference's do.

Not twinned here: ``test_policy_sweep_summary_routes_through_broker``
(``launch.analysis``, part of the model stack) and
``test_service_throughput_quick_smoke`` (the benchmark twin), which wait
for those modules.  The reference's two-device sharding test becomes the
broker's ``lane_sharding`` on one device ("auto" taken, anything else
refused).
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import repro.core as jc
import repro.service as js
import repro_torch.core as tc
from repro_torch.core import workloads as twl
from repro_torch.service import (DiskCacheTier, ResultCache, SimBroker,
                                 SimQuery, grid_search, lane_digest,
                                 policy_grid, query_cache_key,
                                 spec_cache_key, successive_halving)
from repro_torch.service import broker as broker_mod

import test_service as ref
from test_torch_blocked import assert_bitwise
from test_torch_engine import to_port
from test_torch_engine_jax import assert_same_run
from test_torch_engine import fresh_jax_caches  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


@pytest.fixture(autouse=True)
def port_history(tmp_path, monkeypatch):
    """The port's BenchRecord history and baselines go to ``tmp_path``,
    never to ``artifacts/``."""
    from repro_torch.obs import bench, report
    monkeypatch.setattr(bench, "DEFAULT_HISTORY",
                        tmp_path / "bench_torch" / "history.jsonl")
    monkeypatch.setattr(report, "DEFAULT_BASELINES",
                        tmp_path / "bench_torch" / "baselines.json")


def port(obj):
    """The port's twin of a JAX config, trace, trace spec or query."""
    if isinstance(obj, (list, tuple)):
        return [port(x) for x in obj]
    if isinstance(obj, jc.TraceSpec):
        return tc.TraceSpec(**{f.name: getattr(obj, f.name)
                               for f in dataclasses.fields(obj)})
    if isinstance(obj, js.SimQuery):
        kw = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
        for k in ("trace", "policy", "cost", "machine"):
            kw[k] = port(kw[k])
        return SimQuery(**kw)
    return to_port(obj)


def tiny_machine():
    return port(ref.tiny_machine())


def random_trace(mc, **kw):
    """``test_service.random_trace`` for the port's machine ``mc``."""
    return port(ref.random_trace(jc.MachineConfig(**dataclasses.asdict(mc)),
                                 **kw))


MIXED_POLICIES = port(ref.MIXED_POLICIES)


def broker(**kw):
    kw.setdefault("device", "cpu")
    return SimBroker(**kw)


def solo(q, trace=None):
    """The port's sequential run of query ``q`` on the CPU."""
    return tc.TieredMemSimulator(mc=q.machine, cc=q.cost, pc=q.policy,
                                 device="cpu").run(trace or q.trace)


def jax_broker_run(queries, **kw):
    """The JAX package's broker on the same (JAX) queries: its results and
    its stats."""
    b = js.SimBroker(**kw)
    return b.run(queries), b.stats


def assert_matches_jax(jres, pres, label=""):
    for i, (a, b) in enumerate(zip(jres, pres, strict=True)):
        assert_same_run(a, b, f"{label} query {i}: port broker vs JAX broker")


# ---------------------------------------------------------------------------
# sweep_lanes: the broker's execution primitive
# ---------------------------------------------------------------------------
def test_sweep_lanes_independent_tuples_match_sequential():
    mc = tiny_machine()
    tr_a = random_trace(mc, seed=1, free_at=40, name="a")
    tr_b = random_trace(mc, seed=2, name="b")
    ccs = [tc.CostConfig(), tc.CostConfig(nvmm_read=1500), tc.CostConfig()]
    trs = [tr_a, tr_b, tr_a]
    res = tc.sweep_lanes(mc, ccs, MIXED_POLICIES, trs, budget=512,
                         device="cpu")
    assert len(res) == 3
    for cc, pc, tr, r in zip(ccs, MIXED_POLICIES, trs, res):
        seq = tc.TieredMemSimulator(mc=mc, cc=cc, pc=pc,
                                    device="cpu").run(tr)
        assert_bitwise(r, seq, pc.label())


def test_sweep_lanes_validation():
    mc = tiny_machine()
    tr = random_trace(mc, seed=3)
    with pytest.raises(ValueError, match="lane lists"):
        tc.sweep_lanes(mc, [tc.CostConfig()], MIXED_POLICIES, [tr, tr, tr],
                       device="cpu")
    with pytest.raises(ValueError, match="budget override"):
        tc.sweep_lanes(mc, [tc.CostConfig()], [MIXED_POLICIES[0]], [tr],
                       budget=8, device="cpu")
    with pytest.raises(ValueError, match="at least one lane"):
        tc.sweep_lanes(mc, [], [], [], device="cpu")


# ---------------------------------------------------------------------------
# broker: correctness and batching
# ---------------------------------------------------------------------------
def test_broker_results_bit_identical_to_sequential():
    """The reference's mixed burst (raw traces with a mid-run free and a
    spec-addressed workload, mixed policies and costs): each result ==
    its sequential port run on the canonical trace, bitwise, and == the
    JAX broker's result for the same query, with the same stats."""
    jmc = ref.tiny_machine()
    spec = jc.TraceSpec(workload="xsbench", footprint=64, run_steps=16)
    traces = [ref.random_trace(jmc, seed=4, free_at=30, name="f"),
              ref.random_trace(jmc, seed=5, name="g"), spec]
    jqueries = [js.SimQuery(trace=tr, policy=pc, machine=jmc,
                            cost=jc.CostConfig(nvmm_read=750 + 250 * i))
                for i, tr in enumerate(traces) for pc in ref.MIXED_POLICIES[:2]]
    queries = port(jqueries)
    b = broker(max_lanes=8)
    results = b.run(queries)
    for q, res in zip(queries, results):
        assert_bitwise(res, solo(q, b.canonical_trace(q)), q.policy.label())
    jres, jstats = jax_broker_run(jqueries, max_lanes=8)
    assert_matches_jax(jres, results)
    assert dataclasses.asdict(b.stats) == dataclasses.asdict(jstats)


def test_burst_compiles_once_per_bucket_and_caches():
    """64 queries (16 traces x 4 policies, one bucket): one compile of the
    reference's accounting; a second burst of other traces in the same
    bucket, none; the first burst again, all from the cache, no lane."""
    mc = tiny_machine()
    policies = [tc.PolicyConfig(data_policy=d, pt_policy=p, autonuma=False)
                for d in (tc.FIRST_TOUCH, tc.INTERLEAVE)
                for p in (tc.PT_FOLLOW_DATA, tc.PT_BIND_HIGH)]
    traces = [random_trace(mc, seed=100 + i, name=f"t{i}") for i in range(16)]
    queries = [SimQuery(trace=tr, policy=pc, machine=mc)
               for tr in traces for pc in policies]
    b = broker(max_lanes=64)

    before = tc.sweep_compile_count()
    futs = b.submit_many(queries)             # the 64th submit flushes
    assert all(f.done() for f in futs)
    assert tc.sweep_compile_count() == before + 1
    assert b.stats.flushes == 1
    assert b.stats.lanes_run == 64 and b.stats.pad_lanes == 0

    traces2 = [random_trace(mc, seed=200 + i, name=f"u{i}")
               for i in range(16)]
    b.run([SimQuery(trace=tr, policy=pc, machine=mc)
           for tr in traces2 for pc in policies])
    assert tc.sweep_compile_count() == before + 1

    lanes_before = b.stats.lanes_run
    futs3 = b.submit_many(queries)
    assert all(f.done() and f.from_cache for f in futs3)
    assert tc.sweep_compile_count() == before + 1
    assert b.stats.lanes_run == lanes_before
    assert b.stats.cache_hits == 64
    for f0, f3 in zip(futs, futs3):
        assert f3.result() is f0.result()
    # a lane of the burst == its solo run
    assert_bitwise(futs[5].result(), solo(queries[5]), "lane 5")


def test_inflight_dedup_single_lane():
    mc = tiny_machine()
    b = broker(max_lanes=4)
    q = SimQuery(trace=random_trace(mc, seed=7), policy=MIXED_POLICIES[2],
                 machine=mc)
    f1, f2 = b.submit(q), b.submit(q)
    assert b.stats.inflight_joins == 1
    assert b.pending_lanes() == 1
    b.drain()
    assert f1.result() is f2.result()
    assert_bitwise(f1.result(), solo(q), "dedup lane")


def test_lane_padding_and_forced_future():
    """A 3-lane flush pads to 4 and drops the pad; ``result()`` forces
    the bucket.  Every lane == its solo run and == the JAX broker's."""
    jmc = ref.tiny_machine()
    jtr = ref.random_trace(jmc, seed=8)
    jqueries = [js.SimQuery(trace=jtr, policy=pc, machine=jmc)
                for pc in ref.MIXED_POLICIES]
    queries = port(jqueries)
    b = broker(max_lanes=64, max_wait=1e9)
    futs = [b.submit(q) for q in queries]
    assert not any(f.done() for f in futs)
    res = futs[1].result()                    # forces the flush
    assert all(f.done() for f in futs)
    assert b.stats.pad_lanes == 1 and b.stats.lanes_run == 3
    assert_bitwise(res, solo(queries[1]), "forced lane")
    jres, jstats = jax_broker_run(jqueries, max_lanes=64, max_wait=1e9)
    assert_matches_jax(jres, [f.result() for f in futs])
    assert (jstats.pad_lanes, jstats.lanes_run, jstats.compiles) == \
        (b.stats.pad_lanes, b.stats.lanes_run, b.stats.compiles)


# ---------------------------------------------------------------------------
# scheduler (execution stubbed)
# ---------------------------------------------------------------------------
FakeClock = ref.FakeClock


@pytest.fixture
def stub_exec(monkeypatch):
    flushed = []

    def fake_sweep_lanes(mc, ccs, pcs, trs, phase_b="batched", budget=None,
                         lane_sharding=None, engine="blocked", **kw):
        flushed.append(len(pcs))
        return [f"result-{len(flushed)}-{i}" for i in range(len(pcs))]

    monkeypatch.setattr(broker_mod, "sweep_lanes", fake_sweep_lanes)
    return flushed


def test_max_wait_flush(stub_exec):
    mc = tiny_machine()
    clock = FakeClock()
    b = broker(max_lanes=64, max_wait=5.0, clock=clock)
    fut = b.submit(SimQuery(trace=random_trace(mc, seed=9),
                            policy=MIXED_POLICIES[0], machine=mc))
    assert b.pump() == 0 and not fut.done()
    clock.now += 5.1
    assert b.pump() == 1 and fut.done()


def test_deadline_flushes_before_max_wait(stub_exec):
    mc = tiny_machine()
    clock = FakeClock()
    b = broker(max_lanes=64, max_wait=1e9, clock=clock)
    fut = b.submit(SimQuery(trace=random_trace(mc, seed=10),
                            policy=MIXED_POLICIES[0], machine=mc,
                            deadline=clock.now + 2.0))
    assert b.pump() == 0
    clock.now += 2.0
    assert b.pump() == 1 and fut.done()


def test_priority_orders_due_buckets(stub_exec):
    mc = tiny_machine()
    clock = FakeClock()
    b = broker(max_lanes=64, max_wait=1.0, clock=clock)
    lo = b.submit(SimQuery(trace=random_trace(mc, seed=11, steps=48),
                           policy=MIXED_POLICIES[0], machine=mc, priority=0))
    clock.now += 0.5
    hi = b.submit(SimQuery(trace=random_trace(mc, seed=12, steps=96),
                           policy=MIXED_POLICIES[0], machine=mc, priority=5))
    clock.now += 1.0
    b.pump()
    assert hi.done() and lo.done()
    assert hi.result() == "result-1-0"
    assert lo.result() == "result-2-0"


def test_failed_flush_fails_futures_not_hangs(monkeypatch):
    """A failing microbatch fails its futures with PoisonedQueryError,
    quarantines the digests (resubmits fail fast), and real traffic flows
    again once the TTL lapses, == its solo run."""
    from repro_torch.service.resilience import (PoisonedQueryError,
                                                ResilienceConfig)
    mc = tiny_machine()
    clock = FakeClock()
    b = broker(max_lanes=64, max_wait=1e9, clock=clock, sleep=lambda s: None,
               resilience=ResilienceConfig(max_retries=1, quarantine_ttl=10.0))
    tr = random_trace(mc, seed=13)
    futs = [b.submit(SimQuery(trace=tr, policy=pc, machine=mc))
            for pc in MIXED_POLICIES[:2]]

    boom = RuntimeError("a kernel launch failed")

    def exploding(*a, **k):
        raise boom

    monkeypatch.setattr(broker_mod, "sweep_lanes", exploding)
    b.drain()
    for f in futs:
        assert f.done()
        with pytest.raises(PoisonedQueryError) as ei:
            f.result()
        assert ei.value.__cause__ is boom
    assert b.stats.quarantined == 2
    assert b.stats.retries == 1

    fast = b.submit(SimQuery(trace=tr, policy=MIXED_POLICIES[0], machine=mc))
    with pytest.raises(PoisonedQueryError) as ei:
        fast.result()
    assert ei.value.quarantined
    monkeypatch.undo()

    clock.now += 11.0
    assert b.pending_lanes() == 0
    q = SimQuery(trace=tr, policy=MIXED_POLICIES[0], machine=mc)
    assert_bitwise(b.run([q])[0], solo(q), "after the TTL")


def test_submit_rejects_thread_mismatch(stub_exec):
    mc = tiny_machine()
    wide = tc.MachineConfig(n_threads=8, dram_pages_per_node=300,
                            nvmm_pages_per_node=1200, va_pages=1 << 11)
    tr = random_trace(wide, seed=14)
    with pytest.raises(ValueError, match="threads"):
        broker().submit(SimQuery(trace=tr, policy=MIXED_POLICIES[0],
                                 machine=mc))


def test_spec_cache_hit_skips_generation(stub_exec):
    mc = tiny_machine()
    b = broker(max_lanes=1)
    spec = tc.TraceSpec(workload="bfs", footprint=64, run_steps=16)
    q = SimQuery(trace=spec, policy=MIXED_POLICIES[0], machine=mc)
    f1 = b.submit(q)
    assert f1.done() and not f1.from_cache
    twl._SPEC_CACHE.clear()
    f2 = b.submit(q)
    assert f2.done() and f2.from_cache
    assert len(twl._SPEC_CACHE) == 0


def test_queries_validate_eagerly(stub_exec):
    """As the reference's, and a stacked policy (tensor leaves, which
    hash by identity where JAX arrays refuse to) is refused too."""
    mc = tiny_machine()
    with pytest.raises(ValueError, match="Trace or TraceSpec"):
        SimQuery(trace=np.zeros((4, 4)), policy=tc.PolicyConfig(), machine=mc)
    with pytest.raises(ValueError, match="phase_b"):
        SimQuery(trace=random_trace(mc), policy=tc.PolicyConfig(), machine=mc,
                 phase_b="warp")
    stacked = tc.stack_policies([tc.PolicyConfig(), tc.PolicyConfig()],
                                device="cpu")
    with pytest.raises(ValueError, match="plain Python scalars"):
        broker().submit(SimQuery(trace=random_trace(mc), policy=stacked,
                                 machine=mc))


# ---------------------------------------------------------------------------
# spec addressing and digests
# ---------------------------------------------------------------------------
def test_trace_spec_canonicalization_and_digest():
    mc = tiny_machine()
    b = broker()
    spec = tc.TraceSpec(workload="memcached", footprint=64, run_steps=10)
    q = SimQuery(trace=spec, policy=tc.PolicyConfig(), machine=mc)
    tr1 = b.canonical_trace(q)
    assert b.canonical_trace(q) is tr1
    assert tr1.n_steps == 64
    nat = spec.build(mc)
    assert tc.trace_digest(tr1) == tc.trace_digest(tc.pad_trace(nat, 64))
    renamed = dataclasses.replace(nat, name="other")
    assert tc.trace_digest(nat) == tc.trace_digest(renamed)
    assert tc.trace_digest(nat) != tc.trace_digest(
        tc.TraceSpec(workload="memcached", footprint=64, run_steps=10,
                     seed=1).build(mc))
    assert spec.digest(mc) != dataclasses.replace(
        spec, run_steps=11).digest(mc)
    with pytest.raises(ValueError, match="unknown workload"):
        tc.TraceSpec(workload="nope", footprint=64, run_steps=8)


@pytest.mark.parametrize("kind", ["trace", "spec"])
def test_cache_keys_and_digests_equal_the_reference(kind):
    """``query_cache_key`` / ``spec_cache_key`` of equal queries print the
    same in both packages (their reprs are what the disk tier's file
    names and ``lane_digest`` hash), so their digests are equal."""
    jmc = ref.tiny_machine()
    if kind == "trace":
        jtr = ref.random_trace(jmc, seed=4, free_at=30, name="f")
    else:
        jtr = jc.TraceSpec(workload="xsbench", footprint=64, run_steps=16)
    for pc, cc in ((ref.MIXED_POLICIES[1], jc.CostConfig(nvmm_read=900)),
                   (ref.MIXED_POLICIES[2], jc.CostConfig())):
        jq = js.SimQuery(trace=jtr, policy=pc, cost=cc, machine=jmc)
        q = port(jq)
        if kind == "trace":
            jkey = js.query_cache_key(jq, jtr)
            key = query_cache_key(q, q.trace)
        else:
            jkey, key = js.spec_cache_key(jq, 64), spec_cache_key(q, 64)
        assert repr(key) == repr(jkey)
        assert lane_digest(key) == js.lane_digest(jkey)
        assert broker().query_digest(q) == js.SimBroker().query_digest(jq)


def test_result_cache_lru_bound():
    c = ResultCache(max_entries=2)
    c.put(("a",), 1)
    c.put(("b",), 2)
    assert c.get(("a",)) == 1
    c.put(("c",), 3)
    assert c.get(("b",)) is None and len(c) == 2
    assert c.hits == 1 and c.misses == 1
    assert c.evictions == 1
    assert c.stats() == {"hits": 1, "misses": 1, "evictions": 1,
                         "entries": 2}


def test_broker_stats_reset_and_pad_ratio(stub_exec):
    mc = tiny_machine()
    b = broker(max_lanes=64, max_wait=1e9)
    tr = random_trace(mc, seed=21)
    futs = [b.submit(SimQuery(trace=tr, policy=pc, machine=mc))
            for pc in MIXED_POLICIES]
    futs[0].result()
    assert b.stats.lanes_run == 3 and b.stats.pad_lanes == 1
    assert b.stats.pad_ratio == 0.25
    d = b.stats.as_dict()
    assert d["pad_lanes"] == 1 and d["pad_ratio"] == 0.25
    b.stats.reset()
    assert all(v == 0 for v in b.stats.as_dict().values())
    assert b.stats.pad_ratio == 0.0
    b.run([SimQuery(trace=tr, policy=MIXED_POLICIES[0], machine=mc)])
    assert b.stats.queries == 1


def test_disk_cache_tier_roundtrip_and_byte_cap(tmp_path):
    tier = DiskCacheTier(tmp_path / "d", max_bytes=1 << 20)
    key = (("m", 4), "batched", "blocked", (1.5, 2), "digest")
    assert tier.get(key) is None and tier.misses == 1
    tier.put(key, {"x": np.arange(8)})
    got = tier.get(key)
    assert tier.hits == 1
    np.testing.assert_array_equal(got["x"], np.arange(8))
    assert DiskCacheTier(tmp_path / "d", max_bytes=1 << 20).get(key) is not None
    small = DiskCacheTier(tmp_path / "s", max_bytes=6000)
    for i in range(4):
        small.put((i,), np.zeros(500))
        os.utime(small._file((i,)), (i + 1, i + 1))
    small._evict()
    alive = [i for i in range(4) if small.get((i,)) is not None]
    assert 0 < len(alive) < 4
    assert alive == list(range(4 - len(alive), 4))
    assert sum(f.stat().st_size
               for f in (tmp_path / "s").glob("*.pkl")) <= 6000


def test_disk_cache_frames_match_the_reference(tmp_path):
    """The port's frame is the reference's byte for byte (magic, blake2b
    checksum, length, payload), and each tier reads the other's frame of
    plain data."""
    from repro.service import cache as jcache
    from repro_torch.service import cache as tcache
    payload = b"\x00payload\xff" * 7
    assert tcache._frame(payload) == jcache._frame(payload)
    assert tcache._unframe(jcache._frame(payload)) == payload
    key = ("k", 7, 1.5)
    js.DiskCacheTier(tmp_path).put(key, {"v": [1, 2]})
    tier = DiskCacheTier(tmp_path)
    assert tier._file(key) == js.DiskCacheTier(tmp_path)._file(key)
    assert tier.get(key) == {"v": [1, 2]}


def test_disk_cache_eviction_accounting(tmp_path):
    tier = DiskCacheTier(tmp_path / "d", max_bytes=6000)
    for i in range(4):
        tier.put((i,), np.zeros(500))
        os.utime(tier._file((i,)), (i + 1, i + 1))
    tier._evict()
    assert tier.flushes == 4
    on_disk = sum(1 for _ in (tmp_path / "d").glob("*.pkl"))
    assert tier.evictions == 4 - on_disk > 0
    stats = tier.stats()
    assert stats["flushes"] == 4
    assert stats["evictions"] == tier.evictions
    assert stats["entries"] == on_disk
    tier.get((0,))
    tier.get((3,))
    assert tier.stats()["misses"] == 1 and tier.stats()["hits"] == 1
    tiny = DiskCacheTier(tmp_path / "t", max_bytes=100)
    tiny.put(("big",), np.zeros(500))
    assert tiny.flushes == 0 and tiny.stats()["entries"] == 0


def run_port_child(code):
    """``code`` in a fresh Python process with only ``src`` on the path;
    it must print "CHILD-OK" and load no module of JAX or the JAX
    package."""
    code = textwrap.dedent(code) + textwrap.dedent("""
        bad = sorted(m for m in sys.modules
                     if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))
        assert not bad, bad
        print("CHILD-OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "CHILD-OK" in proc.stdout
    return proc.stdout


CHILD_QUERY = """
    import sys
    import repro_torch.core as tc
    from repro_torch.service import ResultCache, SimBroker, SimQuery
    mc = tc.MachineConfig(n_threads=4, dram_pages_per_node=300,
                          nvmm_pages_per_node=1200, va_pages=1 << 11,
                          l1_tlb_sets=4, l1_tlb_ways=2, stlb_sets=8,
                          stlb_ways=4, pde_pwc_entries=4,
                          pdpte_pwc_entries=2)
    spec = tc.TraceSpec(workload="xsbench", footprint=64, run_steps=16)
    q = SimQuery(trace=spec, policy=tc.PolicyConfig(autonuma=False),
                 machine=mc)
"""


def test_disk_spilled_cache_serves_fresh_process_with_zero_device_work(
        tmp_path):
    """Warm the spill directory through one broker here, then a fresh
    process of the port alone rebuilds everything over it and is served
    from disk: no flush, no lane, no compile, the same result."""
    mc = tiny_machine()
    spec = tc.TraceSpec(workload="xsbench", footprint=64, run_steps=16)
    warm = broker(max_lanes=1, cache=ResultCache(spill_dir=tmp_path / "cache"))
    res1 = warm.submit(SimQuery(trace=spec, policy=tc.PolicyConfig(
        autonuma=False), machine=mc)).result()
    assert warm.stats.flushes == 1
    np.save(tmp_path / "total.npy", res1.timeline["total_cycles"])
    out = run_port_child(CHILD_QUERY + f"""
    import numpy as np
    cold = SimBroker(max_lanes=1, device="cpu",
                     cache=ResultCache(spill_dir={str(tmp_path / "cache")!r}))
    assert len(cold.cache) == 0
    before = tc.sweep_compile_count()
    fut = cold.submit(q)
    assert fut.done() and fut.from_cache
    assert cold.stats.flushes == 0 and cold.stats.lanes_run == 0
    assert tc.sweep_compile_count() == before
    assert cold.cache.disk.hits == 1
    np.testing.assert_array_equal(
        fut.result().timeline["total_cycles"],
        np.load({str(tmp_path / "total.npy")!r}))
    print("SUMMARY", sorted(fut.result().summary().items()))
    """)
    assert f"SUMMARY {sorted(res1.summary().items())}" in out


def test_reference_spill_entry_reads_as_a_miss_in_the_port(tmp_path):
    """The JAX package writes its entry for a query into a spill
    directory; a process of the port alone reads the same file name as a
    miss (not corrupt, not quarantined, left in place) without loading
    JAX or the JAX package, runs the query and writes its own entry."""
    jmc = ref.tiny_machine()
    jspec = jc.TraceSpec(workload="xsbench", footprint=64, run_steps=16)
    jq = js.SimQuery(trace=jspec, policy=jc.PolicyConfig(autonuma=False),
                     machine=jmc)
    jkey = js.spec_cache_key(jq, 64)
    jtier = js.DiskCacheTier(tmp_path)
    jtier.put(jkey, jc.RunResult(final_state=None, timeline={},
                                 trace_name="reference", policy_label="x"))
    entry = jtier._file(jkey)
    assert b"repro.core.sim" in entry.read_bytes()
    assert DiskCacheTier(tmp_path)._file(spec_cache_key(port(jq), 64)) == entry
    run_port_child(CHILD_QUERY + f"""
    import pathlib
    from repro_torch.service import DiskCacheTier
    from repro_torch.service.query import spec_cache_key
    tier = DiskCacheTier({str(tmp_path)!r})
    key = spec_cache_key(q, 64)
    entry = tier._file(key)
    assert entry.exists()
    assert tier.get(key) is None
    assert (tier.misses, tier.hits, tier.corrupt) == (1, 0, 0)
    assert entry.exists() and tier.stats()["quarantined"] == 0
    b = SimBroker(max_lanes=1, device="cpu",
                  cache=ResultCache(spill_dir={str(tmp_path)!r}))
    fut = b.submit(q)
    assert not fut.from_cache and b.stats.flushes == 1
    got = DiskCacheTier({str(tmp_path)!r}).get(key)
    assert type(got).__module__ == "repro_torch.core.sim"
    assert got.summary() == fut.result().summary()
    """)


# ---------------------------------------------------------------------------
# one device: "auto" is the degenerate lane mesh, anything else is refused
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sharding", ["auto", object()])
def test_lane_sharding_refused_on_one_device(sharding):
    """On one device the broker takes ``lane_sharding="auto"`` (the lane
    mesh of that device, bitwise equal to no sharding) and refuses what is
    neither ``None``, ``"auto"`` nor a ``LaneMesh`` when it is made, with
    ``sweep_lanes``'s message, instead of failing every flush."""
    mc = tiny_machine()
    tr = random_trace(mc, seed=15)
    q = [SimQuery(trace=tr, policy=MIXED_POLICIES[0], machine=mc)]
    if sharding == "auto":
        got = broker(lane_sharding=sharding).run(q)
        assert_bitwise(got[0], broker().run(q)[0], "auto vs None")
        return
    with pytest.raises(ValueError, match="lane_sharding must be None"):
        broker(lane_sharding=sharding)
    with pytest.raises(ValueError, match="lane_sharding must be None"):
        tc.sweep_lanes(mc, [tc.CostConfig()], [MIXED_POLICIES[0]], [tr],
                       lane_sharding=sharding, device="cpu")


# ---------------------------------------------------------------------------
# search drivers
# ---------------------------------------------------------------------------
def test_grid_search_and_successive_halving_reuse_cache():
    mc = tiny_machine()
    b = broker(max_lanes=16)
    spec = tc.TraceSpec(workload="xsbench", footprint=64, run_steps=16)
    cands = policy_grid({"data_policy": (tc.FIRST_TOUCH, tc.INTERLEAVE),
                         "pt_policy": (tc.PT_FOLLOW_DATA, tc.PT_BIND_HIGH)},
                        base=tc.PolicyConfig(autonuma=False))
    assert len(cands) == 4
    scored = grid_search(b, mc, spec, cands)
    assert [s for _, s in scored] == sorted(s for _, s in scored)
    out = successive_halving(b, mc, spec, policies=cands, rungs=2)
    assert out["best_label"] in {pc.label() for pc in cands}
    assert len(out["history"]) == 2
    assert len(out["history"][1]["scores"]) == 2
    assert b.cache.hits >= 4
    lanes = b.stats.lanes_run
    out2 = successive_halving(b, mc, spec, policies=cands, rungs=2)
    assert out2["best_label"] == out["best_label"]
    assert b.stats.lanes_run == lanes
    # the grid's scores are the solo runs' total cycles
    for pc, score in scored:
        q = SimQuery(trace=spec, policy=pc, machine=mc)
        assert score == solo(q, b.canonical_trace(q)).summary()["total_cycles"]
