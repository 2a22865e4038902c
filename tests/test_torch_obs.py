"""The port's telemetry and perf observatory (``repro_torch.obs``) on the
CPU: the twins of tests/test_obs.py and of tests/test_report.py.

* **Primitives** — counters, gauges, fixed log-bucket histograms, the
  span recorder's Chrome/Perfetto export and its validator, the
  BenchRecord schema and history, the regression gate, quantiles over
  merged snapshots, the flight recorder and the validator CLI.
* **The same as the reference** — one seeded sequence of calls through
  the JAX package's modules and the port's gives equal metrics
  snapshots, equal exported trace-event JSON, equal quantiles after
  ``merge`` and, for a seed, the same fault schedule.
* **Bitwise identity** — with telemetry and tracing on, the port's
  ``TieredMemSimulator`` and ``sweep_lanes`` give every state field and
  timeline key bit for bit as with it off, and record the reference's
  counters and spans: on the same inputs, the JAX package's runs give the
  same metrics snapshot (timing histograms by their count) and the same
  spans (name, category, track and args), the broker's burst included.
* **The acceptance burst** — 64 queries through an instrumented broker:
  the snapshot's compile, cache-hit, lane and pad-lane figures exact, and
  a trace that passes ``validate_trace_events``.

The green path on the JAX package's committed history becomes one on a
synthetic history under ``tmp_path``: the port has no committed history.
``test_run_manifest_records_drivers_and_failures`` waits for the
benchmark drivers' twin.
"""
import json
import math
import random

import numpy as np
import pytest

import repro.core as jc
import repro.obs as jobs
import repro.service as js
import repro_torch.core as tc
from repro_torch.obs import (Counter, FaultInjector, FlightRecorder, Gauge,
                             Histogram, MetricsRegistry, NULL, NullTelemetry,
                             SpanRecorder, Telemetry, append_record, fail_lane,
                             fail_n, fail_once, fail_rate, flatten_metrics,
                             load_history, make_record, merge, next_run_id,
                             or_null, quantile_from_snapshot,
                             validate_postmortem, validate_record,
                             validate_trace_events)
from repro_torch.obs import bench as bench_mod
from repro_torch.obs import report as report_mod
from repro_torch.obs import validate as validate_cli
from repro_torch.obs.bench import namespace_of
from repro_torch.obs.inject import InjectedFault
from repro_torch.service import SimQuery
from repro_torch.service.broker import _bucket_label
from repro_torch.service.resilience import PoisonedQueryError

import test_service as ref
from test_torch_blocked import assert_bitwise
from test_torch_service import (MIXED_POLICIES, port, port_history,
                                random_trace, tiny_machine)
from test_torch_service import broker as SimBroker
from test_torch_engine import fresh_jax_caches  # noqa: F401 (autouse)

assert port_history                      # autouse: the port's history to tmp


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------
def test_counter_gauge_basics():
    reg = MetricsRegistry()
    c = reg.counter("hits", tier="mem")
    c.inc()
    c.inc(3)
    assert reg.counter("hits", tier="mem") is c
    assert reg.counter("hits", tier="disk") is not c
    assert reg.value("hits", tier="mem") == 4
    assert reg.value("hits", tier="disk") == 0
    assert reg.value("hits") is None and reg.value("nope") is None
    g = reg.gauge("depth")
    g.set(7)
    g.inc(-2)
    assert reg.value("depth") == 5
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("hits")
    snap = reg.snapshot()
    assert snap == {"depth": 5, "hits{tier=disk}": 0, "hits{tier=mem}": 4}
    assert list(snap) == sorted(snap)
    assert isinstance(c, Counter) and isinstance(g, Gauge)
    reg.reset()
    assert reg.snapshot() == {}


def test_histogram_fixed_log_buckets():
    h = Histogram(lo=1e-3, base=2.0, n_buckets=8)
    assert h.bucket_of(1e-3) == 0
    assert h.bucket_of(0.0) == 0
    assert h.bucket_of(2e-3) == 1
    assert h.bucket_of(2.1e-3) == 2
    assert h.bucket_of(1e9) == 7
    assert h.bucket_le(0) == 1e-3
    assert math.isinf(h.bucket_le(7))
    for v in (0.5e-3, 1.5e-3, 1.5e-3, 3e-3):
        h.observe(v)
    s = h.snapshot()
    assert s["count"] == 4 and s["min"] == 0.5e-3 and s["max"] == 3e-3
    assert s["sum"] == pytest.approx(6.5e-3)
    assert s["mean"] == pytest.approx(6.5e-3 / 4)
    assert s["buckets"] == {"0.001": 1, "0.002": 2, "0.004": 1}
    h2 = Histogram(lo=1e-3, base=2.0, n_buckets=8)
    h2.observe(1.5e-3)
    merged = dict(s["buckets"])
    for k, n in h2.snapshot()["buckets"].items():
        merged[k] = merged.get(k, 0) + n
    assert merged["0.002"] == 3
    assert Histogram().snapshot() == {"count": 0, "sum": 0.0, "buckets": {}}
    with pytest.raises(ValueError):
        Histogram(lo=0)


# ---------------------------------------------------------------------------
# span recorder + trace_event export
# ---------------------------------------------------------------------------
class TickClock:
    def __init__(self, step=0.5):
        self.t, self.step = 100.0, step

    def __call__(self):
        self.t += self.step
        return self.t


def test_span_recorder_trace_event_export(tmp_path):
    rec = SpanRecorder(clock=TickClock(), process_name="unit")
    with rec.span("outer", cat="test", args={"k": 1}):
        rec.instant("tick")
    rec.add_span("explicit", rec.now(), rec.now(), tid=3)
    assert rec.span_names() == ["outer", "explicit"]
    obj = rec.to_trace_json()
    assert obj["displayTimeUnit"] == "ms"
    meta, *events = obj["traceEvents"]
    assert meta["ph"] == "M" and meta["args"]["name"] == "unit"
    inst, outer, explicit = events
    assert inst["ph"] == "i" and inst["ts"] >= 0
    assert outer["ph"] == "X" and outer["args"] == {"k": 1}
    assert outer["dur"] == pytest.approx(1.0e6)
    assert explicit["tid"] == 3
    assert explicit["dur"] == pytest.approx(0.5e6)
    assert validate_trace_events(obj) == []
    path = tmp_path / "t.json"
    rec.export(path)
    assert validate_trace_events(json.loads(path.read_text())) == []
    rec.reset()
    assert rec.events == [] and rec.dropped == 0


def test_span_recorder_bounded():
    rec = SpanRecorder(clock=TickClock(), max_events=2)
    for i in range(4):
        rec.instant(f"e{i}")
    assert len(rec.events) == 2 and rec.dropped == 2
    assert rec.to_trace_json()["otherData"]["dropped_events"] == 2


def test_validator_catches_malformed_traces():
    assert validate_trace_events({}) == ["traceEvents missing or not a list"]
    bad = {"traceEvents": [
        {"name": "a", "ph": "X", "ts": -1, "dur": 2, "pid": 0, "tid": 0},
        {"name": "b", "ph": "Z", "ts": 0},
        {"name": "c", "ph": "B", "ts": 0, "pid": 0, "tid": 0},
        {"ph": "E", "ts": 1, "pid": 0, "tid": 1},
    ]}
    problems = validate_trace_events(bad)
    assert any("bad ts" in p for p in problems)
    assert any("unknown ph" in p for p in problems)
    assert any("E without matching B" in p for p in problems)
    assert any("unclosed B" in p for p in problems)
    good = {"traceEvents": [
        {"name": "s", "ph": "X", "ts": 0.0, "dur": 1.0, "pid": 0, "tid": 0}]}
    assert validate_trace_events(good) == []


def test_validate_cli(tmp_path, capsys):
    rec = SpanRecorder(clock=TickClock())
    with rec.span("s"):
        pass
    ok = tmp_path / "ok.json"
    rec.export(ok)
    assert validate_cli.main([str(ok)]) == 0
    assert "ok — " in capsys.readouterr().out
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": []}))
    assert validate_cli.main([str(bad)]) == 1
    assert validate_cli.main([str(tmp_path / "missing.json")]) == 1
    assert validate_cli.main([]) == 2


# ---------------------------------------------------------------------------
# telemetry facade + the no-op default
# ---------------------------------------------------------------------------
def test_null_telemetry_is_inert_and_shared():
    assert or_null(None) is NULL
    tel = Telemetry()
    assert or_null(tel) is tel
    assert not NULL.enabled and not NULL.tracing
    assert NULL.counter("x") is NULL.counter("y", a=1)
    NULL.counter("x").inc(5)
    NULL.gauge("g").set(3)
    NULL.histogram("h").observe(1.0)
    assert NULL.counter("x").snapshot() == 0
    with NULL.span("s", args={"a": 1}):
        pass
    NULL.add_span("s", 0.0, 1.0)
    NULL.instant("i")
    assert NULL.now() is None
    assert NULL.snapshot() == {"metrics": {}}
    assert NULL.export_trace("/nonexistent/x.json") is False
    NULL.reset()
    assert isinstance(NULL, NullTelemetry)


def test_telemetry_facade_tracing_toggle(tmp_path):
    off = Telemetry()
    assert off.enabled and not off.tracing
    off.counter("c").inc()
    assert off.now() is None
    off.add_span("never", 0.0, 1.0)
    with off.span("also-never"):
        pass
    assert off.snapshot() == {"metrics": {"c": 1}}
    assert off.export_trace(tmp_path / "no.json") is False
    on = Telemetry(tracing=True, clock=TickClock())
    assert on.tracing
    with on.span("s"):
        pass
    on.add_span("t", on.now(), on.now())
    snap = on.snapshot()
    assert snap["trace"]["events"] == 2 and snap["trace"]["dropped"] == 0
    assert on.export_trace(tmp_path / "yes.json") is True
    assert validate_trace_events(
        json.loads((tmp_path / "yes.json").read_text())) == []
    on.reset()
    assert on.snapshot() == {"metrics": {},
                             "trace": {"events": 0, "dropped": 0}}


# ---------------------------------------------------------------------------
# the same outputs as the reference's modules
# ---------------------------------------------------------------------------
def drive_metrics(pkg, seed):
    """One seeded sequence of registry and histogram calls through
    ``pkg`` (``repro.obs`` or ``repro_torch.obs``); returns the snapshot."""
    rng = random.Random(seed)
    reg = pkg.MetricsRegistry()
    for _ in range(200):
        kind = rng.randrange(3)
        label = {"bucket": rng.choice("abc")}
        if kind == 0:
            reg.counter("c", **label).inc(rng.randrange(5))
        elif kind == 1:
            reg.gauge("g", **label).set(rng.uniform(-1, 1))
        else:
            reg.histogram("h", lo=1e-5, base=1.5, n_buckets=30,
                          **label).observe(math.exp(rng.gauss(-6, 3)))
    return reg.snapshot()


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_snapshot_equals_the_reference(seed):
    import repro_torch.obs as tobs
    assert drive_metrics(jobs, seed) == drive_metrics(tobs, seed)


def test_trace_json_and_quantiles_equal_the_reference():
    """The same spans on the same fake clock export the same trace-event
    JSON, and histogram quantiles over ``merge``d snapshots agree."""
    import repro_torch.obs as tobs

    def trace(pkg):
        tel = pkg.Telemetry(tracing=True, clock=TickClock(0.25), max_events=6)
        with tel.span("outer", args={"n": 1}):
            tel.instant("mark", tid=2)
            tel.add_span("inner", tel.now(), tel.now(), tid=1)
        for i in range(6):
            tel.add_span(f"s{i}", tel.now(), tel.now(), cat="engine")
        return json.dumps(tel.tracer.to_trace_json(), sort_keys=True)

    assert trace(jobs) == trace(tobs)
    vals = np.exp(np.random.default_rng(3).normal(-5.0, 2.5, size=300))

    def merged(pkg):
        ha, hb = pkg.Histogram(), pkg.Histogram()
        for i, v in enumerate(vals):
            (ha if i < 120 else hb).observe(v)
        return pkg.merge(ha.snapshot(), hb.snapshot())

    want, got = merged(jobs), merged(tobs)
    assert got == want
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert tobs.quantile_from_snapshot(got, q) == \
            jobs.quantile_from_snapshot(want, q)


@pytest.mark.parametrize("seed", [5, 17])
def test_fault_schedule_equals_the_reference(seed):
    """One plan (every rule mode) fired the same way gives the same
    schedule, log and stats in both packages: the same sites, rules and
    ``random.Random`` draws."""
    import repro_torch.obs as tobs

    def schedule(pkg):
        inj = pkg.FaultInjector([
            pkg.fail_rate("sweep.device", 0.3, seed=seed),
            pkg.fail_n("broker.flush", 2),
            pkg.fail_lane("sweep.device", "beef"),
            pkg.fail_once("cache.disk.write", kind="corrupt")])
        inj.add(pkg.fail_rate("cache.disk.read", 0.5, seed=seed + 1))
        rng, fired = random.Random(seed), []
        for _ in range(120):
            site = rng.choice(["sweep.device", "broker.flush",
                               "cache.disk.write", "cache.disk.read"])
            lanes = [rng.choice(["aa", "beef01", "cc"])]
            try:
                inj.fire(site, lanes=lanes, key=f"k{rng.randrange(4)}")
                fired.append(0)
            except pkg.InjectedFault as e:
                fired.append((e.site, e.kind, e.transient, e.matched))
        return fired, inj.log, inj.stats()

    assert schedule(jobs) == schedule(tobs)


# ---------------------------------------------------------------------------
# bitwise identity: telemetry hooks never touch the engines
# ---------------------------------------------------------------------------
JAX_TELEM_POLICIES = [
    jc.PolicyConfig(data_policy=jc.FIRST_TOUCH, pt_policy=jc.PT_FOLLOW_DATA,
                    autonuma=True, autonuma_period=16, autonuma_budget=32),
    jc.PolicyConfig(data_policy=jc.INTERLEAVE, pt_policy=jc.PT_BIND_HIGH,
                    mig=True, autonuma=True, autonuma_period=16,
                    autonuma_budget=16),
]
TELEM_POLICIES = port(JAX_TELEM_POLICIES)


def recorded(tel, drop=()):
    """What a Telemetry recorded, less the clock: the metrics snapshot with
    each ``*_seconds`` histogram cut to its count, and the spans as a
    sorted list of (name, category, track, args).  ``drop`` names metrics
    left out of the snapshot."""
    metrics = {}
    for key, val in tel.metrics.snapshot().items():
        name = key.split("{")[0]
        if name in drop:
            continue
        metrics[key] = ({"count": val["count"]} if name.endswith("_seconds")
                        else val)
    spans = sorted((e["name"], e.get("cat"), e.get("tid"),
                    json.dumps(e.get("args", {}), sort_keys=True))
                   for e in tel.tracer.events if e["ph"] == "X")
    return metrics, spans


def test_sweep_lanes_bitwise_identical_with_telemetry():
    jmc = ref.tiny_machine()
    jtrs = [ref.random_trace(jmc, seed=41, free_at=30, name="a"),
            ref.random_trace(jmc, seed=42, name="b")]
    jccs = [jc.CostConfig(), jc.CostConfig(nvmm_read=1500)]
    mc, trs, ccs = port(jmc), port(jtrs), port(jccs)
    plain = tc.sweep_lanes(mc, ccs, TELEM_POLICIES, trs, device="cpu")
    tel = Telemetry(tracing=True)
    traced = tc.sweep_lanes(mc, ccs, TELEM_POLICIES, trs, telemetry=tel,
                            device="cpu")
    for i, (p, t) in enumerate(zip(plain, traced)):
        assert_bitwise(p, t, f"lane {i}")
    m = tel.metrics
    assert m.value("sweep.calls", engine="blocked") == 1
    assert m.value("sweep.lanes", engine="blocked") == 2
    n_windows = (m.value("sweep.windows_fast")
                 + m.value("sweep.windows_event"))
    assert n_windows == 1, "64-step trace, block=64 -> one window"
    assert m.value("sweep.windows_hoist") is not None
    assert m.value("sweep.windows_split") is not None
    names = tel.tracer.span_names()
    assert names.count("sweep.prepare") == 1
    assert names.count("sweep.device") == 1
    assert sum(n.startswith("window.") for n in names) == n_windows
    assert m.value("sweep.device_seconds")["count"] == 1
    assert validate_trace_events(tel.tracer.to_trace_json()) == []
    jtel = jobs.Telemetry(tracing=True)
    jc.sweep_lanes(jmc, jccs, JAX_TELEM_POLICIES, jtrs, telemetry=jtel)
    assert recorded(tel) == recorded(jtel)
    # the per-step engine counts its steps, as the reference's does
    tel2 = Telemetry()
    tc.sweep_lanes(mc, ccs, TELEM_POLICIES, trs, engine="per_step",
                   debug=True, telemetry=tel2, device="cpu")
    assert tel2.metrics.value("sweep.steps") == 64
    assert tel2.metrics.value("sweep.calls", engine="per_step") == 1


def test_simulator_bitwise_identical_with_telemetry():
    jmc = ref.tiny_machine()
    jtr = ref.random_trace(jmc, steps=160, seed=43, free_at=100)
    mc, tr, pc = port(jmc), port(jtr), TELEM_POLICIES[1]
    plain = tc.TieredMemSimulator(mc=mc, pc=pc, device="cpu").run(tr)
    tel = Telemetry(tracing=True)
    traced = tc.TieredMemSimulator(mc=mc, pc=pc, telemetry=tel,
                                   device="cpu").run(tr)
    assert_bitwise(plain, traced, "simulator")
    m = tel.metrics
    assert m.value("sim.runs", engine="blocked") == 1
    n_windows = m.value("sim.windows_fast") + m.value("sim.windows_event")
    assert n_windows == math.ceil(160 / 64)
    names = tel.tracer.span_names()
    assert names.count("sim.run") == 1
    assert sum(n.startswith("window.") for n in names) == n_windows
    assert validate_trace_events(tel.tracer.to_trace_json()) == []
    jtel = jobs.Telemetry(tracing=True)
    jc.TieredMemSimulator(mc=jmc, pc=JAX_TELEM_POLICIES[1],
                          telemetry=jtel).run(jtr)
    assert recorded(tel) == recorded(jtel)


# ---------------------------------------------------------------------------
# the acceptance burst: 64 mixed queries, exact snapshot, loadable trace
# ---------------------------------------------------------------------------
def burst_machine():
    return tc.MachineConfig(n_threads=4, dram_pages_per_node=280,
                            nvmm_pages_per_node=1120, va_pages=1 << 10,
                            l1_tlb_sets=4, l1_tlb_ways=2, stlb_sets=8,
                            stlb_ways=4, pde_pwc_entries=4,
                            pdpte_pwc_entries=2)


def test_64_query_burst_snapshot_and_trace(tmp_path):
    mc = burst_machine()
    policies = [tc.PolicyConfig(data_policy=d, pt_policy=p, autonuma=False)
                for d in (tc.FIRST_TOUCH, tc.INTERLEAVE)
                for p in (tc.PT_FOLLOW_DATA, tc.PT_BIND_HIGH)]
    traces = [random_trace(mc, steps=96, seed=300 + i, name=f"b{i}")
              for i in range(16)]
    queries = [SimQuery(trace=tr, policy=pc, machine=mc)
               for tr in traces for pc in policies]
    assert len(queries) == 64
    tel = Telemetry(tracing=True)
    broker = SimBroker(max_lanes=64, telemetry=tel)
    before = tc.sweep_compile_count()
    broker.run(queries)
    assert tc.sweep_compile_count() == before + 1

    bkey = broker._bucket_key(queries[0], broker.canonical_trace(queries[0]))
    blabel = _bucket_label(bkey)
    m = tel.metrics
    assert m.value("broker.queries") == 64
    assert m.value("broker.compiles", bucket=blabel) == 1
    assert m.value("broker.flushes", bucket=blabel) == 1
    assert m.value("broker.lanes_run", bucket=blabel) == 64
    assert m.value("broker.pad_lanes", bucket=blabel) == 0
    assert m.value("broker.cache_hits") is None
    assert m.value("cache.mem.misses") == 64
    assert m.value("broker.queue_wait_seconds")["count"] == 64
    assert m.value("broker.flush_seconds")["count"] == 1
    assert m.value("sweep.lanes", engine="blocked") == 64
    assert m.value("sim.promotions", family="autonuma") == 0
    assert m.value("sim.data_pages", tier=0) is not None

    broker.run(queries)
    assert m.value("broker.queries") == 128
    assert m.value("broker.cache_hits") == 64
    assert m.value("cache.mem.hits") == 64
    assert m.value("broker.lanes_run", bucket=blabel) == 64
    assert m.value("broker.compiles", bucket=blabel) == 1

    snap = broker.snapshot()
    assert snap["broker"]["queries"] == 128
    assert snap["broker"]["compiles"] == 1
    assert snap["broker"]["lanes_run"] == 64
    assert snap["broker"]["pad_lanes"] == 0
    assert snap["broker"]["pad_ratio"] == 0.0
    assert snap["broker"]["cache_hits"] == 64
    assert snap["cache"]["hits"] == 64 and snap["cache"]["misses"] == 64
    assert snap["pending_lanes"] == 0
    assert snap["telemetry"]["metrics"][
        f"broker.compiles{{bucket={blabel}}}"] == 1

    names = tel.tracer.span_names()
    assert names.count("query.admit") == 128
    assert names.count("query.queue") == 64
    assert names.count("bucket.flush") == 1
    assert names.count("sweep.device") == 1
    assert names.count("query.resolve") == 1
    assert sum(n.startswith("window.") for n in names) >= 1
    admits = [e for e in tel.tracer.events
              if e.get("name") == "query.admit" and e["ph"] == "X"]
    assert sum(e["args"]["cache_hit"] for e in admits) == 64

    path = tmp_path / "burst_trace.json"
    assert tel.export_trace(path)
    obj = json.loads(path.read_text())
    assert validate_trace_events(obj) == []
    assert validate_cli.main([str(path)]) == 0


def test_burst_telemetry_equals_the_reference():
    """A burst of 16 queries (4 traces x 4 policies, one bucket), then the
    same burst from the cache, through the port's broker and the JAX
    package's, each with tracing on: the same metrics snapshot and the
    same spans.  ``broker.compiles`` is left out: each package counts its
    own process's compile cache, which the tests before this one in the
    worker may have filled.  The machine is one no other test uses, so
    the JAX burst leaves the reference's compile counts to their tests."""
    jmc = jc.MachineConfig(n_threads=4, dram_pages_per_node=264,
                           nvmm_pages_per_node=1056, va_pages=1 << 10,
                           l1_tlb_sets=4, l1_tlb_ways=2, stlb_sets=8,
                           stlb_ways=4, pde_pwc_entries=4,
                           pdpte_pwc_entries=2)
    jqueries = [js.SimQuery(trace=ref.random_trace(jmc, steps=96,
                                                   seed=500 + i,
                                                   name=f"c{i}"),
                            policy=jc.PolicyConfig(data_policy=d,
                                                   pt_policy=p,
                                                   autonuma=False),
                            machine=jmc)
                for i in range(4)
                for d in (jc.FIRST_TOUCH, jc.INTERLEAVE)
                for p in (jc.PT_FOLLOW_DATA, jc.PT_BIND_HIGH)]

    def burst(telemetry_cls, broker_cls, queries):
        tel = telemetry_cls(tracing=True)
        b = broker_cls(max_lanes=16, telemetry=tel)
        b.run(queries)
        b.run(queries)
        assert b.stats.cache_hits == 16 and b.stats.lanes_run == 16
        return recorded(tel, drop=("broker.compiles",))

    got = burst(Telemetry, SimBroker, port(jqueries))
    assert got == burst(jobs.Telemetry, js.SimBroker, jqueries)
    names = [span[0] for span in got[1]]
    assert names.count("query.admit") == 32
    assert names.count("bucket.flush") == 1
    assert got[0]["broker.queries"] == 32


def test_burst_pad_lanes_ratio_counted():
    mc = burst_machine()
    tr = random_trace(mc, steps=96, seed=400)
    tel = Telemetry()
    broker = SimBroker(max_lanes=64, max_wait=1e9, telemetry=tel)
    futs = [broker.submit(SimQuery(trace=tr, policy=pc, machine=mc))
            for pc in [tc.PolicyConfig(data_policy=d, autonuma=False)
                       for d in (tc.FIRST_TOUCH, tc.INTERLEAVE)]
            + [tc.PolicyConfig(pt_policy=tc.PT_BIND_HIGH, autonuma=False)]]
    futs[0].result()
    assert broker.stats.pad_lanes == 1 and broker.stats.pad_ratio == 0.25
    bkey = broker._bucket_key(futs[0].query,
                              broker.canonical_trace(futs[0].query))
    assert tel.metrics.value("broker.pad_lanes",
                             bucket=_bucket_label(bkey)) == 1


# ---------------------------------------------------------------------------
# BenchRecord schema + history (twins of tests/test_report.py)
# ---------------------------------------------------------------------------
def test_make_record_is_schema_valid():
    rec = make_record(
        driver="demo", quick=True, run_id=3, wall_seconds=1.5,
        payload={"a": {"b": 2.0, "ok": True, "name": "skipme",
                       "pair": [1, 2]},
                 "snapshot": {"not": "a metric"}},
        figures=[("demo/x", 0.25, "speedup=2x")],
        clock=lambda: 1700000000.0)
    assert validate_record(rec) == []
    assert rec["metrics"] == {"a.b": 2.0, "a.ok": 1.0,
                              "a.pair.0": 1.0, "a.pair.1": 2.0}
    assert rec["figures"] == [["demo/x", 0.25, "speedup=2x"]]
    fp = rec["fingerprint"]
    assert fp["device_platform"] and fp["torch"] and fp["python"]
    assert "jax" not in fp
    assert rec["namespace"] == namespace_of(fp)


def test_fingerprint_namespaces():
    """Without CUDA the port's namespace is ``cpu``; a card's is
    ``gpu:<its name, slugged>``."""
    assert namespace_of(bench_mod.fingerprint()) in ("cpu",) or \
        namespace_of(bench_mod.fingerprint()).startswith("gpu:")
    assert namespace_of({"device_platform": "gpu",
                         "device_kind": "NVIDIA H100 80GB HBM3"}) == \
        "gpu:nvidia-h100-80gb-hbm3"
    assert namespace_of({"device_platform": "cpu"}) == "cpu"
    assert bench_mod.DEFAULT_HISTORY.parts[-3:-1] != ("artifacts", "bench")


def test_validate_record_rejects():
    assert validate_record([]) == ["record is not an object"]
    rec = make_record(driver="demo", run_id=0)
    bad = dict(rec, schema="nope", run_id=-1)
    problems = "\n".join(validate_record(bad))
    assert "schema" in problems and "negative" in problems
    bad = dict(rec, metrics={"x": "not-a-number"})
    assert any("numeric" in p for p in validate_record(bad))


def test_flatten_metrics_skips_non_scalars():
    flat = flatten_metrics({
        "inf": float("inf"), "nan": float("nan"), "s": "str",
        "long": list(range(100)), "deep": {"v": 4},
        "telemetry": {"hidden": 1}, "n": 7})
    assert flat == {"deep.v": 4.0, "n": 7.0}


def test_history_roundtrip_and_monotonic_run_id(tmp_path):
    hist = tmp_path / "history.jsonl"
    assert next_run_id(hist) == 0
    for i in range(3):
        append_record(make_record(driver="d", run_id=i,
                                  payload={"m": i}), hist)
    records, problems = load_history(hist)
    assert problems == [] and len(records) == 3
    assert [r["metrics"]["m"] for r in records] == [0.0, 1.0, 2.0]
    assert next_run_id(hist) == 3
    with open(hist, "a") as fh:
        fh.write("{broken\n")
    _, problems = load_history(hist)
    assert any("unparseable" in p for p in problems)
    # the default history is the redirected one, under tmp_path
    append_record(make_record(driver="d", run_id=9))
    assert bench_mod.DEFAULT_HISTORY.is_relative_to(tmp_path)
    assert next_run_id() == 10


def test_validator_rejects_duplicate_run_id_per_driver(tmp_path, capsys):
    hist = tmp_path / "history.jsonl"
    rec_a = make_record(driver="steady_state", run_id=0, payload={"m": 1})
    rec_b = make_record(driver="fault_batch", run_id=0, payload={"m": 2})
    append_record(rec_a, hist)
    append_record(rec_b, hist)
    assert validate_cli.main([str(hist)]) == 0
    capsys.readouterr()
    append_record(rec_a, hist)
    assert validate_cli.main([str(hist)]) == 1
    err = capsys.readouterr().err
    assert "duplicate record for run_id=0 driver='steady_state'" in err
    assert "first at line 1" in err


# ---------------------------------------------------------------------------
# the regression gate
# ---------------------------------------------------------------------------
def _history_of(tmp_path, values, driver="steady_state",
                payload_of=lambda v: {"steady": {"8lane": {"speedup": v}}}):
    hist = tmp_path / "history.jsonl"
    for i, v in enumerate(values):
        append_record(make_record(driver=driver, payload=payload_of(v),
                                  run_id=i, clock=lambda t=i: 1000.0 + t),
                      hist)
    return hist


def _baselines_of(tmp_path, entries, ns=None):
    ns = ns or namespace_of(bench_mod.fingerprint())
    path = tmp_path / "baselines.json"
    path.write_text(json.dumps({
        "schema": "bench-baselines/v1",
        "namespaces": {ns: {"entries": entries}}}))
    return path


def test_seeded_30pct_regression_fails_and_names_metric(tmp_path, capsys):
    hist = _history_of(tmp_path, [6.0, 6.1, 4.2, 4.2, 4.2])
    base = _baselines_of(tmp_path, [
        {"driver": "steady_state", "metric": "steady.8lane.speedup",
         "kind": "best", "value": 6.0, "rel_tol": 0.15, "min_of_n": 3}])
    rc = report_mod.main(["--check", "--history", str(hist),
                          "--baselines", str(base)])
    assert rc == 1
    err = capsys.readouterr().err
    assert "REGRESSION" in err and "steady.8lane.speedup" in err


def test_min_of_n_damps_single_noisy_dip(tmp_path):
    hist = _history_of(tmp_path, [6.0, 3.0, 5.9])
    base = _baselines_of(tmp_path, [
        {"driver": "steady_state", "metric": "steady.8lane.speedup",
         "kind": "best", "value": 6.0, "rel_tol": 0.15, "min_of_n": 3}])
    assert report_mod.main(["--check", "--history", str(hist),
                            "--baselines", str(base)]) == 0


def test_min_max_kinds_judge_latest_sample(tmp_path, capsys):
    hist = _history_of(tmp_path, [6.0, 1.1])
    base = _baselines_of(tmp_path, [
        {"driver": "steady_state", "metric": "steady.8lane.speedup",
         "kind": "min", "value": 2.0}])
    assert report_mod.main(["--check", "--history", str(hist),
                            "--baselines", str(base)]) == 1
    capsys.readouterr()
    hist2 = _history_of(tmp_path, [0.0, 0.0], driver="chaos",
                        payload_of=lambda v: {"gates": {"stranded": v}})
    base2 = _baselines_of(tmp_path, [
        {"driver": "chaos", "metric": "gates.stranded",
         "kind": "max", "value": 0}])
    assert report_mod.main(["--check", "--history", str(hist2),
                            "--baselines", str(base2)]) == 0


def test_missing_history_sample_is_a_failure(tmp_path, capsys):
    hist = _history_of(tmp_path, [6.0])
    base = _baselines_of(tmp_path, [
        {"driver": "steady_state", "metric": "no.such.metric",
         "kind": "min", "value": 1.0}])
    assert report_mod.main(["--check", "--history", str(hist),
                            "--baselines", str(base)]) == 1
    assert "no history sample" in capsys.readouterr().err


def test_update_baselines_ratchets_best_entries(tmp_path):
    hist = _history_of(tmp_path, [6.0, 7.5, 7.0])
    base = _baselines_of(tmp_path, [
        {"driver": "steady_state", "metric": "steady.8lane.speedup",
         "kind": "best", "value": 6.0, "rel_tol": 0.2, "min_of_n": 3},
        {"driver": "steady_state", "metric": "steady.8lane.speedup",
         "kind": "min", "value": 2.0}])
    assert report_mod.main(["--history", str(hist), "--baselines",
                            str(base), "--update-baselines"]) == 0
    obj = json.loads(base.read_text())
    entries = next(iter(obj["namespaces"].values()))["entries"]
    assert [e for e in entries if e["kind"] == "best"][0]["value"] == 7.5
    assert [e for e in entries if e["kind"] == "min"][0]["value"] == 2.0


def test_green_path_on_synthetic_history(tmp_path, capsys):
    """The port has no committed history: a synthetic one (two drivers,
    four runs, a flush-latency snapshot) written to the default paths,
    which the test redirects under ``tmp_path``, passes the gate through
    the CLI's defaults, and the report renders its gate, trajectory and
    flush-latency sections."""
    h = Histogram()
    for v in (0.002, 0.004, 0.03):
        h.observe(v)
    for run in range(4):
        append_record(make_record(
            driver="service_throughput", run_id=run,
            payload={"broker": {"qps": 10.0 + run}, "gates": {"stranded": 0}},
            snapshot={"broker.flush_seconds": h.snapshot(),
                      "broker.compiles": 1 + run % 2}))
        append_record(make_record(driver="steady_state", run_id=run,
                                  payload={"speedup": 2.5 + 0.1 * run}))
    records, problems = load_history()
    assert problems == [] and len(records) == 8
    base = report_mod.DEFAULT_BASELINES
    base.write_text(json.dumps({
        "schema": "bench-baselines/v1",
        "namespaces": {namespace_of(bench_mod.fingerprint()): {"entries": [
            {"driver": "service_throughput", "metric": "broker.qps",
             "kind": "best", "value": 13.0, "rel_tol": 0.1},
            {"driver": "service_throughput", "metric": "gates.stranded",
             "kind": "max", "value": 0},
            {"driver": "steady_state", "metric": "speedup",
             "kind": "min", "value": 2.0}]}}}))
    assert report_mod.main(["--check"]) == 0
    out = capsys.readouterr().out
    assert "regression gate ok: 3 baseline checks passed" in out
    checks = report_mod.check(records, report_mod.load_baselines())
    report = report_mod.render_report(records, report_mod.load_baselines(),
                                      checks)
    assert all(c["ok"] for c in checks)
    assert "## Regression gate" in report
    assert "## Driver trajectory" in report
    assert "## Broker flush latency" in report
    assert "## Top compile/pad movers" in report
    assert "FAIL" not in report and "torch " in report


# ---------------------------------------------------------------------------
# Histogram.quantile + merge
# ---------------------------------------------------------------------------
def test_quantile_empty_and_bounds():
    h = Histogram()
    assert h.quantile(0.5) is None
    h.observe(0.003)
    assert h.quantile(0.0) == pytest.approx(0.003)
    assert h.quantile(1.0) == pytest.approx(0.003)
    with pytest.raises(ValueError):
        h.quantile(1.5)


def test_merge_rejects_mismatched_geometry():
    a, b = Histogram(lo=1e-6), Histogram(lo=1e-3)
    a.observe(0.5)
    b.observe(0.5)
    with pytest.raises(ValueError, match="lo"):
        merge(a.snapshot(), b.snapshot())


def test_merge_then_quantile_equals_observe_all_then_quantile():
    rng = np.random.default_rng(7)
    for trial in range(12):
        n = int(rng.integers(2, 400))
        vals = np.exp(rng.normal(loc=-5.0, scale=2.5, size=n))
        split = int(rng.integers(0, n + 1))
        h_all, h_a, h_b = Histogram(), Histogram(), Histogram()
        for i, v in enumerate(vals):
            h_all.observe(v)
            (h_a if i < split else h_b).observe(v)
        merged = merge(h_a.snapshot(), h_b.snapshot())
        assert merged["count"] == h_all.count
        assert merged["buckets"] == h_all.snapshot()["buckets"]
        for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
            qm = quantile_from_snapshot(merged, q)
            qa = h_all.quantile(q)
            assert qm == pytest.approx(qa, rel=1e-12), (trial, q)
            rank = min(max(int(np.ceil(q * n)), 1), n)
            emp = float(np.sort(vals)[rank - 1])
            assert abs(h_all.bucket_of(qa) - h_all.bucket_of(emp)) <= 1, \
                (trial, q, qa, emp)


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------
def test_flight_recorder_dump_contents(tmp_path):
    tel = Telemetry(tracing=True)
    fl = FlightRecorder(tel, tmp_path / "pm", clock=lambda: 1700000000.0)
    tel.counter("work.done").inc(5)
    with tel.span("step.one"):
        pass
    err = PoisonedQueryError("d3adb33f")
    path = fl.dump("unit.site", error=err, state={"extra": 1})
    obj = json.loads(path.read_text())
    assert validate_postmortem(obj) == []
    assert obj["site"] == "unit.site"
    assert obj["error"]["type"] == "PoisonedQueryError"
    assert obj["error"]["digest"] == "d3adb33f"
    assert [e["name"] for e in obj["spans"]] == ["step.one"]
    assert obj["metrics_delta"]["work.done"] == 5
    assert obj["state"] == {"extra": 1}
    path2 = fl.dump("unit.site")
    assert path2 != path
    assert json.loads(path2.read_text())["metrics_delta"] == {}


def test_broker_poison_produces_postmortem(tmp_path):
    """A persistently poisoned lane through a real (tiny, CPU) broker
    dumps a schema-valid postmortem; the innocent lane == its solo run."""
    mc = tiny_machine()
    tel = Telemetry(tracing=True)
    q_bad = SimQuery(trace=random_trace(mc, seed=1),
                     policy=MIXED_POLICIES[0], machine=mc)
    q_ok = SimQuery(trace=random_trace(mc, seed=2, name="ok"),
                    policy=MIXED_POLICIES[0], machine=mc)
    digest = SimBroker(pad_steps_floor=1).query_digest(q_bad)
    injector = FaultInjector(
        [fail_lane("sweep.device", digest, transient=False)])
    flight = FlightRecorder(tel, tmp_path / "pm")
    broker = SimBroker(max_lanes=2, telemetry=tel, injector=injector,
                       flight=flight, pad_steps_floor=1, sleep=lambda s: None)
    f_bad, f_ok = broker.submit_many([q_bad, q_ok])
    broker.drain()
    with pytest.raises(PoisonedQueryError) as ei:
        f_bad.result()
    assert isinstance(ei.value.__cause__, InjectedFault)
    assert_bitwise(f_ok.result(), tc.TieredMemSimulator(
        mc=mc, pc=q_ok.policy, device="cpu").run(q_ok.trace), "innocent")
    assert len(flight.dumps) == 1
    obj = json.loads(flight.dumps[0].read_text())
    assert validate_postmortem(obj) == []
    assert obj["site"] == "broker.poison"
    assert obj["error"]["digest"] == digest
    assert len(obj["spans"]) >= 1
    assert obj["metrics_delta"]
    assert digest in obj["state"]["quarantine"]
    assert obj["state"]["stats"]["quarantined"] == 1
    assert validate_cli.main([str(flight.dumps[0])]) == 0


def test_flight_dump_failure_never_breaks_settlement(tmp_path):
    mc = tiny_machine()
    q = SimQuery(trace=random_trace(mc, seed=3),
                 policy=MIXED_POLICIES[0], machine=mc)
    injector = FaultInjector([fail_lane(
        "sweep.device", SimBroker(pad_steps_floor=1).query_digest(q),
        transient=False)])

    class Exploding:
        def dump(self, *a, **kw):
            raise OSError("disk full")

    tel = Telemetry()
    broker = SimBroker(max_lanes=2, telemetry=tel, injector=injector,
                       flight=Exploding(), pad_steps_floor=1,
                       sleep=lambda s: None)
    fut = broker.submit(q)
    broker.drain()
    with pytest.raises(PoisonedQueryError):
        fut.result()
    assert tel.metrics.value("broker.flight_errors") == 1


# ---------------------------------------------------------------------------
# validator extensions
# ---------------------------------------------------------------------------
def _span(name, ts, dur, tid=0, pid=0):
    return {"name": name, "cat": "t", "ph": "X", "ts": ts, "dur": dur,
            "pid": pid, "tid": tid}


def test_validator_rejects_partial_overlap_same_track():
    obj = {"traceEvents": [_span("a", 0, 10), _span("b", 5, 10)]}
    assert any("partially overlaps" in p for p in validate_trace_events(obj))


def test_validator_allows_nesting_and_cross_track_overlap():
    obj = {"traceEvents": [
        _span("outer", 0, 100),
        _span("inner", 10, 20),
        _span("inner2", 30, 70),
        _span("tail-aligned", 60, 40),
        _span("other-track", 5, 200, tid=1),
        _span("next", 101, 10),
    ]}
    assert validate_trace_events(obj) == []


def test_validator_rejects_non_monotonic_be_track():
    obj = {"traceEvents": [
        _span("x", 0, 1),
        {"name": "a", "cat": "t", "ph": "B", "ts": 10, "pid": 0, "tid": 0},
        {"ph": "E", "ts": 5, "pid": 0, "tid": 0},
    ]}
    assert any("non-monotonic" in p for p in validate_trace_events(obj))


def test_validate_cli_is_schema_aware(tmp_path, capsys):
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"traceEvents": [_span("a", 0, 1)]}))
    hist = tmp_path / "history.jsonl"
    append_record(make_record(driver="d", run_id=0), hist)
    tel = Telemetry(tracing=True)
    with tel.span("s"):
        pass
    pm = FlightRecorder(tel, tmp_path).dump("cli.site")
    assert validate_cli.main([str(trace), str(hist), str(pm)]) == 0
    out = capsys.readouterr().out
    assert "1 bench records" in out and "postmortem at cli.site" in out
    with open(hist, "a") as fh:
        fh.write(json.dumps({"schema": "bench-record/v1"}) + "\n")
    assert validate_cli.main([str(hist)]) == 1
    assert "line 2" in capsys.readouterr().err
    assert validate_cli.main([str(tmp_path / "nope.json")]) == 1


def test_public_names_equal_the_reference():
    """``repro_torch.obs`` exports the reference's names, one for one."""
    import repro_torch.obs as tobs
    assert tobs.__all__ == jobs.__all__
    assert all(hasattr(tobs, n) for n in tobs.__all__)
    assert fail_n is tobs.fail_n and fail_once is tobs.fail_once
    assert fail_rate is tobs.fail_rate
