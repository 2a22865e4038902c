"""The telemetry facade: one object the whole service stack reports into
(twin of the JAX package's ``obs/telemetry.py``).

``Telemetry`` bundles a :class:`~repro_torch.obs.metrics.MetricsRegistry`
(always on — counters are a few attribute ops) with an optional
:class:`~repro_torch.obs.tracing.SpanRecorder` (``tracing=True``), and
``snapshot()`` renders everything as one flat JSON-friendly dict — the
blessed replacement for ad-hoc ``BrokerStats.as_dict`` readouts in
benchmark artifacts.

``NULL`` is the near-zero-cost default: a :class:`NullTelemetry` whose
``counter/gauge/histogram`` return shared no-op twins and whose ``span``
is a reusable no-op context manager.  Instrumented code holds exactly
one pattern::

    tel = telemetry if telemetry is not None else NULL
    tel.counter("broker.queries").inc()
    with tel.span("bucket.sweep", args={...}):
        ...

so the off path costs one attribute load and one no-op call per site —
and, because every hook is host-side Python that reads no device value,
the engines are bitwise-identical with telemetry on or off
(``tests/test_torch_obs.py`` asserts the blocked engine's outputs
exactly).
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List, Optional

from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .tracing import SpanRecorder


class Telemetry:
    """Live metrics registry + optional span recorder."""

    def __init__(self, tracing: bool = False, clock=time.monotonic,
                 max_events: int = 200_000):
        self.metrics = MetricsRegistry()
        self.tracer: Optional[SpanRecorder] = (
            SpanRecorder(clock=clock, max_events=max_events)
            if tracing else None)

    # -------------------------------------------------------- metrics --
    @property
    def enabled(self) -> bool:
        return True

    @property
    def tracing(self) -> bool:
        return self.tracer is not None

    def counter(self, name: str, **labels) -> Counter:
        return self.metrics.counter(name, **labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self.metrics.gauge(name, **labels)

    def histogram(self, name: str, **kw) -> Histogram:
        return self.metrics.histogram(name, **kw)

    # -------------------------------------------------------- tracing --
    def span(self, name: str, cat: str = "service", tid: int = 0,
             args: Optional[Dict] = None):
        if self.tracer is None:
            return _NULL_CTX
        return self.tracer.span(name, cat=cat, tid=tid, args=args)

    def add_span(self, name: str, begin: float, end: float,
                 cat: str = "service", tid: int = 0,
                 args: Optional[Dict] = None) -> None:
        if self.tracer is not None:
            self.tracer.add_span(name, begin, end, cat=cat, tid=tid,
                                 args=args)

    def instant(self, name: str, cat: str = "service", tid: int = 0,
                args: Optional[Dict] = None) -> None:
        if self.tracer is not None:
            self.tracer.instant(name, cat=cat, tid=tid, args=args)

    def now(self) -> Optional[float]:
        """Tracer-clock seconds for explicit add_span bounds (None when
        tracing is off — pair with ``add_span``, which no-ops then)."""
        return None if self.tracer is None else self.tracer.now()

    # -------------------------------------------------------- results --
    def snapshot(self) -> Dict[str, object]:
        """Everything the stack reported, one JSON-friendly dict."""
        out = {"metrics": self.metrics.snapshot()}
        if self.tracer is not None:
            out["trace"] = {"events": len(self.tracer.events),
                            "dropped": self.tracer.dropped}
        return out

    def export_trace(self, path) -> bool:
        """Write the Perfetto trace JSON; False when tracing is off."""
        if self.tracer is None:
            return False
        self.tracer.export(path)
        return True

    def reset(self) -> None:
        self.metrics.reset()
        if self.tracer is not None:
            self.tracer.reset()


# ---------------------------------------------------------------------------
# The no-op default.  Shared singletons: no allocation on the off path.
# ---------------------------------------------------------------------------
class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()


class _NullMetric:
    """Counter/gauge/histogram twin that absorbs every write."""

    __slots__ = ()
    value = 0
    count = 0
    total = 0.0

    def inc(self, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass

    def snapshot(self):
        return 0


_NULL_METRIC = _NullMetric()


class NullTelemetry(Telemetry):
    """The near-zero-cost off switch; API-compatible with Telemetry."""

    def __init__(self):  # no registry, no tracer
        pass

    @property
    def enabled(self) -> bool:
        return False

    @property
    def tracing(self) -> bool:
        return False

    tracer = None
    metrics = None

    def counter(self, name: str, **labels):
        return _NULL_METRIC

    def gauge(self, name: str, **labels):
        return _NULL_METRIC

    def histogram(self, name: str, **kw):
        return _NULL_METRIC

    def span(self, name: str, cat: str = "service", tid: int = 0,
             args: Optional[Dict] = None):
        return _NULL_CTX

    def add_span(self, *a, **kw):
        pass

    def instant(self, *a, **kw):
        pass

    def now(self):
        return None

    def snapshot(self) -> Dict[str, object]:
        return {"metrics": {}}

    def export_trace(self, path) -> bool:
        return False

    def reset(self) -> None:
        pass


NULL = NullTelemetry()


def or_null(telemetry: Optional[Telemetry]) -> Telemetry:
    """The one canonicalization every instrumented call site uses."""
    return telemetry if telemetry is not None else NULL


# ---------------------------------------------------------------------------
# The failure flight recorder.
# ---------------------------------------------------------------------------
POSTMORTEM_SCHEMA = "postmortem/v1"


class FlightRecorder:
    """A black box for persistent service failures.

    Rides alongside a :class:`Telemetry`: when the broker confirms a
    poisoned lane, trips a circuit breaker or abandons a livelocked
    bucket, it calls :meth:`dump`, which writes a self-contained
    postmortem JSON to ``<out_dir>/<ts>_<site>.json`` containing

      * the bounded ring of recently *completed* spans (the tracer's
        ``recent`` deque — newest events survive even after the main
        event list saturates),
      * a metrics **delta** since the last mark (construction or the
        previous dump): every counter/gauge that moved, histograms by
        their observation count,
      * the caller-supplied ``state`` dict (the broker passes its stats,
        quarantine digests, degraded buckets and injector totals) and
        the typed error (with its lane digest when it carries one).

    So a chaos failure in CI arrives with its own story instead of a
    bare counter.  Dumps are best-effort by contract: callers wrap them
    so a postmortem write can never take down the service path itself.
    """

    def __init__(self, telemetry, out_dir, max_spans: int = 64,
                 clock=time.time):
        self.telemetry = or_null(telemetry)
        self.out_dir = Path(out_dir)
        self.max_spans = int(max_spans)
        self.clock = clock
        self.dumps: List[Path] = []
        self._baseline = self._numeric_metrics()

    def _numeric_metrics(self) -> Dict[str, float]:
        if not self.telemetry.enabled:
            return {}
        out: Dict[str, float] = {}
        for k, v in self.telemetry.metrics.snapshot().items():
            if isinstance(v, dict):             # histogram -> obs count
                v = v.get("count", 0)
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            out[k] = float(v)
        return out

    def mark(self) -> None:
        """Reset the metrics-delta baseline (done after every dump)."""
        self._baseline = self._numeric_metrics()

    def metrics_delta(self) -> Dict[str, float]:
        now = self._numeric_metrics()
        delta = {k: v - self._baseline.get(k, 0.0)
                 for k, v in now.items() if v != self._baseline.get(k, 0.0)}
        return delta

    def recent_spans(self) -> List[dict]:
        tr = self.telemetry.tracer
        if tr is None:
            return []
        ring = getattr(tr, "recent", None)
        events = list(ring) if ring is not None else list(tr.events)
        return [e for e in events if e.get("ph") == "X"][-self.max_spans:]

    def dump(self, site: str, error: Optional[BaseException] = None,
             state: Optional[Dict] = None) -> Path:
        ts = float(self.clock())
        obj: Dict[str, object] = {
            "schema": POSTMORTEM_SCHEMA,
            "ts": ts,
            "time": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(ts)),
            "site": str(site),
            "spans": self.recent_spans(),
            "metrics_delta": self.metrics_delta(),
            "state": state or {},
        }
        if error is not None:
            err: Dict[str, object] = {"type": type(error).__name__,
                                      "message": str(error)}
            digest = getattr(error, "digest", None)
            if digest is not None:
                err["digest"] = digest
            if error.__cause__ is not None:
                err["cause"] = (f"{type(error.__cause__).__name__}: "
                                f"{error.__cause__}")
            obj["error"] = err
        self.out_dir.mkdir(parents=True, exist_ok=True)
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime(ts))
        slug = "".join(c if c.isalnum() or c in "._-" else "-"
                       for c in str(site))
        path = self.out_dir / f"{stamp}_{slug}.json"
        n = 1
        while path.exists():                    # same-second collisions
            path = self.out_dir / f"{stamp}_{slug}.{n}.json"
            n += 1
        path.write_text(json.dumps(obj, indent=1, default=float))
        self.dumps.append(path)
        self.mark()
        return path


def validate_postmortem(obj) -> List[str]:
    """Schema check for one postmortem JSON; returns problems."""
    problems: List[str] = []
    if not isinstance(obj, dict):
        return ["postmortem is not an object"]
    if obj.get("schema") != POSTMORTEM_SCHEMA:
        problems.append(f"schema is {obj.get('schema')!r}, "
                        f"expected {POSTMORTEM_SCHEMA!r}")
    for field, kind in (("ts", (int, float)), ("time", str),
                        ("site", str), ("spans", list),
                        ("metrics_delta", dict), ("state", dict)):
        if not isinstance(obj.get(field), kind):
            problems.append(f"field {field!r} missing or not "
                            f"{getattr(kind, '__name__', kind)}")
    if isinstance(obj.get("spans"), list):
        for i, e in enumerate(obj["spans"]):
            if not isinstance(e, dict) or e.get("ph") != "X" \
                    or not isinstance(e.get("name"), str):
                problems.append(f"spans[{i}] is not a complete (X) span")
                break
    err = obj.get("error")
    if err is not None and (not isinstance(err, dict)
                            or not isinstance(err.get("type"), str)):
        problems.append("error present but malformed (needs type/message)")
    return problems
