"""The metrics registry: counters, gauges, log-bucket histograms (twin of
the JAX package's ``obs/metrics.py``, the same semantics line for line).

The service stack attributes *simulated* cycles obsessively (per-level
walk latency, migration overhead — the paper's whole argument) but until
this module it could not attribute its *own* time: ``BrokerStats`` was
six bare counters and a slow flush or a compile storm was invisible
until a CI perf bar tripped.  This registry is the substrate every
service layer reports into — the broker (queue-wait and flush-latency
histograms, per-bucket compile counts), the result cache
(hit/miss/evict/spill), the sweep engine (fast vs event windows, device
seconds) and the benchmark drivers (which embed ``snapshot()`` in their
committed artifacts so CI perf numbers carry their own explanation).

Design constraints, in order:

  * **host-side only** — nothing here ever touches a device tensor; the
    engines are bitwise-identical with telemetry on or off (asserted in
    ``tests/test_torch_obs.py``);
  * **near-zero cost when off** — the no-op twins in ``telemetry.py``
    reduce every call site to one attribute load and one no-op call;
  * **stable snapshots** — ``snapshot()`` emits a flat, JSON-friendly
    dict (``name`` or ``name{label=value,...}`` keys, sorted labels) so
    artifacts diff cleanly across runs.

Histograms use fixed log-scale buckets (powers of ``base`` from
``lo`` up to ``hi``): latencies span orders of magnitude, and fixed
boundaries mean two snapshots are mergeable bucket-by-bucket — the
property the ROADMAP's fleet-wide metrics item needs.
"""
from __future__ import annotations

import json
import math
from typing import Dict, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt(name: str, labels: LabelKey) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonically increasing value (events, lanes, compiles)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """Last-written value (queue depth, pages-per-tier)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def set(self, v) -> None:
        self.value = v

    def inc(self, n=1) -> None:
        self.value += n

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed log-scale buckets: bucket i counts observations in
    ``(lo * base**(i-1), lo * base**i]``, with underflow in bucket 0 and
    overflow in the last bucket.  Fixed boundaries (never rescaled on
    observe) keep histograms mergeable across snapshots and processes.
    """

    __slots__ = ("lo", "base", "n_buckets", "buckets", "count", "total",
                 "min", "max")

    def __init__(self, lo: float = 1e-6, base: float = 2.0,
                 n_buckets: int = 40):
        if lo <= 0 or base <= 1 or n_buckets < 2:
            raise ValueError("need lo > 0, base > 1, n_buckets >= 2")
        self.lo = float(lo)
        self.base = float(base)
        self.n_buckets = int(n_buckets)
        self.buckets = [0] * self.n_buckets
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def bucket_of(self, v: float) -> int:
        if v <= self.lo:
            return 0
        i = int(math.ceil(math.log(v / self.lo) / math.log(self.base)))
        return min(max(i, 0), self.n_buckets - 1)

    def bucket_le(self, i: int) -> float:
        """Inclusive upper bound of bucket ``i`` (inf for the overflow)."""
        if i >= self.n_buckets - 1:
            return math.inf
        return self.lo * self.base ** i

    def observe(self, v) -> None:
        v = float(v)
        self.buckets[self.bucket_of(v)] += 1
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def snapshot(self):
        out = {"count": self.count, "sum": self.total}
        if self.count:
            out["min"] = self.min
            out["max"] = self.max
            out["mean"] = self.total / self.count
            # bucket geometry rides along so quantile_from_snapshot /
            # merge can reconstruct edges from the snapshot alone (only
            # when non-empty: the empty shape is pinned by tests and
            # carries no information)
            out["lo"] = self.lo
            out["base"] = self.base
        # sparse: only non-empty buckets, keyed by their upper bound
        out["buckets"] = {
            ("inf" if math.isinf(self.bucket_le(i)) else
             f"{self.bucket_le(i):.9g}"): n
            for i, n in enumerate(self.buckets) if n}
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (0 <= q <= 1) by log-bucket
        interpolation; exact to within one bucket width.  None when
        empty."""
        return quantile_from_snapshot(self.snapshot(), q)


def merge(snapshot_a: Dict[str, object],
          snapshot_b: Dict[str, object]) -> Dict[str, object]:
    """Merge two Histogram snapshots bucket-by-bucket.

    Fixed boundaries make this exact: the merged snapshot is identical
    (up to float summation) to observing both streams into one
    histogram — the property the ROADMAP's fleet-wide metrics item
    needs, and what the report uses to aggregate per-driver latency
    histograms across history records.
    """
    if not snapshot_a.get("count"):
        return json.loads(json.dumps(snapshot_b))
    if not snapshot_b.get("count"):
        return json.loads(json.dumps(snapshot_a))
    for field in ("lo", "base"):
        av, bv = snapshot_a.get(field), snapshot_b.get(field)
        if av is not None and bv is not None and av != bv:
            raise ValueError(
                f"cannot merge histograms with different {field}: "
                f"{av} vs {bv}")
    out = {
        "count": snapshot_a["count"] + snapshot_b["count"],
        "sum": snapshot_a["sum"] + snapshot_b["sum"],
        "min": min(snapshot_a["min"], snapshot_b["min"]),
        "max": max(snapshot_a["max"], snapshot_b["max"]),
    }
    out["mean"] = out["sum"] / out["count"]
    for field in ("lo", "base"):
        v = snapshot_a.get(field, snapshot_b.get(field))
        if v is not None:
            out[field] = v
    buckets: Dict[str, int] = dict(snapshot_a.get("buckets", {}))
    for ub, n in snapshot_b.get("buckets", {}).items():
        buckets[ub] = buckets.get(ub, 0) + n
    out["buckets"] = buckets
    return out


def quantile_from_snapshot(snapshot: Dict[str, object],
                           q: float) -> Optional[float]:
    """q-quantile (0 <= q <= 1) of a Histogram snapshot.

    Walks the sparse buckets in boundary order to the target rank, then
    interpolates geometrically within the bucket (log-scale buckets ⇒
    log-space interpolation), clamping to the observed [min, max].  The
    estimate is exact to within one bucket width of the true quantile.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    count = snapshot.get("count", 0)
    if not count:
        return None
    lo = float(snapshot.get("lo", 1e-6))
    base = float(snapshot.get("base", 2.0))
    obs_min = float(snapshot.get("min", lo))
    obs_max = float(snapshot.get("max", obs_min))
    buckets = sorted(
        ((math.inf if ub == "inf" else float(ub), int(n))
         for ub, n in snapshot.get("buckets", {}).items()),
        key=lambda t: t[0])
    rank = min(max(int(math.ceil(q * count)), 1), count)
    cum = 0
    for ub, n in buckets:
        if cum + n < rank:
            cum += n
            continue
        if math.isinf(ub):          # overflow bucket: no finite edges
            return obs_max
        hi_edge = ub
        lo_edge = ub / base
        frac = (rank - cum) / n
        val = lo_edge * (hi_edge / lo_edge) ** frac
        return min(max(val, obs_min), obs_max)
    return obs_max


class MetricsRegistry:
    """Named, labeled metric store.

    ``counter/gauge/histogram`` get-or-create: the same (name, labels)
    pair always returns the same metric object, so call sites hold no
    references and the registry stays the single source of truth.  A
    name is one kind only — re-registering it as another kind raises.
    """

    def __init__(self):
        # name -> (kind, {label_key -> metric})
        self._metrics: Dict[str, Tuple[type, Dict[LabelKey, object]]] = {}

    def _get(self, kind, name: str, labels: Dict[str, object], **kw):
        ent = self._metrics.get(name)
        if ent is None:
            ent = (kind, {})
            self._metrics[name] = ent
        elif ent[0] is not kind:
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{ent[0].__name__}, not {kind.__name__}")
        key = _label_key(labels)
        m = ent[1].get(key)
        if m is None:
            m = kind(**kw)
            ent[1][key] = m
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, lo: float = 1e-6, base: float = 2.0,
                  n_buckets: int = 40, **labels) -> Histogram:
        return self._get(Histogram, name, labels, lo=lo, base=base,
                         n_buckets=n_buckets)

    def snapshot(self) -> Dict[str, object]:
        """Flat JSON-friendly dict, deterministically ordered."""
        out = {}
        for name in sorted(self._metrics):
            _, by_label = self._metrics[name]
            for key in sorted(by_label):
                out[_fmt(name, key)] = by_label[key].snapshot()
        return out

    def value(self, name: str, **labels):
        """Current value of one metric (None when never written)."""
        ent = self._metrics.get(name)
        if ent is None:
            return None
        m = ent[1].get(_label_key(labels))
        return None if m is None else m.snapshot()

    def reset(self) -> None:
        self._metrics.clear()
