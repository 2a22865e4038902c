"""Structured trace recorder exporting Chrome/Perfetto ``trace_event``
JSON (twin of the JAX package's ``obs/tracing.py``).

Spans are recorded as *complete* events (``ph: "X"`` — one event
carrying both timestamp and duration), which are balanced by
construction and load directly in Perfetto / ``chrome://tracing``.
Timestamps are microseconds relative to the recorder's construction, on
the recorder's own monotonic clock — the broker's (possibly fake)
scheduling clock never leaks into exported traces, and a span emitted
late with an earlier start (e.g. a queue-wait span recorded at flush
time) still gets a non-negative timestamp.

The recorder is bounded (``max_events``): a long benchmark run cannot
grow an unbounded event list; overflow drops new events and counts the
drops, which ``to_trace_json()`` reports in metadata so a truncated
trace is never mistaken for a complete one.
"""
from __future__ import annotations

import json
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

# Microseconds per second: trace_event timestamps are in us.
_US = 1e6


class SpanRecorder:
    """Append-only span/instant event log with trace_event export."""

    def __init__(self, clock=time.monotonic, max_events: int = 200_000,
                 process_name: str = "repro-sim-service",
                 recent_events: int = 256):
        self.clock = clock
        self.max_events = int(max_events)
        self.process_name = process_name
        self.events: List[dict] = []
        # black-box ring: always holds the *newest* events, even after
        # the main list saturates and starts dropping — the flight
        # recorder's postmortems read this, and a crash late in a long
        # run must still see its own final spans
        self.recent: "deque[dict]" = deque(maxlen=int(recent_events))
        self.dropped = 0
        self._t0 = self.clock()

    # ------------------------------------------------------------------
    # recording
    # ------------------------------------------------------------------
    def now(self) -> float:
        """Recorder-clock seconds; use for explicit begin/end spans."""
        return self.clock()

    def _ts(self, t: float) -> float:
        return max(t - self._t0, 0.0) * _US

    def _emit(self, ev: dict) -> None:
        self.recent.append(ev)
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def add_span(self, name: str, begin: float, end: float,
                 cat: str = "service", tid: int = 0,
                 args: Optional[Dict] = None) -> None:
        """One complete span from recorder-clock ``begin`` to ``end``."""
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": self._ts(begin), "dur": max(end - begin, 0.0) * _US,
              "pid": 0, "tid": int(tid)}
        if args:
            ev["args"] = args
        self._emit(ev)

    @contextmanager
    def span(self, name: str, cat: str = "service", tid: int = 0,
             args: Optional[Dict] = None):
        t0 = self.clock()
        try:
            yield
        finally:
            self.add_span(name, t0, self.clock(), cat=cat, tid=tid,
                          args=args)

    def instant(self, name: str, cat: str = "service", tid: int = 0,
                args: Optional[Dict] = None) -> None:
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": self._ts(self.clock()), "pid": 0, "tid": int(tid)}
        if args:
            ev["args"] = args
        self._emit(ev)

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def span_names(self) -> List[str]:
        return [e["name"] for e in self.events if e["ph"] == "X"]

    def to_trace_json(self) -> dict:
        """The Chrome/Perfetto ``trace_event`` JSON object."""
        meta = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                 "args": {"name": self.process_name}}]
        obj = {"traceEvents": meta + self.events,
               "displayTimeUnit": "ms"}
        if self.dropped:
            obj["otherData"] = {"dropped_events": self.dropped}
        return obj

    def export(self, path) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_trace_json(), fh, indent=1, default=float)

    def reset(self) -> None:
        self.events.clear()
        self.recent.clear()
        self.dropped = 0
        self._t0 = self.clock()


def validate_trace_events(obj: dict) -> List[str]:
    """Validate a ``trace_event`` JSON object; return a list of problems
    (empty = well-formed, balanced, Perfetto-loadable).

    Checks: the ``traceEvents`` container, per-event required fields,
    non-negative timestamps/durations on complete (``X``) spans, and —
    for any begin/end (``B``/``E``) pairs a foreign producer might emit —
    LIFO balance and non-decreasing timestamps per (pid, tid).

    Complete spans on one (pid, tid) track must *nest*: exact
    containment is fine (Perfetto stacks it), but partial overlap —
    span B starting inside span A and ending after it — renders as
    garbage and always indicates a producer attributing one wall-clock
    interval to two concurrent activities on the same track.
    """
    problems: List[str] = []
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    if not any(e.get("ph") == "X" for e in events):
        problems.append("no complete (ph='X') spans in trace")
    open_stacks: Dict[tuple, list] = {}
    # per-track lists for the cross-event checks below
    x_spans: Dict[tuple, list] = {}
    last_be_ts: Dict[tuple, float] = {}
    for i, e in enumerate(events):
        ph = e.get("ph")
        if ph not in ("X", "B", "E", "i", "I", "M", "C"):
            problems.append(f"event {i}: unknown ph {ph!r}")
            continue
        if ph != "E" and not isinstance(e.get("name"), str):
            problems.append(f"event {i}: missing name")
        ts_ok = False
        if ph in ("X", "B", "E", "i", "I", "C"):
            ts = e.get("ts")
            ts_ok = isinstance(ts, (int, float)) and ts >= 0
            if not ts_ok:
                problems.append(f"event {i}: bad ts {ts!r}")
        key = (e.get("pid"), e.get("tid"))
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: bad dur {dur!r}")
            elif ts_ok:
                x_spans.setdefault(key, []).append(
                    (float(ts), float(ts) + float(dur), i, e.get("name")))
        if ph == "B":
            open_stacks.setdefault(key, []).append(e.get("name"))
        elif ph == "E":
            stack = open_stacks.get(key)
            if not stack:
                problems.append(f"event {i}: E without matching B on {key}")
            else:
                stack.pop()
        if ph in ("B", "E") and ts_ok:
            # B/E events carry implicit ordering: a track that goes
            # backwards in time is unparseable by duration-event viewers
            prev = last_be_ts.get(key)
            if prev is not None and ts < prev:
                problems.append(
                    f"event {i}: non-monotonic ts on track {key}: "
                    f"{ts} after {prev}")
            last_be_ts[key] = float(ts)
    for key, stack in open_stacks.items():
        if stack:
            problems.append(f"unclosed B spans on {key}: {stack}")
    # X-span nesting per track: sweep spans in (start, -end) order with a
    # stack of enclosing ends; a span poking out past its encloser is a
    # partial overlap.  EPS absorbs float-us rounding at shared edges.
    eps = 1e-6
    for key, spans in x_spans.items():
        stack: List[float] = []
        for ts, end, i, name in sorted(spans,
                                       key=lambda s: (s[0], -s[1])):
            while stack and stack[-1] <= ts + eps:
                stack.pop()
            if stack and end > stack[-1] + eps:
                problems.append(
                    f"event {i}: span {name!r} [{ts:g}, {end:g}] "
                    f"partially overlaps an earlier span on track {key}")
                continue
            stack.append(end)
    return problems
