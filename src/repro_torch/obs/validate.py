"""CLI artifact validator: ``python -m repro_torch.obs.validate <file ...>``
(twin of the JAX package's ``obs/validate.py``).

Schema-aware: each argument is classified by content and validated —

  * ``*.jsonl``           — a BenchRecord history log; every line must
                            be a schema-valid ``bench-record/v1``;
  * ``schema: postmortem/v1`` — a flight-recorder dump
                            (:func:`repro_torch.obs.telemetry.validate_postmortem`);
  * ``schema: bench-record/v1`` — a single BenchRecord object;
  * ``traceEvents``       — Chrome/Perfetto ``trace_event`` JSON
                            (well-formed, balanced, nested spans,
                            monotonic B/E tracks).

Exits 0 when every file is clean (printing a one-line summary per
file); prints every problem and exits 1 otherwise; 2 on usage errors.
"""
from __future__ import annotations

import json
import sys
from typing import List, Tuple

from .bench import RECORD_SCHEMA, validate_record
from .telemetry import POSTMORTEM_SCHEMA, validate_postmortem
from .tracing import validate_trace_events


def validate_file(path: str) -> Tuple[List[str], str]:
    """Validate one artifact file; returns (problems, ok-summary)."""
    if path.endswith(".jsonl"):
        problems: List[str] = []
        n = 0
        seen: dict = {}
        try:
            lines = open(path).read().splitlines()
        except OSError as e:
            return [f"unreadable: {e}"], ""
        for i, line in enumerate(lines, start=1):
            if not line.strip():
                continue
            n += 1
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                problems.append(f"line {i}: unparseable: {e}")
                continue
            problems += [f"line {i}: {p}" for p in validate_record(rec)]
            # duplicate-append guard: one run id is shared by every
            # driver of one invocation, but a given
            # (run_id, driver) pair must appear exactly once per history
            # manifest — a repeat means a double-append (crashed rerun,
            # botched merge) that would skew the regression gate's
            # best-of-last-N windows.
            key = (rec.get("run_id"), rec.get("driver"))
            if key in seen:
                problems.append(
                    f"line {i}: duplicate record for run_id={key[0]} "
                    f"driver={key[1]!r} (first at line {seen[key]}; "
                    f"double-append?)")
            else:
                seen[key] = i
        if not n:
            problems.append("empty history (no records)")
        return problems, f"ok — {n} bench records"
    try:
        with open(path) as fh:
            obj = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        return [f"unreadable: {e}"], ""
    schema = obj.get("schema") if isinstance(obj, dict) else None
    if schema == POSTMORTEM_SCHEMA:
        problems = validate_postmortem(obj)
        return problems, (f"ok — postmortem at {obj.get('site')}, "
                          f"{len(obj.get('spans', []))} spans, "
                          f"{len(obj.get('metrics_delta', {}))} metric "
                          f"deltas")
    if schema == RECORD_SCHEMA:
        return validate_record(obj), \
            f"ok — bench record for {obj.get('driver')}"
    if isinstance(obj, dict) and "traceEvents" in obj:
        problems = validate_trace_events(obj)
        n = len(obj["traceEvents"])
        spans = sum(1 for e in obj["traceEvents"] if e.get("ph") == "X")
        return problems, f"ok — {n} events, {spans} spans"
    return ["unrecognized artifact (no known schema or traceEvents)"], ""


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m repro_torch.obs.validate <artifact.json ...>",
              file=sys.stderr)
        return 2
    rc = 0
    for path in argv:
        problems, summary = validate_file(path)
        if problems:
            rc = 1
            for p in problems:
                print(f"{path}: {p}", file=sys.stderr)
        else:
            print(f"{path}: {summary}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
