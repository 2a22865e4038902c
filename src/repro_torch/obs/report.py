"""The perf observatory: statistical regression gate + trajectory report
(twin of the JAX package's ``obs/report.py``).

``python -m repro_torch.obs.report --check`` evaluates declarative
**baseline entries** over the port's run history
(``artifacts/bench_torch/history.jsonl``, written through
``repro_torch.obs.bench.append_record``).

Baselines (``artifacts/bench_torch/baselines.json``, beside the port's
history and apart from the JAX package's) are grouped by **namespace** —
the coarse machine fingerprint slug from ``repro_torch.obs.bench`` — so
the card (``gpu:<kind>``) gates against its own numbers ("new
fingerprint ⇒ new baseline namespace").  Three entry kinds:

  ``min`` / ``max``   hard structural bars on the newest sample
                      (``gates.stranded <= 0``, ``speedup >= 1.3``);
  ``best``            recorded best-known value with a relative
                      tolerance band, judged on the *best of the last
                      N* samples (``min_of_n``) — noise-damped
                      trajectory tracking that catches slow erosion
                      (a 6x win decaying to 3x fails here long before
                      it would trip a 2x floor).

Without ``--check`` the module renders the human-readable trajectory
report: per-driver deltas vs. the previous run and vs. baseline,
sparkline history tables, p50/p99 flush latency (via
``Histogram.quantile`` over snapshot histograms) and the top
compile-count / pad-ratio movers between the last two runs.

``--update-baselines`` rewrites each ``best`` entry's value to the
current candidate — the intentional-ratchet workflow.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from . import bench
from .bench import load_history
from .metrics import merge as merge_hist
from .metrics import quantile_from_snapshot

BASELINES_SCHEMA = "bench-baselines/v1"
DEFAULT_BASELINES = bench.DEFAULT_HISTORY.parent / "baselines.json"

_SPARK = "▁▂▃▄▅▆▇█"


# ---------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------
def load_baselines(path=None) -> Dict[str, object]:
    """The baselines file (``DEFAULT_BASELINES`` as it is when called, by
    default)."""
    path = DEFAULT_BASELINES if path is None else path
    obj = json.loads(Path(path).read_text())
    if obj.get("schema") != BASELINES_SCHEMA:
        raise ValueError(f"{path}: schema is {obj.get('schema')!r}, "
                         f"expected {BASELINES_SCHEMA!r}")
    if not isinstance(obj.get("namespaces"), dict):
        raise ValueError(f"{path}: missing namespaces mapping")
    return obj


def _series(records: Sequence[dict], namespace: str, driver: str,
            metric: str) -> List[float]:
    """Metric values oldest -> newest for one (namespace, driver)."""
    rows = [r for r in records
            if r.get("namespace") == namespace
            and r.get("driver") == driver
            and isinstance(r.get("metrics"), dict)
            and metric in r["metrics"]]
    rows.sort(key=lambda r: (r.get("run_id", 0), r.get("ts", 0.0)))
    return [float(r["metrics"][metric]) for r in rows]


def check(records: Sequence[dict],
          baselines: Dict[str, object]) -> List[Dict[str, object]]:
    """Evaluate every baseline entry; returns one check dict per entry
    (``ok`` False on a regression *or* on missing history — a gate that
    silently skips a vanished metric is no gate)."""
    checks: List[Dict[str, object]] = []
    for ns, group in sorted(baselines.get("namespaces", {}).items()):
        for ent in group.get("entries", []):
            driver = ent["driver"]
            metric = ent["metric"]
            kind = ent.get("kind", "best")
            value = float(ent["value"])
            direction = ent.get(
                "direction", "lower" if kind == "max" else "higher")
            n = int(ent.get("min_of_n", 3 if kind == "best" else 1))
            series = _series(records, ns, driver, metric)
            window = series[-n:]
            chk: Dict[str, object] = {
                "namespace": ns, "driver": driver, "metric": metric,
                "kind": kind, "baseline": value, "direction": direction,
                "samples": len(window), "history_len": len(series),
            }
            if not window:
                chk.update(ok=False, candidate=None, threshold=value,
                           detail="no history sample for this metric")
                checks.append(chk)
                continue
            candidate = max(window) if direction == "higher" \
                else min(window)
            if kind == "min":
                threshold, ok = value, candidate >= value
            elif kind == "max":
                threshold, ok = value, candidate <= value
            else:                       # best-known with tolerance band
                tol = float(ent.get("rel_tol", 0.25))
                if direction == "higher":
                    threshold = value * (1.0 - tol)
                    ok = candidate >= threshold
                else:
                    threshold = value * (1.0 + tol)
                    ok = candidate <= threshold
            cmp = ">=" if (kind == "min" or (kind == "best"
                                             and direction == "higher")) \
                else "<="
            chk.update(
                ok=bool(ok), candidate=candidate, threshold=threshold,
                detail=(f"{'best' if n > 1 else 'latest'}-of-{len(window)} "
                        f"{candidate:g} {cmp} {threshold:g}"
                        + ("" if ok else " VIOLATED")))
            checks.append(chk)
    return checks


def update_baselines(records: Sequence[dict], baselines: Dict[str, object]) \
        -> List[str]:
    """Rewrite each ``best`` entry's value to the current candidate
    (in place); returns human-readable change lines."""
    changed: List[str] = []
    for ns, group in baselines.get("namespaces", {}).items():
        for ent in group.get("entries", []):
            if ent.get("kind", "best") != "best":
                continue
            direction = ent.get("direction", "higher")
            n = int(ent.get("min_of_n", 3))
            window = _series(records, ns, ent["driver"],
                             ent["metric"])[-n:]
            if not window:
                continue
            candidate = max(window) if direction == "higher" \
                else min(window)
            if candidate != ent["value"]:
                changed.append(
                    f"{ns}/{ent['driver']}:{ent['metric']} "
                    f"{ent['value']:g} -> {candidate:g}")
                ent["value"] = candidate
    return changed


# ---------------------------------------------------------------------------
# trajectory report
# ---------------------------------------------------------------------------
def sparkline(vals: Sequence[float]) -> str:
    vals = [v for v in vals if v is not None]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi - lo <= 1e-12 * max(abs(hi), 1.0):
        return _SPARK[3] * len(vals)
    return "".join(_SPARK[int((v - lo) / (hi - lo) * (len(_SPARK) - 1))]
                   for v in vals)


def _pct(new: Optional[float], old: Optional[float]) -> str:
    if new is None or old is None or abs(old) < 1e-12:
        return "—"
    return f"{100.0 * (new - old) / abs(old):+.1f}%"


def _runs(records: Sequence[dict]) -> List[int]:
    return sorted({r.get("run_id", 0) for r in records})


def _latest_per_driver(records: Sequence[dict], run_id: int) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    for r in records:
        if r.get("run_id") == run_id:
            out[r.get("driver", "?")] = r
    return out


def render_report(records: Sequence[dict], baselines: Dict[str, object],
                  checks: Sequence[dict], last_n: int = 12) -> str:
    lines: List[str] = ["# Perf observatory report", ""]
    if not records:
        lines.append("history is empty — no driver has appended a "
                     "BenchRecord yet.")
        return "\n".join(lines) + "\n"

    runs = _runs(records)
    latest_run = runs[-1]
    latest = [r for r in records if r.get("run_id") == latest_run]
    fp = latest[-1].get("fingerprint", {})
    lines += [
        f"{len(records)} records, {len(runs)} runs, "
        f"{len({r.get('driver') for r in records})} drivers "
        f"in history.",
        f"Latest run {latest_run} at {latest[-1].get('time', '?')} — "
        f"git {latest[-1].get('git_rev', '?')}, "
        f"namespace `{latest[-1].get('namespace', '?')}` "
        f"(torch {fp.get('torch', '?')}, "
        f"{fp.get('device_count', '?')}x {fp.get('device_kind', '?')}).",
        "",
    ]
    known_ns = set(baselines.get("namespaces", {}))
    for ns in sorted({r.get("namespace", "?") for r in records}):
        if ns not in known_ns:
            lines += [f"> namespace `{ns}` has history but no baselines "
                      f"— seed it with `--update-baselines` after adding "
                      f"entries.", ""]

    # ------------------------------------------------------------- gate --
    lines += ["## Regression gate", "",
              "| status | namespace | driver : metric | kind | candidate "
              "| threshold | baseline | history |",
              "|---|---|---|---|---|---|---|---|"]
    for c in checks:
        series = _series(records, c["namespace"], c["driver"],
                         c["metric"])[-last_n:]
        cand = "—" if c["candidate"] is None else f"{c['candidate']:g}"
        lines.append(
            f"| {'ok' if c['ok'] else '**FAIL**'} | {c['namespace']} "
            f"| {c['driver']} : {c['metric']} | {c['kind']} "
            f"| {cand} | {c['threshold']:g} | {c['baseline']:g} "
            f"| {sparkline(series)} |")
    lines.append("")

    # ------------------------------------------------- per-driver deltas --
    prev_run = runs[-2] if len(runs) > 1 else None
    by_latest = _latest_per_driver(records, latest_run)
    by_prev = _latest_per_driver(records, prev_run) if prev_run is not None \
        else {}
    tracked: Dict[str, List[str]] = {}
    for c in checks:
        tracked.setdefault(c["driver"], [])
        if c["metric"] not in tracked[c["driver"]]:
            tracked[c["driver"]].append(c["metric"])
    lines += [f"## Driver trajectory (run {latest_run}"
              + (f" vs run {prev_run}" if prev_run is not None else "")
              + ")", "",
              "| driver | metric | latest | Δ prev | Δ baseline "
              "| history |", "|---|---|---|---|---|---|"]
    base_val = {(c["driver"], c["metric"]): c["baseline"] for c in checks
                if c["kind"] == "best"}
    for driver in sorted(by_latest):
        rec = by_latest[driver]
        prev = by_prev.get(driver)
        metrics = tracked.get(driver) or []
        rows = [(m, rec.get("metrics", {}).get(m)) for m in metrics]
        rows.append(("wall_seconds", rec.get("wall_seconds")))
        for metric, val in rows:
            if val is None:
                continue
            prev_val = None
            if prev is not None:
                prev_val = (prev.get("metrics", {}).get(metric)
                            if metric != "wall_seconds"
                            else prev.get("wall_seconds"))
            series = _series(records, rec.get("namespace", "?"), driver,
                             metric)[-last_n:] \
                if metric != "wall_seconds" else \
                [r.get("wall_seconds") for r in records
                 if r.get("driver") == driver][-last_n:]
            lines.append(
                f"| {driver} | {metric} | {val:g} "
                f"| {_pct(val, prev_val)} "
                f"| {_pct(val, base_val.get((driver, metric)))} "
                f"| {sparkline(series)} |")
    lines.append("")

    # -------------------------------------------------- flush latency ----
    lat_lines: List[str] = []
    for driver in sorted(by_latest):
        snap = by_latest[driver].get("snapshot") or {}
        h = snap.get("broker.flush_seconds")
        if not isinstance(h, dict) or not h.get("count"):
            continue
        merged = {"count": 0, "sum": 0.0, "buckets": {}}
        for r in records:
            if r.get("driver") != driver:
                continue
            rh = (r.get("snapshot") or {}).get("broker.flush_seconds")
            if isinstance(rh, dict) and rh.get("count"):
                merged = merge_hist(merged, rh)
        p50 = quantile_from_snapshot(h, 0.5)
        p99 = quantile_from_snapshot(h, 0.99)
        ap50 = quantile_from_snapshot(merged, 0.5)
        lat_lines.append(
            f"| {driver} | {h['count']} | {p50 * 1e3:.1f} ms "
            f"| {p99 * 1e3:.1f} ms | {ap50 * 1e3:.1f} ms |")
    if lat_lines:
        lines += ["## Broker flush latency (latest run)", "",
                  "| driver | flushes | p50 | p99 | p50 all-history |",
                  "|---|---|---|---|---|", *lat_lines, ""]

    # ------------------------------------------------------- top movers --
    movers: List[tuple] = []
    for driver, rec in sorted(by_latest.items()):
        prev = by_prev.get(driver)
        if prev is None:
            continue
        snap, psnap = rec.get("snapshot") or {}, prev.get("snapshot") or {}
        for key, val in snap.items():
            if not isinstance(val, (int, float)) or isinstance(val, bool):
                continue
            if "compile" not in key and "pad" not in key:
                continue
            pval = psnap.get(key)
            if isinstance(pval, (int, float)) and pval != val:
                movers.append((abs(val - pval), driver, key, pval, val))
    if movers:
        movers.sort(reverse=True)
        lines += ["## Top compile/pad movers (vs previous run)", "",
                  "| driver | metric | prev | latest |", "|---|---|---|---|"]
        lines += [f"| {d} | {k} | {pv:g} | {v:g} |"
                  for _, d, k, pv, v in movers[:8]]
        lines.append("")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="benchmark trajectory report + regression gate")
    ap.add_argument("--check", action="store_true",
                    help="evaluate baselines; exit 1 on any regression")
    ap.add_argument("--history", default=str(bench.DEFAULT_HISTORY))
    ap.add_argument("--baselines", default=str(DEFAULT_BASELINES))
    ap.add_argument("--out", default=None,
                    help="also write the rendered report to this path")
    ap.add_argument("--last", type=int, default=12,
                    help="history window for sparklines")
    ap.add_argument("--update-baselines", action="store_true",
                    help="ratchet every 'best' entry to its current "
                         "candidate and rewrite the baselines file")
    args = ap.parse_args(argv)

    records, problems = load_history(Path(args.history))
    try:
        baselines = load_baselines(Path(args.baselines))
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"cannot load baselines: {e}", file=sys.stderr)
        return 2
    for p in problems:
        print(f"history: {p}", file=sys.stderr)

    if args.update_baselines:
        changed = update_baselines(records, baselines)
        Path(args.baselines).write_text(
            json.dumps(baselines, indent=1, sort_keys=True) + "\n")
        for line in changed:
            print(f"baseline updated: {line}")
        if not changed:
            print("baselines already at their candidates; file rewritten")

    checks = check(records, baselines)
    report = render_report(records, baselines, checks, last_n=args.last)
    print(report)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(report)

    if args.check:
        failures = [c for c in checks if not c["ok"]]
        if problems:
            print(f"REGRESSION GATE: history.jsonl has "
                  f"{len(problems)} schema problem(s)", file=sys.stderr)
        for c in failures:
            print(f"REGRESSION: {c['namespace']}/{c['driver']}:"
                  f"{c['metric']} — {c['detail']}", file=sys.stderr)
        if failures or problems:
            return 1
        print(f"regression gate ok: {len(checks)} baseline checks passed "
              f"over {len(records)} records")
    return 0


if __name__ == "__main__":
    sys.exit(main())
