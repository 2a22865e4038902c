"""BenchRecord: the unified benchmark-observability record (twin of the
JAX package's ``obs/bench.py``).

One record schema for every benchmark driver run of the port:

  * identity — driver name, monotonic ``run_id`` (one id per driver
    invocation batch), wall-clock timestamps, the repo's git revision;
  * provenance — a machine/torch/device **fingerprint** plus the coarse
    ``namespace`` derived from it (``gpu:nvidia-h100-80gb-hbm3`` on the
    card, ``cpu`` without one).  Baselines (``repro_torch.obs.report``)
    are namespaced by it;
  * payload — the driver's CSV ``figures`` rows, a flattened ``metrics``
    dict (every finite scalar in the artifact payload, dotted-path keyed:
    ``populate.8lane.speedup``, ``gates.stranded``, ...), and the
    telemetry registry ``snapshot`` for the run.

Records append to the port's own ``artifacts/bench_torch/history.jsonl``
— one JSON object per line, append-only — never to the JAX package's
history beside it, so that the two packages' trajectories and baselines
stay apart.  The fingerprint reads ``torch`` and never imports JAX.
"""
from __future__ import annotations

import json
import math
import platform as _platform
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

RECORD_SCHEMA = "bench-record/v1"

# repo root (src/repro_torch/obs/bench.py -> repo); artifacts live beside
# src/, the port's in a directory of their own
_REPO = Path(__file__).resolve().parents[3]
DEFAULT_HISTORY = _REPO / "artifacts" / "bench_torch" / "history.jsonl"

# payload subtrees that are not trajectory metrics: the registry snapshot
# is carried whole in its own field, traces/postmortems are file pointers
_SKIP_SUBTREES = ("snapshot", "telemetry", "trace_file", "postmortems")

_FINGERPRINT: Optional[Dict[str, object]] = None
_GIT_REV: Optional[str] = None


def fingerprint() -> Dict[str, object]:
    """Machine/torch/device identity of this process (cached).

    Deliberately coarse: it must be stable across runs on one box (it
    keys baseline namespaces) yet distinguish a CPU runner from a GPU
    one.  ``device_platform`` is ``"gpu"`` when torch sees a CUDA device
    (``device_kind`` is then its name), else ``"cpu"``.
    """
    global _FINGERPRINT
    if _FINGERPRINT is None:
        fp: Dict[str, object] = {
            "platform": _platform.platform(),
            "machine": _platform.machine(),
            "python": _platform.python_version(),
        }
        try:
            import torch
            fp["torch"] = torch.__version__
            fp["cuda"] = str(torch.version.cuda)
            if torch.cuda.is_available():
                fp["device_platform"] = "gpu"
                fp["device_kind"] = torch.cuda.get_device_name(0)
                fp["device_count"] = torch.cuda.device_count()
            else:
                fp["device_platform"] = "cpu"
                fp["device_kind"] = "cpu"
                fp["device_count"] = 1
        except Exception:  # noqa: BLE001 — fingerprint must never fail
            fp["torch"] = "unavailable"
            fp["cuda"] = "unavailable"
            fp["device_platform"] = "unknown"
            fp["device_kind"] = "unknown"
            fp["device_count"] = 0
        try:
            import numpy
            fp["numpy"] = numpy.__version__
        except Exception:  # noqa: BLE001
            fp["numpy"] = "unavailable"
        _FINGERPRINT = fp
    return dict(_FINGERPRINT)


def namespace_of(fp: Dict[str, object]) -> str:
    """Coarse baseline namespace from a fingerprint.

    All CPU runners share one namespace ("cpu"); a GPU gets its own
    (``gpu:nvidia-h100-80gb-hbm3`` style), which the report treats as
    un-baselined until seeded with ``--update-baselines``.
    """
    plat = str(fp.get("device_platform", "unknown")).lower()
    if plat in ("cpu", "unknown"):
        return "cpu"
    kind = str(fp.get("device_kind", "")).strip().lower()
    kind = "-".join(kind.split()) or "generic"
    return f"{plat}:{kind}"


def git_rev() -> str:
    """Short git revision of the repo (cached; "unknown" outside git)."""
    global _GIT_REV
    if _GIT_REV is None:
        try:
            out = subprocess.run(
                ["git", "rev-parse", "--short=12", "HEAD"], cwd=_REPO,
                capture_output=True, text=True, timeout=10)
            _GIT_REV = out.stdout.strip() if out.returncode == 0 else ""
        except Exception:  # noqa: BLE001 — provenance is best-effort
            _GIT_REV = ""
        _GIT_REV = _GIT_REV or "unknown"
    return _GIT_REV


def flatten_metrics(payload, max_entries: int = 400) -> Dict[str, float]:
    """Every finite scalar in a driver's artifact payload, keyed by its
    dotted path — the queryable surface baselines address.

    Booleans become 0/1 (``_meta.compile_check.ok``), short numeric
    lists index per element, strings and long arrays are skipped.
    """
    out: Dict[str, float] = {}

    def walk(prefix: str, node) -> None:
        if len(out) >= max_entries:
            return
        if isinstance(node, bool):
            out[prefix] = float(int(node))
        elif isinstance(node, (int, float)):
            v = float(node)
            if math.isfinite(v):
                out[prefix] = v
        elif isinstance(node, dict):
            for k, v in node.items():
                if prefix == "" and k in _SKIP_SUBTREES:
                    continue
                walk(f"{prefix}.{k}" if prefix else str(k), v)
        elif isinstance(node, (list, tuple)) and 0 < len(node) <= 8 and \
                all(isinstance(x, (int, float)) for x in node):
            for i, x in enumerate(node):
                walk(f"{prefix}.{i}", x)

    if isinstance(payload, dict):
        walk("", payload)
    return out


def make_record(driver: str, payload=None, figures: Sequence[Tuple] = (),
                wall_seconds: float = 0.0, quick: bool = False,
                run_id: int = 0, snapshot=None,
                clock=time.time) -> Dict[str, object]:
    """Assemble one schema-valid BenchRecord for a finished driver."""
    ts = float(clock())
    rec: Dict[str, object] = {
        "schema": RECORD_SCHEMA,
        "run_id": int(run_id),
        "driver": str(driver),
        "quick": bool(quick),
        "ts": ts,
        "time": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(ts)),
        "wall_seconds": float(wall_seconds),
        "git_rev": git_rev(),
        "fingerprint": fingerprint(),
        "figures": [[str(n), float(s), str(d)] for n, s, d in figures],
        "metrics": flatten_metrics(payload),
    }
    rec["namespace"] = namespace_of(rec["fingerprint"])
    if snapshot:
        rec["snapshot"] = snapshot
    return rec


def validate_record(rec) -> List[str]:
    """Schema check for one BenchRecord; returns problems (empty = ok)."""
    problems: List[str] = []
    if not isinstance(rec, dict):
        return ["record is not an object"]
    if rec.get("schema") != RECORD_SCHEMA:
        problems.append(f"schema is {rec.get('schema')!r}, "
                        f"expected {RECORD_SCHEMA!r}")
    for field, kind in (("run_id", int), ("driver", str), ("quick", bool),
                        ("ts", (int, float)), ("time", str),
                        ("wall_seconds", (int, float)), ("git_rev", str),
                        ("namespace", str), ("fingerprint", dict),
                        ("figures", list), ("metrics", dict)):
        v = rec.get(field)
        if not isinstance(v, kind) or (kind is int and isinstance(v, bool)):
            problems.append(f"field {field!r} missing or not "
                            f"{getattr(kind, '__name__', kind)}")
    if isinstance(rec.get("run_id"), int) and rec["run_id"] < 0:
        problems.append("run_id is negative")
    if isinstance(rec.get("driver"), str) and not rec["driver"]:
        problems.append("driver is empty")
    fp = rec.get("fingerprint")
    if isinstance(fp, dict):
        for field in ("device_platform", "torch", "python"):
            if not isinstance(fp.get(field), str):
                problems.append(f"fingerprint.{field} missing")
    if isinstance(rec.get("metrics"), dict):
        for k, v in rec["metrics"].items():
            if not isinstance(k, str) or isinstance(v, bool) or \
                    not isinstance(v, (int, float)):
                problems.append(f"metrics[{k!r}] is not numeric")
                break
    if isinstance(rec.get("figures"), list):
        for row in rec["figures"]:
            if (not isinstance(row, list) or len(row) != 3
                    or not isinstance(row[0], str)
                    or not isinstance(row[1], (int, float))
                    or not isinstance(row[2], str)):
                problems.append(f"figures row malformed: {row!r}")
                break
    return problems


# ---------------------------------------------------------------------------
# the history store: append-only JSONL
# ---------------------------------------------------------------------------
def _history(path) -> Path:
    """``path``, or (``None``) the module's ``DEFAULT_HISTORY`` as it is
    when called, so that a caller (a test) can point it elsewhere."""
    return Path(DEFAULT_HISTORY if path is None else path)


def append_record(rec: Dict[str, object], path=None) -> None:
    path = _history(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as fh:
        fh.write(json.dumps(rec, sort_keys=True, default=float) + "\n")


def load_history(path=None) -> Tuple[List[Dict[str, object]], List[str]]:
    """Parse a history.jsonl (``DEFAULT_HISTORY`` by default); returns
    (records, problems).  Records that parse but fail schema validation
    are still returned (the report can render them) with their problems
    listed."""
    path = _history(path)
    records: List[Dict[str, object]] = []
    problems: List[str] = []
    if not path.exists():
        return records, [f"{path}: no such file"]
    for i, line in enumerate(path.read_text().splitlines(), start=1):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            problems.append(f"line {i}: unparseable: {e}")
            continue
        for p in validate_record(rec):
            problems.append(f"line {i}: {p}")
        records.append(rec)
    return records, problems


def next_run_id(path=None) -> int:
    """The next monotonic run id: max recorded id + 1 (0 for a fresh
    history).  One id spans all drivers of one invocation."""
    records, _ = load_history(path)
    ids = [r["run_id"] for r in records
           if isinstance(r.get("run_id"), int)]
    return (max(ids) + 1) if ids else 0
