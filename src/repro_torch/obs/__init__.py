"""End-to-end telemetry for the port's simulation service stack (twin of
the JAX package's ``obs``, with the same modules and public names).

Three layers:

  * :mod:`repro_torch.obs.metrics` — a metrics registry (counters,
    gauges, fixed log-bucket histograms, labeled) that the broker, result
    cache, sweep engine and search drivers report into;
  * :mod:`repro_torch.obs.tracing` — a structured span recorder exporting
    Chrome/Perfetto ``trace_event`` JSON, plus its validator;
  * :mod:`repro_torch.obs.telemetry` — the :class:`Telemetry` facade with
    a near-zero-cost :data:`NULL` default, so the instrumented stack pays
    one attribute load per hook when observability is off; every hook is
    host-side and reads no device value, so the engines' results (and
    their device work) are the same either way.

``python -m repro_torch.obs.validate <artifact.json ...>`` schema-checks
exported artifacts — Perfetto traces, ``history.jsonl`` BenchRecord
logs, postmortem dumps.

Two layers ride alongside:

  * :mod:`repro_torch.obs.inject` — a deterministic fault-injection
    harness (named sites, seeded schedule-reproducible failure plans)
    that the service layer's resilience machinery is chaos-tested
    against.  Like telemetry, its default is a no-op singleton.
  * :mod:`repro_torch.obs.bench` + :mod:`repro_torch.obs.report` — the
    perf observatory: fingerprinted BenchRecords appended to the port's
    own ``artifacts/bench_torch/history.jsonl``, and ``python -m
    repro_torch.obs.report --check`` gating the trajectory against
    per-namespace baselines beside it.  :class:`FlightRecorder` dumps a
    postmortem (recent spans + metrics delta + broker state) on
    persistent service failures.
"""
from .bench import (RECORD_SCHEMA, append_record, fingerprint,
                    flatten_metrics, load_history, make_record,
                    namespace_of, next_run_id, validate_record)
from .inject import (FaultInjector, FaultRule, InjectedFault, NULL_INJECTOR,
                     NullInjector, fail_lane, fail_n, fail_once, fail_rate,
                     or_null_injector)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, merge,
                      quantile_from_snapshot)
from .telemetry import (FlightRecorder, NULL, NullTelemetry,
                        POSTMORTEM_SCHEMA, Telemetry, or_null,
                        validate_postmortem)
from .tracing import SpanRecorder, validate_trace_events

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "merge", "quantile_from_snapshot",
    "NULL", "NullTelemetry", "Telemetry", "or_null",
    "FlightRecorder", "POSTMORTEM_SCHEMA", "validate_postmortem",
    "SpanRecorder", "validate_trace_events",
    "RECORD_SCHEMA", "append_record", "fingerprint", "flatten_metrics",
    "load_history", "make_record", "namespace_of", "next_run_id",
    "validate_record",
    "FaultInjector", "FaultRule", "InjectedFault", "NULL_INJECTOR",
    "NullInjector", "fail_lane", "fail_n", "fail_once", "fail_rate",
    "or_null_injector",
]
