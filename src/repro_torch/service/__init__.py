"""Simulation-as-a-service on the port: a shape-bucketed query broker over
the lane-batched sweep engine (twin of the JAX package's ``service``, with
the same modules and public names).

  * :class:`SimQuery` — one independent question: a machine, a policy
    bundle, a cost model, and a trace (by value or by
    :class:`~repro_torch.core.workloads.TraceSpec`), plus
    priority/deadline.
  * :class:`SimBroker` — admission-queues queries, buckets them by
    (machine, engines, trace shape, scan period), microbatches each
    bucket into a single ``repro_torch.core.sweep_lanes`` call across the
    lane axis (on its device, the CUDA device unless the caller passes
    ``device="cpu"``, or sharded over devices with ``lane_sharding``),
    and resolves per-query futures.  A
    content-addressed result cache answers repeats with no device work
    and no kernel launch.
  * :mod:`repro_torch.service.search` — a client-side search driver
    (grid + successive halving over PolicyConfig space) over the broker.

Every layer reports into an optional :class:`repro_torch.obs.Telemetry`
(``SimBroker(telemetry=...)``): lifecycle spans, queue-wait/flush
histograms, cache and migration counters — ``broker.snapshot()`` renders
the lot; the default is a no-op sink and results are identical either
way (see :mod:`repro_torch.obs`).

The failure model lives in :mod:`repro_torch.service.resilience` (typed
error taxonomy, TTL quarantine, per-bucket circuit breaker,
retry/backoff and admission-control knobs) and is chaos-tested through
the deterministic fault-injection harness in
:mod:`repro_torch.obs.inject`.  ``tests/test_torch_service.py`` pins
per-query results bit-identical to direct sequential
``TieredMemSimulator`` runs, and equal to the JAX package's broker.
"""
from ..obs import FaultInjector, FaultRule, InjectedFault, NullTelemetry, \
    Telemetry, fail_lane, fail_n, fail_once, fail_rate
from .broker import BrokerStats, SimBroker
from .cache import DiskCacheTier, ResultCache
from .query import (SimFuture, SimQuery, lane_digest, query_cache_key,
                    spec_cache_key)
from .resilience import (BrokerOverloadedError, BrokerTimeoutError,
                         CircuitBreaker, DeadlineExceededError,
                         PoisonedQueryError, Quarantine, ResilienceConfig,
                         ServiceError)
from .search import grid_search, policy_grid, successive_halving

__all__ = [
    "BrokerStats", "SimBroker", "DiskCacheTier", "ResultCache", "SimFuture",
    "SimQuery", "lane_digest", "query_cache_key", "spec_cache_key",
    "grid_search", "policy_grid", "successive_halving",
    "Telemetry", "NullTelemetry",
    "ServiceError", "PoisonedQueryError", "DeadlineExceededError",
    "BrokerOverloadedError", "BrokerTimeoutError",
    "ResilienceConfig", "Quarantine", "CircuitBreaker",
    "FaultInjector", "FaultRule", "InjectedFault",
    "fail_once", "fail_n", "fail_lane", "fail_rate",
]
