"""Collective traffic, analytic step FLOPs and the policy-sweep summary
(twin of the JAX package's ``launch/analysis.py``).

The reference reads its collectives from XLA's SPMD HLO text; the port
records the functional collectives DTensor issues on the local shards
(``launch.dryrun.StepRecorder``, a ``TorchDispatchMode``) and
:func:`parse_collectives` reads those records under XLA's op names with
the reference's ring model.

Importable without touching the device or any process group: the broker
is made on first use.
"""
from __future__ import annotations

# torch's functional collectives -> XLA's op names
XLA_OP = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
          "all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_to_all_single": "all-to-all"}
XLA_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
           "collective-permute")


def parse_collectives(records):
    """Per-device collective traffic estimate from the recorded
    collectives: ``(op, result_bytes, group_size)`` each, ``op`` a
    functional collective's name or XLA's.

    Ring-model bytes-on-wire per device: all-gather / reduce-scatter /
    all-to-all move (g-1)/g of the full buffer; all-reduce moves 2x that;
    collective-permute moves the buffer once.
    """
    out = {}
    for op, nbytes, g in records:
        op = XLA_OP.get(op, op)
        if op not in XLA_OPS:
            continue
        frac = (g - 1) / g
        if op == "all-reduce":
            traffic = 2 * nbytes * frac
        elif op == "collective-permute":
            traffic = nbytes
        else:
            traffic = nbytes * frac
        d = out.setdefault(op, {"count": 0, "bytes": 0.0, "traffic": 0.0})
        d["count"] += 1
        d["bytes"] += nbytes
        d["traffic"] += traffic
    return out


def model_flops(cfg, shape) -> float:
    """Classic 2ND (fwd) / 6ND (train) matmul-FLOPs-per-step estimate."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch          # decode: one token per seq


_BROKER = None


def _default_broker():
    """Shared simulation-service broker for analysis helpers, its lanes
    sharded over the visible CUDA devices (lazy: keeps this module
    importable without touching the device)."""
    global _BROKER
    if _BROKER is None:
        from ..service import SimBroker
        _BROKER = SimBroker(max_lanes=64, lane_sharding="auto")
    return _BROKER


def policy_sweep_summary(mc, policies, trace, cc=None, baseline: int = 0,
                         broker=None):
    """Ad-hoc policy comparison on one trace via the simulation service.

    Every PolicyConfig in ``policies`` becomes a SimQuery against the
    shared broker (``broker=None``: one on the CUDA device; pass a
    ``SimBroker(device="cpu")`` for the CPU), so grid regeneration
    microbatches into per-bucket ``sweep_lanes`` calls, repeats are
    answered from the content-addressed result cache, and mixed AutoNUMA
    periods are legal (they land in separate buckets).  Returns
    ``{label: summary}`` where each summary carries the simulator metrics
    plus ``improvement_pct`` of ``total_cycles`` against the
    ``baseline``-indexed policy.
    """
    from ..core import CostConfig
    from ..service import SimQuery

    broker = broker if broker is not None else _default_broker()
    cc = cc if cc is not None else CostConfig()
    results = broker.run([SimQuery(trace=trace, policy=pc, cost=cc,
                                   machine=mc) for pc in policies])
    base_total = results[baseline].summary()["total_cycles"]
    out = {}
    for i, (pc, res) in enumerate(zip(policies, results)):
        m = res.summary()
        m["improvement_pct"] = (100.0 * (base_total - m["total_cycles"])
                                / max(base_total, 1e-12))
        key = pc.label()
        if key in out:            # same label, different non-label knobs
            key = f"{key}#{i}"
        out[key] = m
    return out
