"""Analytic step FLOPs and the policy-sweep summary (twin of the JAX
package's ``launch/analysis.py``).  ``parse_collectives``, which reads
XLA's HLO text, comes with the distributed port.

Importable without touching the device: the broker is made on first use.
"""
from __future__ import annotations


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
    """Shared simulation-service broker for analysis helpers, on the CUDA
    device (one device: the port's broker has no lane sharding)."""
    global _BROKER
    if _BROKER is None:
        from ..service import SimBroker
        _BROKER = SimBroker(max_lanes=64)
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
