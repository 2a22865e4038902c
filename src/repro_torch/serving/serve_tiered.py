"""One served burst on the tiered paged-KV server, at a given KV width.

Twin of the JAX package's ``examples/serve_tiered.py`` (``SERVE_TIERED``:
10 requests of 32..127 prompt tokens and 32 new ones, 256 hot / 2048 cold
blocks) and of ``benchmarks/kv_tiering.py::run_engine`` (``PRESSURE``:
12 requests of 96 + 24 tokens over 48 hot / 1024 cold blocks, where
Radiant and immobile tables differ).  The model is a stand-in: it makes
each token's KV from a seed, as the JAX drivers do.

    from repro_torch.serving import serve_tiered as st
    res = st.serve(st.PRESSURE, radiant=True)          # on the CUDA device
"""
from __future__ import annotations

import dataclasses
import time
from typing import Tuple

import numpy as np
import torch

from .. import configs
from ..device import resolve_device, synchronize
from ..memsys import tiered_kv as tkv
from .engine import EngineStats, Request, TieredServingEngine


@dataclasses.dataclass(frozen=True)
class Burst:
    name: str
    n_hot: int
    n_cold: int
    n_seqs: int
    max_seq: int
    active_slots: int
    prompts: Tuple[int, ...]       # prompt length of request rid
    max_new: int
    max_ticks: int
    kv: str                        # "normal" or "const": how KV is made


def _serve_tiered_prompts() -> Tuple[int, ...]:
    rng = np.random.default_rng(0)
    return tuple(int(rng.integers(32, 128)) for _ in range(10))


SERVE_TIERED = Burst("serve_tiered", n_hot=256, n_cold=2048, n_seqs=16,
                     max_seq=512, active_slots=4,
                     prompts=_serve_tiered_prompts(), max_new=32,
                     max_ticks=2000, kv="normal")
PRESSURE = Burst("kv_tiering", n_hot=48, n_cold=1024, n_seqs=12,
                 max_seq=96 + 24 + 32, active_slots=4, prompts=(96,) * 12,
                 max_new=24, max_ticks=12 * 24 * 4, kv="const")


def _normal(shape, seed, dtype, device):
    """``normal * 0.1`` drawn on the CPU from ``seed``, so a burst makes
    the same KV on every device."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g, dtype=dtype) * 0.1).to(device)


def prompt_kv(burst: Burst, rid: int, geo: configs.KVGeometry, device):
    """Prompt KV [prompt_len, G, KH, Dh] of request ``rid`` (K == V)."""
    shape = (burst.prompts[rid], geo.n_groups, geo.kv_heads, geo.head_dim)
    if burst.kv == "normal":
        return _normal(shape, rid, geo.dtype, device)
    # kv_tiering: ones * (rid + 1) * 0.01, rounded as JAX does it (the
    # Python scalar takes the array's dtype before the product)
    one = torch.ones(shape, dtype=geo.dtype, device=device) * (rid + 1)
    return one * torch.tensor(0.01, dtype=geo.dtype)


def decode_fn(burst: Burst, geo: configs.KVGeometry):
    """The stand-in model: next-token KV of ``rid`` at length ``t``."""
    shape = (geo.n_groups, geo.kv_heads, geo.head_dim)

    def fn(kv: tkv.TieredKV, rid: int):
        t = int(kv.seq_len[rid])
        if burst.kv == "normal":
            k = _normal(shape, rid * 1000 + t, geo.dtype, kv.hot_k.device)
        else:
            k = torch.full(shape, (rid + 1) * 0.01 + t * 1e-4,
                           dtype=geo.dtype, device=kv.hot_k.device)
        return k, k

    return fn


@dataclasses.dataclass
class BurstResult:
    engine: TieredServingEngine
    stats: EngineStats
    violations: int
    prefill_s: float               # host clock, device work included
    decode_s: float

    @property
    def tokens_per_s(self) -> float:
        return self.stats.tokens / self.decode_s


def serve(burst: Burst, *, radiant: bool = True,
          geometry: configs.KVGeometry = configs.KV,
          device=None) -> BurstResult:
    """Submit and prefill every request of ``burst``, then decode until
    all are done (or ``max_ticks``)."""
    dev = resolve_device(device)
    geo = geometry
    eng = TieredServingEngine(
        n_groups=geo.n_groups, kv_heads=geo.kv_heads, head_dim=geo.head_dim,
        block_size=geo.block_size, n_hot_blocks=burst.n_hot,
        n_cold_blocks=burst.n_cold, n_seqs=burst.n_seqs,
        max_seq=burst.max_seq, active_slots=burst.active_slots,
        radiant=radiant, dtype=geo.dtype, device=dev)
    for rid, plen in enumerate(burst.prompts):
        eng.submit(Request(rid=rid, prompt_len=plen, max_new=burst.max_new))
    synchronize(dev)
    t0 = time.perf_counter()
    for rid in range(len(burst.prompts)):
        ks = prompt_kv(burst, rid, geo, dev)
        eng.prefill(rid, (ks, ks))
    synchronize(dev)
    t1 = time.perf_counter()
    stats = eng.run(decode_fn(burst, geo), max_ticks=burst.max_ticks)
    synchronize(dev)
    t2 = time.perf_counter()
    viol = int(tkv.table_invariant_violations(eng.kv))
    return BurstResult(eng, stats, viol, t1 - t0, t2 - t1)
