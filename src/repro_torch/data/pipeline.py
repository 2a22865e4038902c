"""Deterministic, elastic, shardable synthetic token pipeline (twin of the
JAX package's ``data/pipeline.py``: the same tokens, bit for bit).

Tokens are a pure function of (step, global_row, column) via a counter-mode
hash — so any host can materialize exactly its shard of the global batch
with no coordination, restarts are bit-reproducible from the step counter
alone, and *elastic rescaling* (changing DP degree mid-run) cannot shift
data: host h of H serves global rows [h*B/H, (h+1)*B/H).

A light Zipf shaping makes the loss curve non-degenerate (uniform random
tokens give a flat loss surface).

Where PyTorch and the reference part ways, and what is done about it:

  * the hash is uint32 arithmetic; torch's ``uint32`` has no ``>>`` or
    ``%`` on the CPU, so it runs in int64 with ``& 0xFFFFFFFF`` after
    every product and sum;
  * the reference's f32 ``pow`` is glibc's ``powf``, which torch's f32
    ``pow`` differs from by an ulp often enough to move the token of one
    draw in 1,900 (8,866 of the 2^24 values of ``u``): the port calls
    :func:`repro_torch.libm.powf`, glibc's algorithm in torch ops, equal
    to it on all 2^24, on the CPU and on the card alike;
  * the reference's cast of the ranks to int32 saturates (inf becomes
    2^31 - 1, then ``vocab - 1``), torch's does not, so the ranks are
    clamped to ``[0, vocab - 1]`` in f32 first (exact: ``vocab - 1`` is
    below 2^24).
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from ..libm import powf

_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    zipf_theta: float = 1.1


def _hash(x: torch.Tensor) -> torch.Tensor:
    """The reference's uint32 hash of int64 values in ``[0, 2^32)``."""
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _M32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def _ranks(cfg: DataConfig, step: int, start: int, count: int,
           dev: torch.device) -> torch.Tensor:
    """The Zipf ranks (f32) of rows [start, start + count), seq_len + 1
    columns: inverse-CDF Zipf over the vocab (approximate, closed form)."""
    i64 = torch.int64
    rows = torch.arange(start, start + count, dtype=i64, device=dev)
    cols = torch.arange(cfg.seq_len + 1, dtype=i64, device=dev)
    seed = (int(step) * 0x9E3779B9) & _M32
    h = _hash((seed + _hash((rows[:, None] * 65537 + cols) & _M32)) & _M32)
    u = (h >> 8).to(torch.float32) / float(1 << 24)
    return powf(1.0 - u, -1.0 / (cfg.zipf_theta - 1.0)) - 1.0


def batch_at(cfg: DataConfig, step: int, host_rows=None, device=None):
    """Materialize (tokens, targets) for ``step``, int32 on ``device``
    (``None``: the CUDA device).

    host_rows: optional (start, count) to produce only this host's shard.
    """
    dev = resolve_device(device)
    start, count = host_rows or (0, cfg.global_batch)
    ranks = _ranks(cfg, step, start, count, dev)
    toks = ranks.clamp(0.0, float(cfg.vocab - 1)).to(torch.int64)
    # deterministic n-gram structure so a model can actually learn:
    # every third token repeats the hash of its two predecessors
    mix = _hash((toks[:, :-2] * 31 + toks[:, 1:-1]) & _M32)
    learned = mix % cfg.vocab
    pos = torch.arange(2, cfg.seq_len + 1, device=dev)[None, :]
    toks[:, 2:] = torch.where(pos % 3 == 0, learned, toks[:, 2:])
    toks = toks.to(torch.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def host_iter(cfg: DataConfig, host_id: int, n_hosts: int,
              start_step: int = 0, device=None):
    per = cfg.global_batch // n_hosts
    step = start_step
    while True:
        yield batch_at(cfg, step, host_rows=(host_id * per, per),
                       device=device)
        step += 1
