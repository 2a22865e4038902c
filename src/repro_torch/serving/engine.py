"""Continuous-batching serving engine over the tiered paged-KV cache
(twin of the JAX package's ``serving/engine.py``; same scheduler).

ACTIVE sequences decode in a fixed-size batch with their blocks (and,
under Radiant, their leaf table pages) HOT.  A PAUSED sequence's blocks
are demoted; the last demotion drags its leaf page cold.  RESUME promotes
them back.  ``radiant=False`` keeps leaf pages where they were allocated
(the immobile-table baseline), so resumed sequences walk cold pages.

Each decode tick walks the active sequences' tables with one launch of
the ``pt_walk`` kernel, which also reduces each walk to a flag, and
counts, per sequence, whether the walk read a COLD leaf page
(``EngineStats.cold_walks``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from ..device import resolve_device
from ..kernels import ops
from ..memsys import tiered_kv as tkv


@dataclasses.dataclass
class Request:
    rid: int
    prompt_len: int
    max_new: int
    generated: int = 0
    state: str = "queued"      # queued | active | paused | done


@dataclasses.dataclass
class EngineStats:
    steps: int = 0
    tokens: int = 0
    swaps_in: int = 0
    swaps_out: int = 0
    cold_walks: int = 0        # decode steps whose table walk touched COLD


class TieredServingEngine:
    """Scheduler + tiered KV; the model's decode fn is injected."""

    def __init__(self, *, n_groups: int, kv_heads: int, head_dim: int,
                 block_size: int = 16, n_hot_blocks: int = 256,
                 n_cold_blocks: int = 1024, n_seqs: int = 64,
                 max_seq: int = 4096, active_slots: int = 4,
                 radiant: bool = True, dtype=torch.bfloat16, device=None):
        self.device = resolve_device(device)
        self.kv = tkv.init(n_groups, n_hot_blocks, n_cold_blocks, block_size,
                           kv_heads, head_dim, n_seqs, max_seq, dtype=dtype,
                           device=self.device)
        self.block_size = block_size
        self.active_slots = active_slots
        self.max_seq = max_seq
        self.radiant = radiant
        self.requests: Dict[int, Request] = {}
        self.active: List[int] = []
        self.queued: List[int] = []
        self.paused: List[int] = []
        self.stats = EngineStats()
        # the walk's queries: every virtual block a sequence can hold
        self._vb = torch.arange(self._max_blocks(), dtype=torch.int32,
                                device=self.device)

    # ------------------------------------------------------------------ API
    def submit(self, req: Request):
        self.requests[req.rid] = req
        self.queued.append(req.rid)

    def _max_blocks(self) -> int:
        return -(-self.max_seq // self.block_size)

    def _migrate(self, rid: int, to_tier: int):
        tkv.migrate_sequence(self.kv, rid, to_tier, self._max_blocks(),
                             trigger_leaf=self.radiant)

    def _swap_out(self, rid: int):
        self._migrate(rid, tkv.COLD)
        self.requests[rid].state = "paused"
        self.paused.append(rid)
        self.stats.swaps_out += 1

    def _swap_in(self, rid: int):
        self._migrate(rid, tkv.HOT)
        self.requests[rid].state = "active"
        self.active.append(rid)
        self.stats.swaps_in += 1

    def schedule(self):
        """Round-robin fairness: rotate one active seq out when the queue
        has waiters; fill free slots from paused-then-queued."""
        if (self.queued or self.paused) and len(self.active) >= self.active_slots:
            victim = self.active.pop(0)
            self._swap_out(victim)
        while len(self.active) < self.active_slots:
            if self.paused:
                self._swap_in(self.paused.pop(0))
            elif self.queued:
                # activation == promotion: a prompt that spilled to the cold
                # pool is pulled hot (with its leaf pages, under Radiant)
                rid = self.queued.pop(0)
                self._migrate(rid, tkv.HOT)
                self.requests[rid].state = "active"
                self.active.append(rid)
            else:
                break

    def prefill(self, rid: int, kv_tokens):
        """Write prompt KV ([prompt_len, G, KH, Dh] pair) for a request."""
        k_toks, v_toks = kv_tokens
        for t in range(self.requests[rid].prompt_len):
            tkv.append_token(self.kv, rid, k_toks[t], v_toks[t])

    def _cold_walks(self, rids: List[int]) -> List[bool]:
        """Per sequence: does a walk of its table read a COLD leaf page?
        One launch gathers the rows of ``upper``, walks them and reduces
        each row to a flag (``ops.pt_walk_rows_any``; the walk's tier is
        the leaf page's, -1 through unallocated upper entries); then one
        read of the R flags.  The leaf entries are the slot column of
        ``leaf_tier_slot``, passed as a strided view."""
        if not rids:
            return []
        rows = torch.tensor(rids, dtype=torch.int32, device=self.device)
        flags = ops.pt_walk_rows_any(self.kv.upper, rows, self.kv.leaf_tier,
                                     self.kv.leaf_tier_slot[:, :, 1],
                                     self._vb, tkv.COLD)
        return [bool(f) for f in flags.tolist()]

    def decode_tick(self, decode_fn) -> Dict[int, int]:
        """One decode step for the active batch.

        ``decode_fn(kv, rid) -> (k_new, v_new)`` produces a sequence's
        next-token KV ([G, KH, Dh]); the engine appends it and advances
        bookkeeping.  The tables are walked as they stand at the start of
        the tick.  Returns {rid: new_len}.
        """
        out = {}
        rids = list(self.active)
        for rid, cold in zip(rids, self._cold_walks(rids)):
            if cold:                 # never under Radiant for active seqs
                self.stats.cold_walks += 1
            k_new, v_new = decode_fn(self.kv, rid)
            tkv.append_token(self.kv, rid, k_new, v_new)
            req = self.requests[rid]
            req.generated += 1
            self.stats.tokens += 1
            out[rid] = req.prompt_len + req.generated
            if req.generated >= req.max_new:
                req.state = "done"
                self.active.remove(rid)
                # free blocks + table pages (PT pages are reclaimed when
                # their data pages are freed)
                tkv.release_sequence(self.kv, rid, self._max_blocks())
        self.stats.steps += 1
        return out

    def run(self, decode_fn, max_ticks: int = 10000) -> EngineStats:
        ticks = 0
        while (self.queued or self.paused or self.active) \
                and ticks < max_ticks:
            self.schedule()
            if not self.active:
                break
            self.decode_tick(decode_fn)
            ticks += 1
        return self.stats
