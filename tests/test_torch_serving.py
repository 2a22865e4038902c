"""The port's serving engine and served bursts against the JAX package's.

Both engines run the same scheduler over the same numpy-made KV; after
the run their EngineStats, request states, kv stats, tables, free lists
and pools must be equal, exactly.  ``cold_walks`` is counted by the port
with one batched pt_walk per tick and by the reference on the host.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import kv_tiering
from repro.serving.engine import Request as JRequest
from repro.serving.engine import TieredServingEngine as JEngine
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.memsys import tiered_kv as tkv
from repro_torch.serving import serve_tiered as st
from repro_torch.serving.engine import Request, TieredServingEngine

GEO = configs.REDUCED            # Qwen1.5-0.5B at configs.reduced width


def bf16(a):
    """numpy float32 -> (JAX bf16, the same values as a torch bf16)."""
    j = jnp.asarray(a, jnp.bfloat16)
    t = torch.from_numpy(np.asarray(j).view(np.int16).copy()).view(
        torch.bfloat16)
    return j, t


def assert_same_kv(jkv, pkv):
    """Every TieredKV field equal (bf16 pools compared as float32)."""
    got = tkv.to_numpy(pkv)
    for f in tkv.FIELDS:
        want = np.asarray(getattr(jkv, f))
        if f in tkv.POOLS:
            want = want.astype(np.float32)
        np.testing.assert_array_equal(got[f], want, err_msg=f)


def token_kv(rid, t):
    """The stand-in model's KV for ``rid`` at length ``t``, made by numpy."""
    rng = np.random.default_rng(rid * 1000 + t)
    return rng.normal(size=(GEO.n_groups, GEO.kv_heads, GEO.head_dim)) * 0.1


def run_both(radiant, n_hot, n_cold, n_seqs, max_seq, active, prompt, new,
             block_size):
    kw = dict(n_groups=GEO.n_groups, kv_heads=GEO.kv_heads,
              head_dim=GEO.head_dim, block_size=block_size,
              n_hot_blocks=n_hot, n_cold_blocks=n_cold, n_seqs=n_seqs,
              max_seq=max_seq, active_slots=active, radiant=radiant)
    je = JEngine(**kw)
    pe = TieredServingEngine(**kw, device="cpu")
    for rid in range(n_seqs):
        je.submit(JRequest(rid=rid, prompt_len=prompt, max_new=new))
        pe.submit(Request(rid=rid, prompt_len=prompt, max_new=new))
        rng = np.random.default_rng(rid)
        jk, tk = bf16(rng.normal(size=(prompt, GEO.n_groups, GEO.kv_heads,
                                       GEO.head_dim)) * 0.1)
        je.prefill(rid, (jk, jk))
        pe.prefill(rid, (tk, tk))

    def j_decode(kv, rid):
        k = bf16(token_kv(rid, int(np.asarray(kv.seq_len[rid]))))[0]
        return k, k

    def p_decode(kv, rid):
        k = bf16(token_kv(rid, int(kv.seq_len[rid])))[1]
        return k, k

    jstats = je.run(j_decode, max_ticks=500)
    ops.reset_launches()
    pstats = pe.run(p_decode, max_ticks=500)
    assert ops.launch_counts() == {"pt_walk": 0, "block_copy": 0,
                                   "paged_attention": 0, "alloc_scan": 0,
                                   "fast_window": 0}            # CPU
    assert dataclasses.asdict(pstats) == dataclasses.asdict(jstats)
    assert {r: q.state for r, q in pe.requests.items()} == \
        {r: q.state for r, q in je.requests.items()}
    assert_same_kv(je.kv, pe.kv)
    return pe, pstats


@pytest.mark.parametrize("radiant,n_hot", [(True, 12), (False, 12),
                                           (True, 32)])
def test_engine_matches_jax_test_serving_build(radiant, n_hot):
    """tests/test_serving.py's build (6 requests of 24 + 8 tokens, two
    active slots; 12 hot blocks is its pressure case)."""
    pe, stats = run_both(radiant, n_hot, 256, 6, 96, 2, 24, 8, 8)
    assert all(r.state == "done" for r in pe.requests.values())
    assert stats.tokens == 6 * 8
    if radiant:
        assert stats.cold_walks == 0
        assert int(tkv.table_invariant_violations(pe.kv)) == 0


QUICK = dataclasses.replace(st.PRESSURE, n_seqs=8, max_seq=64 + 16 + 32,
                            prompts=(64,) * 8, max_new=16,
                            max_ticks=8 * 16 * 4)


@pytest.mark.parametrize("radiant", [True, False])
def test_pressure_burst_matches_kv_tiering(radiant):
    """The whole slice through its entry point: the port's pressure burst
    at kv_tiering's own width (2 groups, 2 KV heads, d_head 128) and its
    quick size equals ``benchmarks/kv_tiering.py::run_engine``."""
    geo = configs.KVGeometry(2, 2, 128)
    jeng, jstats, _, jviol = kv_tiering.run_engine(radiant, 8, 64, 16)
    res = st.serve(QUICK, radiant=radiant, geometry=geo, device="cpu")
    assert dataclasses.asdict(res.stats) == dataclasses.asdict(jstats)
    assert res.violations == jviol == 0
    assert_same_kv(jeng.kv, res.engine.kv)


def test_pressure_burst_radiant_against_immobile():
    """The full PRESSURE burst at reduced width: Radiant walks no cold leaf
    page, immobile tables do (tests/test_serving.py's contrast)."""
    rad = st.serve(st.PRESSURE, radiant=True, geometry=GEO, device="cpu")
    imm = st.serve(st.PRESSURE, radiant=False, geometry=GEO, device="cpu")
    for res in (rad, imm):
        assert all(r.state == "done" for r in res.engine.requests.values())
        assert res.stats.tokens == 12 * 24
    assert rad.stats.cold_walks == 0 and rad.violations == 0
    assert int(rad.engine.kv.stats[tkv.STAT_LEAF_DEMOTE]) > 0
    assert imm.stats.cold_walks > 0


def test_serve_tiered_burst_runs_clean_on_cpu():
    """examples/serve_tiered.py's burst at reduced width: every request
    done, no cold walk, no invariant violation."""
    res = st.serve(st.SERVE_TIERED, geometry=GEO, device="cpu")
    assert all(r.state == "done" for r in res.engine.requests.values())
    assert res.stats.tokens == 10 * 32
    assert res.stats.cold_walks == 0 and res.violations == 0
    assert res.stats.swaps_out > 0
    kv = res.engine.kv
    assert int(kv.hot_free_top) == kv.hot_k.shape[1]
    assert int(kv.leaf_free_top) == kv.leaf_tier.shape[0]


def test_walk_equals_host_check():
    """The engine's batched walk flags exactly the rows whose upper entries
    reach a COLD leaf page (the reference's host check)."""
    eng = TieredServingEngine(n_groups=1, kv_heads=1, head_dim=8,
                              block_size=4, n_hot_blocks=4, n_cold_blocks=64,
                              n_seqs=4, max_seq=4 * 64 * 3, device="cpu")
    k = torch.ones(1, 1, 8, dtype=torch.bfloat16)
    for rid, n in enumerate((3, 300, 600, 0)):
        for _ in range(n):
            tkv.append_token(eng.kv, rid, k, k)
    tkv.migrate_sequence(eng.kv, 2, tkv.COLD, eng._max_blocks())
    upper = eng.kv.upper.numpy()
    tier = eng.kv.leaf_tier.numpy()
    want = [bool(len(u[u >= 0]) and (tier[u[u >= 0]] == tkv.COLD).any())
            for u in upper]
    got = eng._cold_walks([0, 1, 2, 3])
    assert got == want and any(got) and not all(got)


def test_cold_walks_one_walk_call_per_tick(monkeypatch):
    """Each decode tick walks its active rows with one ``pt_walk_rows_any``
    call (gather, walk and reduction in one launch on the card)."""
    rows = []
    walk = ops.pt_walk_rows_any

    def counted(upper, rids, *args):
        rows.append(int(rids.shape[0]))
        return walk(upper, rids, *args)

    monkeypatch.setattr(ops, "pt_walk_rows_any", counted)
    res = st.serve(st.PRESSURE, radiant=False, geometry=GEO, device="cpu")
    assert len(rows) == res.stats.steps and sum(rows) == res.stats.tokens
    assert res.stats.cold_walks > 0
