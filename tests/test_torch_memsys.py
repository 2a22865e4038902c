"""The port's TieredKV ops against the JAX package's, field for field.

Seeded random interleavings of append / demote / promote / release (with
and without the Radiant leaf trigger) run on both packages from the same
numpy-made tokens, on the small geometry of tests/test_memsys.py.  After
every op every field must be equal, exactly: tables, free lists, tops,
stats and pools.  The pool sizes drive the paths the reference hides:
hot-pool exhaustion (cold fallback), full free lists (pushes computed
onto a full list, which JAX drops), and both pools exhausted.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.memsys import tiered_kv as jtkv
from repro_torch.memsys import tiered_kv as tkv

G, KH, DH, BS = 2, 2, 8, 4
MAXB = 64
MAX_SEQ = BS * tkv.FANOUT * 2

j_append = jax.jit(jtkv.append_token)
j_migrate = jax.jit(jtkv.migrate_sequence,
                    static_argnames=("to_tier", "max_blocks", "trigger_leaf"))
j_release = jax.jit(jtkv.release_sequence, static_argnames=("max_blocks",))


def jax_fields(jkv):
    return {f.name: np.asarray(getattr(jkv, f.name))
            for f in dataclasses.fields(jkv)}


def assert_same(jkv, pkv, where=""):
    want, got = jax_fields(jkv), tkv.to_numpy(pkv)
    assert set(want) == set(got) == set(tkv.FIELDS)
    for f in tkv.FIELDS:
        w = np.asarray(want[f], np.float32) if f in tkv.POOLS else want[f]
        assert got[f].dtype == w.dtype, (where, f)
        np.testing.assert_array_equal(got[f], w, err_msg=f"{where}: {f}")


class Both:
    """One JAX and one port TieredKV driven by the same ops."""

    def __init__(self, n_hot, n_cold, n_seqs, dtype):
        self.jdtype = dtype
        tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
        self.j = jtkv.init(G, n_hot, n_cold, BS, KH, DH, n_seqs, MAX_SEQ,
                           dtype=dtype)
        self.p = tkv.init(G, n_hot, n_cold, BS, KH, DH, n_seqs, MAX_SEQ,
                          dtype=tdtype, device="cpu")
        assert_same(self.j, self.p, "init")

    def append(self, seq, k, v):
        jk, jv = jnp.asarray(k, self.jdtype), jnp.asarray(v, self.jdtype)
        self.j = j_append(self.j, jnp.asarray(seq), jk, jv)
        out = tkv.append_token(self.p, seq, to_torch(jk), to_torch(jv))
        assert out is self.p

    def migrate(self, seq, to_tier, trigger=True):
        self.j = j_migrate(self.j, jnp.asarray(seq), to_tier, MAXB,
                           trigger_leaf=trigger)
        tkv.migrate_sequence(self.p, seq, to_tier, MAXB, trigger_leaf=trigger)

    def release(self, seq):
        self.j = j_release(self.j, jnp.asarray(seq), MAXB)
        tkv.release_sequence(self.p, seq, MAXB)


def to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


OPS = ("append", "demote", "promote", "demote_immobile", "promote_immobile",
       "release")


def run_random(seed, n_hot, n_cold, n_seqs=3, n_ops=24, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    b = Both(n_hot, n_cold, n_seqs, dtype)
    for i in range(n_ops):
        seq = int(rng.integers(0, n_seqs))
        op = OPS[int(rng.integers(0, len(OPS)))]
        if op == "append":
            for _ in range(int(rng.integers(1, 3 * BS))):
                k, v = rng.normal(size=(2, G, KH, DH)).astype(np.float32)
                b.append(seq, k, v)
                assert_same(b.j, b.p, f"op {i} append seq {seq}")
        elif op == "release":
            b.release(seq)
        else:
            to = tkv.HOT if op.startswith("promote") else tkv.COLD
            b.migrate(seq, to, trigger=not op.endswith("immobile"))
        assert_same(b.j, b.p, f"op {i} {op} seq {seq}")
        if i == n_ops // 2:         # carry the JAX state into the port
            b.p = tkv.from_numpy(jax_fields(b.j), device="cpu")
            assert_same(b.j, b.p, "from_numpy")
    assert int(tkv.table_invariant_violations(b.p)) == int(
        jtkv.table_invariant_violations(b.j))
    for s in range(n_seqs):
        for got, want in zip(tkv.lookup_blocks(b.p, s, MAXB),
                             jtkv.lookup_blocks(b.j, jnp.asarray(s), MAXB)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for got, want in zip(tkv.gather_kv(b.p, s, 8),
                             jtkv.gather_kv(b.j, jnp.asarray(s), 8)):
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))
    return b


@pytest.mark.parametrize("seed", range(4))
def test_random_interleavings_match_jax(seed):
    """Hot pool of 6 blocks: appends overflow it into the cold pool."""
    b = run_random(seed, n_hot=6, n_cold=64)
    assert int(b.p.stats[tkv.STAT_BLK_DEMOTE]) + int(
        b.p.stats[tkv.STAT_FALLBACK]) > 0


@pytest.mark.parametrize("seed", range(2))
def test_full_and_exhausted_free_lists_match_jax(seed):
    """Cold pool of 8: demotions fail for want of cold slots, releases
    push onto full lists."""
    run_random(100 + seed, n_hot=4, n_cold=8, n_ops=30)


def test_both_pools_exhausted_match_jax():
    """2 + 2 blocks: tokens past both pools go through the stale entry,
    as the reference writes them."""
    run_random(7, n_hot=2, n_cold=2, n_ops=30)


def test_bf16_pools_match_jax():
    run_random(11, n_hot=6, n_cold=64, dtype=jnp.bfloat16)


def test_push_onto_full_cold_list_is_dropped():
    """With the cold list full, promoting and then releasing an all-hot
    sequence computes pushes at index n_cold; JAX drops them, the port
    never writes them, and both agree on every field."""
    n_cold = 5
    b = Both(8, n_cold, 2, jnp.float32)
    rng = np.random.default_rng(3)
    for _ in range(2 * BS):
        k = rng.normal(size=(G, KH, DH)).astype(np.float32)
        b.append(0, k, k)
    assert int(b.p.cold_free_top) == n_cold
    before = b.p.cold_free.clone()
    b.migrate(0, tkv.HOT)
    assert_same(b.j, b.p, "promote all-hot")
    b.release(0)
    assert_same(b.j, b.p, "release all-hot")
    assert torch.equal(b.p.cold_free, before)
    assert int(b.p.hot_free_top) == 8


def test_leaf_trigger_counts_per_block():
    """STAT_LEAF_ALREADY counts once per valid block of a migration."""
    b = Both(32, 64, 2, jnp.float32)
    k = np.ones((G, KH, DH), np.float32)
    for _ in range(5 * BS):
        b.append(1, k, k)
    already = int(b.p.stats[tkv.STAT_LEAF_ALREADY])
    b.migrate(1, tkv.HOT)             # already hot: 5 blocks, 5 skips
    assert_same(b.j, b.p, "promote hot")
    assert int(b.p.stats[tkv.STAT_LEAF_ALREADY]) == already + 5



@pytest.mark.parametrize("seed", range(3))
def test_migrate_makes_one_copy_call_per_moving_migration(seed, monkeypatch):
    """``migrate_sequence`` moves a migration's blocks with exactly one
    ``block_copy_pools`` call over the K and V pools when it moved blocks,
    and makes none when it moved nothing (counted by wrapping the ops
    function, on the pool sizes that exhaust the hot pool)."""
    from repro_torch.kernels import ops
    calls = []
    copy = ops.block_copy_pools

    def counted(pairs, ids, **kwargs):
        pairs = tuple(pairs)
        calls.append((len(pairs), int(ids.shape[0])))
        return copy(pairs, ids, **kwargs)

    monkeypatch.setattr(ops, "block_copy_pools", counted)
    rng = np.random.default_rng(200 + seed)
    kv = tkv.init(G, 6, 64, BS, KH, DH, 3, MAX_SEQ, dtype=torch.float32,
                  device="cpu")
    moving = still = 0
    for _ in range(40):
        seq = int(rng.integers(0, 3))
        op = int(rng.integers(0, 4))
        if op == 0:
            for _ in range(int(rng.integers(1, 3 * BS))):
                k = torch.from_numpy(rng.normal(size=(G, KH, DH)).astype(
                    np.float32))
                tkv.append_token(kv, seq, k, k)
            continue
        if op == 3:
            tkv.release_sequence(kv, seq, MAXB)
            continue
        before = len(calls)
        moved = int(kv.stats[tkv.STAT_BLK_PROMOTE] + kv.stats[tkv.STAT_BLK_DEMOTE])
        tkv.migrate_sequence(kv, seq, tkv.HOT if op == 1 else tkv.COLD, MAXB)
        moved = int(kv.stats[tkv.STAT_BLK_PROMOTE]
                    + kv.stats[tkv.STAT_BLK_DEMOTE]) - moved
        assert len(calls) - before == (1 if moved else 0)
        if moved:
            assert calls[-1] == (2, moved)
            moving += 1
        else:
            still += 1
    assert moving > 0 and still > 0
