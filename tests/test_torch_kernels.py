"""The port's table-walk and block-copy kernels against the JAX package's
Pallas kernels (interpret mode) on the shapes of tests/test_kernels.py,
and their fused forms (``block_copy_pools`` over several pool pairs,
``pt_walk_rows_any``: gathered rows walked and reduced to a flag each)
against those kernels call by call.

On the CPU the port's wrappers run their plain versions; the CUDA
kernels are held against those plain versions in tests/test_torch_cuda.py.
Everything is integer or copy work, so every comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.block_copy import block_copy_kernel
from repro.kernels.pt_walk import pt_walk_kernel
from repro_torch.kernels import ops
from test_torch_engine import fresh_jax_caches  # noqa: F401 (autouse)


def to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def as_np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def walk_inputs(rng, n_leaf, fanout, n, holes=(0,), invalid_frac=0.0):
    upper = rng.permutation(n_leaf).astype(np.int32)
    kill = rng.random(n_leaf) < invalid_frac
    kill[list(holes)] = True
    upper[kill] = -1
    ltier = rng.integers(0, 2, n_leaf).astype(np.int32)
    lent = rng.integers(0, 64, (n_leaf, fanout)).astype(np.int32)
    vb = rng.integers(0, n_leaf * fanout, n).astype(np.int32)
    return upper, ltier, lent, vb


def jax_walk(upper, ltier, lent, vb, q_block=256):
    t, s = pt_walk_kernel(jnp.asarray(upper), jnp.asarray(ltier),
                          jnp.asarray(lent), jnp.asarray(vb),
                          q_block=q_block, interpret=True)
    return np.asarray(t), np.asarray(s)


# (n_leaf, fanout, n, q_block, hole, invalid_frac): the shapes of
# test_pt_walk_sweep, _invalid_entries, _grid_tiling and _non_divisible_n
WALK_CASES = [
    (4, 64, 256, 256, 0, 0.0), (16, 64, 512, 256, 0, 0.0),
    (8, 128, 1024, 256, 0, 0.0),
    (16, 64, 512, 256, None, 0.0), (16, 64, 512, 256, 0, 0.5),
    (16, 64, 512, 256, 0, 1.0),
    (8, 128, 512, 64, 1, 0.0), (8, 128, 1024, 128, 1, 0.0),
    (8, 128, 768, 256, 1, 0.0),
    (8, 64, 5, 64, 2, 0.0), (8, 64, 100, 64, 2, 0.0),
    (8, 64, 300, 256, 2, 0.0), (8, 64, 257, 128, 2, 0.0),
    (8, 64, 769, 256, 2, 0.0),
]


@pytest.mark.parametrize("n_leaf,fanout,n,q_block,hole,invalid_frac",
                         WALK_CASES)
def test_pt_walk_matches_jax(n_leaf, fanout, n, q_block, hole, invalid_frac):
    rng = np.random.default_rng(n_leaf * 1000 + n)
    holes = () if hole is None else (hole,)
    upper, ltier, lent, vb = walk_inputs(rng, n_leaf, fanout, n, holes,
                                         invalid_frac)
    if invalid_frac:                  # walk every upper slot, holes included
        vb[:n_leaf] = np.arange(n_leaf, dtype=np.int32) * fanout
    wt, ws = jax_walk(upper, ltier, lent, vb, q_block)
    t, s = ops.pt_walk(*map(to_torch, (upper, ltier, lent, vb)))
    assert t.dtype == s.dtype == torch.int32 and t.shape == (n,)
    np.testing.assert_array_equal(t.numpy(), wt)
    np.testing.assert_array_equal(s.numpy(), ws)


@pytest.mark.parametrize("rows,n_leaf,max_leaf,n", [
    (4, 16, 1, 32), (3, 12, 4, 200), (1, 8, 8, 512)])
def test_pt_walk_batched_rows_match_jax(rows, n_leaf, max_leaf, n):
    """One batched call over R table rows == R single-row JAX walks."""
    rng = np.random.default_rng(rows + n)
    fanout = 64
    upper = rng.integers(-1, n_leaf, (rows, max_leaf)).astype(np.int32)
    ltier = rng.integers(-1, 2, n_leaf).astype(np.int32)
    lent = rng.integers(-1, 64, (n_leaf, fanout)).astype(np.int32)
    vb = np.arange(n, dtype=np.int32) % (max_leaf * fanout)
    t, s = ops.pt_walk(*map(to_torch, (upper, ltier, lent, vb)))
    assert t.shape == (rows, n)
    for r in range(rows):
        wt, ws = jax_walk(upper[r], ltier, lent, vb)
        np.testing.assert_array_equal(t[r].numpy(), wt)
        np.testing.assert_array_equal(s[r].numpy(), ws)


def test_pt_walk_strided_entries_match_jax():
    """Leaf entries passed as the slot column of a [n_leaf, F, 2] table
    (the engine's layout, no copy) walk as the contiguous table does."""
    rng = np.random.default_rng(5)
    upper, ltier, lent, vb = walk_inputs(rng, 16, 64, 512, invalid_frac=0.25)
    table = np.stack([rng.integers(0, 2, lent.shape), lent], -1)
    strided = to_torch(table.astype(np.int32))[:, :, 1]
    assert not strided.is_contiguous()
    wt, ws = jax_walk(upper, ltier, lent, vb)
    t, s = ops.pt_walk(to_torch(upper), to_torch(ltier), strided, to_torch(vb))
    np.testing.assert_array_equal(t.numpy(), wt)
    np.testing.assert_array_equal(s.numpy(), ws)


# queries past the upper row and below zero, a leaf id past the table:
# JAX wraps a negative index once, then clamps every gather into range
OUT_OF_RANGE = dict(upper=[2, -1, 0, 1], leaf_tier=[0, 1, 1],
                    leaf_entries=np.arange(12).reshape(3, 4),
                    vb=[0, 5, 17, 40, -1, -100, -17, 3])
OUT_OF_RANGE_WANT = ([1, -1, 1, 1, 1, 1, 1, 1], [8, -1, 5, 4, 7, 8, 11, 11])


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("first_leaf", [2, 5])    # 5: past the 3 leaf pages
def test_pt_walk_out_of_range_queries_match_jax(first_leaf, batched):
    case = {k: np.asarray(v, np.int32) for k, v in OUT_OF_RANGE.items()}
    case["upper"][0] = first_leaf
    wt, ws = jax_walk(*case.values())
    np.testing.assert_array_equal(wt, OUT_OF_RANGE_WANT[0])
    np.testing.assert_array_equal(ws, OUT_OF_RANGE_WANT[1])
    upper = to_torch(case["upper"])
    if batched:
        upper = torch.stack([upper, torch.full_like(upper, -1)])
    t, s = ops.pt_walk(upper, *map(to_torch, list(case.values())[1:]))
    if batched:
        assert (t[1] == -1).all() and (s[1] == -1).all()
        t, s = t[0], s[0]
    np.testing.assert_array_equal(t.numpy(), wt)
    np.testing.assert_array_equal(s.numpy(), ws)


def copy_inputs(rng, p_src, p_dst, tail, m, dtype, groups=None):
    lead = () if groups is None else (groups,)
    src = jnp.asarray(rng.normal(size=lead + (p_src,) + tail), dtype)
    dst = jnp.asarray(rng.normal(size=lead + (p_dst,) + tail), dtype)
    ids = np.stack([rng.choice(p_src, size=m, replace=False),
                    rng.choice(p_dst, size=m, replace=False)], 1)
    return src, dst, ids.astype(np.int32)


@pytest.mark.parametrize("P,bs,KH,Dh,M", [
    (8, 8, 1, 128, 1), (16, 16, 2, 128, 5), (32, 8, 4, 256, 12)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_block_copy_matches_jax(P, bs, KH, Dh, M, dtype):
    rng = np.random.default_rng(P * M)
    src, dst, ids = copy_inputs(rng, P, P, (bs, KH, Dh), M, dtype)
    want = block_copy_kernel(src, dst, jnp.asarray(ids), interpret=True)
    tsrc, tdst = to_torch(src), to_torch(dst)
    got = ops.block_copy(tsrc, tdst, to_torch(ids))
    assert got is tdst                           # in place
    np.testing.assert_array_equal(as_np(got), np.asarray(want, np.float32))
    np.testing.assert_array_equal(as_np(tsrc), np.asarray(src, np.float32))


@pytest.mark.parametrize("G,p_src,p_dst,M", [(3, 12, 5, 4), (2, 6, 20, 6)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_block_copy_grouped_matches_jax(G, p_src, p_dst, M, dtype):
    """One grouped call over [G, P, bs, KH, Dh] pools of different P ==
    the JAX kernel group by group."""
    rng = np.random.default_rng(G * 100 + M)
    src, dst, ids = copy_inputs(rng, p_src, p_dst, (4, 2, 8), M, dtype, G)
    got = ops.block_copy(to_torch(src), to_torch(dst), to_torch(ids))
    for g in range(G):
        want = block_copy_kernel(src[g], dst[g], jnp.asarray(ids),
                                 interpret=True)
        np.testing.assert_array_equal(as_np(got[g]),
                                      np.asarray(want, np.float32))


@pytest.mark.parametrize("M", [0, 1, 6])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("n_pairs", [1, 2])
def test_block_copy_pools_match_jax(n_pairs, dtype, G, M):
    """One call over 1 or 2 pool pairs sharing ``ids`` == one JAX kernel
    call per pair (and group).  G = 1 takes [P, bs, KH, Dh] pools, G = 3
    [G, P, bs, KH, Dh] ones; M = 0 leaves the pools as they were (the JAX
    kernel cannot take M = 0: its index maps read ids[0])."""
    rng = np.random.default_rng(n_pairs * 1000 + G * 10 + M)
    groups = None if G == 1 else G
    pairs = [copy_inputs(rng, 9, 7, (4, 2, 8), M, dtype, groups)
             for _ in range(n_pairs)]
    ids = pairs[0][2]
    tpairs = [(to_torch(s), to_torch(d)) for s, d, _ in pairs]
    got = ops.block_copy_pools(tpairs, to_torch(ids))
    assert len(got) == n_pairs
    for (src, dst, _), (tsrc, tdst), out in zip(pairs, tpairs, got):
        assert out is tdst                       # in place
        np.testing.assert_array_equal(as_np(tsrc), np.asarray(src, np.float32))
        for g in range(G):
            s, d = (src, dst) if groups is None else (src[g], dst[g])
            want = d if M == 0 else block_copy_kernel(
                s, d, jnp.asarray(ids), interpret=True)
            o = out if groups is None else out[g]
            np.testing.assert_array_equal(as_np(o), np.asarray(want, np.float32))


# (src, dst) pairs outside a pool of P = 4, and what JAX's oracle does
# with each (src -> dst, or None where it writes nothing): a negative id
# counts from the end once, a source is then clamped into the pool, a
# destination still outside it is dropped
OUT_OF_RANGE_IDS = [([4, 0], (3, 0)), ([-1, 1], (3, 1)), ([0, 4], None),
                    ([3, -2], (3, 2)), ([-5, 0], (0, 0)), ([0, -5], None),
                    ([7, 2], (3, 2))]


@pytest.mark.parametrize("pools", [False, True],
                         ids=["block_copy", "block_copy_pools"])
@pytest.mark.parametrize("pair,copies", OUT_OF_RANGE_IDS,
                         ids=[str(p) for p, _ in OUT_OF_RANGE_IDS])
def test_block_copy_out_of_range_ids_match_jax(pair, copies, pools):
    """One id pair outside the pools: the port's plain route equals JAX's
    oracle ``ref.block_copy_ref`` and its ``ops.block_copy`` (off the
    TPU), through ``ops.block_copy`` and through ``ops.block_copy_pools``
    over two pool pairs."""
    rng = np.random.default_rng(abs(pair[0]) * 10 + abs(pair[1]))
    srcs = [jnp.asarray(rng.normal(size=(4, 2, 1, 8)), jnp.float32)
            for _ in range(2)]
    dsts = [jnp.asarray(rng.normal(size=(4, 2, 1, 8)), jnp.float32)
            for _ in range(2)]
    ids = np.asarray([pair], np.int32)
    tsrcs, tdsts = [to_torch(a) for a in srcs], [to_torch(a) for a in dsts]
    if pools:
        got = ops.block_copy_pools(list(zip(tsrcs, tdsts)), to_torch(ids))
    else:
        got = [ops.block_copy(tsrcs[0], tdsts[0], to_torch(ids))]
    for src, dst, out in zip(srcs, dsts, got):
        want = jref.block_copy_ref(src, dst, jnp.asarray(ids))
        np.testing.assert_array_equal(
            np.asarray(jops.block_copy(src, dst, jnp.asarray(ids))), want)
        np.testing.assert_array_equal(as_np(out), np.asarray(want))
        expect = np.asarray(dst).copy()
        if copies is not None:
            expect[copies[1]] = np.asarray(src)[copies[0]]
        np.testing.assert_array_equal(as_np(out), expect)


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_block_copy_out_of_range_ids_across_pool_sizes_match_jax(dtype, G):
    """Pools of 6 and 3 blocks (each id counted from the end of its own
    pool), in range and out of range ids mixed, no destination repeated:
    one ``block_copy_pools`` call over two pairs (and ``block_copy`` over
    the first) equals JAX's oracle group by group."""
    rng = np.random.default_rng(G * 7)
    lead = () if G == 1 else (G,)
    srcs = [jnp.asarray(rng.normal(size=lead + (6, 4, 2, 8)), dtype)
            for _ in range(2)]
    dsts = [jnp.asarray(rng.normal(size=lead + (3, 4, 2, 8)), dtype)
            for _ in range(2)]
    # copies 5 -> 2, 0 -> 1 (-7 -> -1 -> 0), 5 -> 0 (9 clamped, -3 -> 0);
    # drops the pairs with destinations 3 and -4
    ids = np.asarray([[-1, -1], [2, 3], [-7, 1], [4, -4], [9, -3]], np.int32)
    tpairs = [(to_torch(s), to_torch(d)) for s, d in zip(srcs, dsts)]
    got = ops.block_copy_pools(tpairs, to_torch(ids))
    first = ops.block_copy(to_torch(srcs[0]), to_torch(dsts[0]), to_torch(ids))
    for src, dst, out in zip(srcs, dsts, got):
        for g in range(G):
            s, d = (src, dst) if G == 1 else (src[g], dst[g])
            o = out if G == 1 else out[g]
            want = np.asarray(jref.block_copy_ref(s, d, jnp.asarray(ids)),
                              np.float32)
            np.testing.assert_array_equal(as_np(o), want)
            expect = np.asarray(d, np.float32).copy()
            expect[[2, 1, 0]] = np.asarray(s, np.float32)[[5, 0, 5]]
            np.testing.assert_array_equal(as_np(o), expect)
    np.testing.assert_array_equal(as_np(first), as_np(got[0]))


def rows_any_inputs(rng, r, n_seqs, n_leaf, max_leaf, n):
    """A table of ``n_seqs`` rows, the ``r`` row ids to walk, and queries
    past both ends of the upper row.  Leaf page ``l`` has tier ``l % 3 -
    1``, and each row maps leaf pages of one tier only (rows of tier -1
    also hold unallocated entries).  The row ids count from the end (-1)
    or lie past the table (both reach the last row), and the distinct
    rows they reach take the three tiers in turn, so every tier value is
    read by some of the walked rows and not by others."""
    rows = rng.permutation(n_seqs - 1)[:r].astype(np.int32)
    rows[0] = -1
    if r >= 4:
        rows[1] = n_seqs + 2
    reached = np.clip(np.where(rows < 0, rows + n_seqs, rows), 0, n_seqs - 1)
    cls = rng.integers(0, 3, n_seqs)
    for k, row in enumerate(dict.fromkeys(reached.tolist())):
        cls[row] = k % 3
    ltier = (np.arange(n_leaf) % 3 - 1).astype(np.int32)
    upper = np.empty((n_seqs, max_leaf), np.int32)
    for i in range(n_seqs):
        upper[i] = rng.choice(np.arange(cls[i], n_leaf, 3), max_leaf)
        if cls[i] == 0:
            upper[i, rng.random(max_leaf) < 0.3] = -1
    lent = rng.integers(-1, 64, (n_leaf, 64)).astype(np.int32)
    vb = rng.integers(-2 * 64, (max_leaf + 1) * 64, n).astype(np.int32)
    return upper, rows, ltier, lent, vb


# (R, n_seqs, n_leaf, max_leaf, N): the serve_tiered and kv_tiering decode
# ticks' shapes, and larger ones (several warps per row's queries, rows
# over several CTAs)
ROWS_ANY_CASES = [(4, 16, 16, 1, 32), (4, 12, 12, 1, 10), (3, 5, 8, 4, 200),
                  (33, 40, 12, 40, 100)]


@pytest.mark.parametrize("tier", [0, 1, -1])
@pytest.mark.parametrize("r,n_seqs,n_leaf,max_leaf,n", ROWS_ANY_CASES)
def test_pt_walk_rows_any_matches_jax(r, n_seqs, n_leaf, max_leaf, n, tier):
    """flags[r] == any over the queries of (JAX walk of the gathered row
    == tier), the row gathered as JAX gathers, the walk the TPU kernel in
    interpret mode, the reduction numpy's."""
    rng = np.random.default_rng(r * 100 + n + tier)
    upper, rows, ltier, lent, vb = rows_any_inputs(rng, r, n_seqs, n_leaf,
                                                   max_leaf, n)
    gathered = np.asarray(jnp.asarray(upper)[jnp.asarray(rows)])
    want = [int((jax_walk(row, ltier, lent, vb)[0] == tier).any())
            for row in gathered]
    strided = to_torch(np.stack([lent, lent], -1))[:, :, 1]
    got = ops.pt_walk_rows_any(to_torch(upper), to_torch(rows),
                               to_torch(ltier), strided, to_torch(vb), tier)
    assert got.dtype == torch.int32 and got.shape == (r,)
    assert got.tolist() == want
    assert 0 < sum(want) < r


def test_pt_walk_rows_any_out_of_range_queries_match_jax():
    """The out-of-range table above, through the flags."""
    case = {k: np.asarray(v, np.int32) for k, v in OUT_OF_RANGE.items()}
    upper = np.stack([case["upper"], np.full(4, -1, np.int32)])
    rest = [to_torch(case[k]) for k in ("leaf_tier", "leaf_entries", "vb")]
    for rows, tier in (([0, 1, 0], 1), ([1, -2, 5], -1), ([0, -1], 0)):
        gathered = np.asarray(jnp.asarray(upper)[jnp.asarray(rows)])
        want = [int((jax_walk(row, *(case[k] for k in (
            "leaf_tier", "leaf_entries", "vb")))[0] == tier).any())
            for row in gathered]
        got = ops.pt_walk_rows_any(to_torch(upper),
                                   torch.tensor(rows, dtype=torch.int32),
                                   *rest, tier)
        assert got.tolist() == want


def _pool(p=4, dtype=torch.float32):
    return torch.zeros(2, p, 4, 2, 8, dtype=dtype)


# (what, pairs, message): each breaks one rule of block_copy_pools
BAD_POOL_PAIRS = [
    ("no pair", lambda: [], "1 to 2 pool pairs"),
    ("five pairs", lambda: [(_pool(), _pool()) for _ in range(5)],
     "1 to 2 pool pairs"),
    ("second pair of another shape", lambda: [(_pool(), _pool()),
                                              (_pool(), _pool(6))],
     "shapes and dtype of the first"),
    ("second pair of another dtype", lambda: [
        (_pool(), _pool()), (_pool(dtype=torch.bfloat16),
                             _pool(dtype=torch.bfloat16))],
     "shapes and dtype of the first"),
    ("a source that is another pair's destination", lambda: (
        lambda a, b, c: [(a, b), (b, c)])(_pool(), _pool(), _pool()),
     "different pools"),
    ("a repeated destination", lambda: (
        lambda a, b, c: [(a, c), (b, c)])(_pool(), _pool(), _pool()),
     "destination pool repeats"),
    ("second pair off 16 bytes", lambda: [
        (_pool(), _pool()),
        (torch.zeros(2 * 4 * 4 * 2 * 8 + 1)[1:].view(2, 4, 4, 2, 8), _pool())],
     "16-byte boundary"),
]


@pytest.mark.parametrize("what,pairs,msg", BAD_POOL_PAIRS,
                         ids=[b[0] for b in BAD_POOL_PAIRS])
def test_block_copy_pools_rejects_bad_pairs(what, pairs, msg):
    ids = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match=msg):
        ops.block_copy_pools(pairs(), ids)


def test_wrappers_reject_bad_arguments():
    walk = [torch.zeros(2, dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
            torch.zeros(4, 64, dtype=torch.int32), torch.zeros(8, dtype=torch.int32)]
    with pytest.raises(ValueError, match="int32"):
        ops.pt_walk(walk[0].long(), *walk[1:])
    with pytest.raises(ValueError, match="contiguous"):
        ops.pt_walk(walk[0], walk[1], walk[2],
                    torch.zeros(16, dtype=torch.int32)[::2])
    with pytest.raises(ValueError, match="empty"):
        ops.pt_walk(walk[0][:0], *walk[1:])
    pool = torch.zeros(2, 4, 4, 2, 8)
    ids = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.block_copy(torch.zeros(4, 1, 1, 3), torch.zeros(4, 1, 1, 3), ids)
    with pytest.raises(ValueError, match="16-byte boundary"):
        flat = torch.zeros(4 * 4 * 2 * 8 + 1)
        ops.block_copy(flat[1:].view(4, 4, 2, 8), pool[0].clone(), ids)
    with pytest.raises(ValueError, match="dtypes differ"):
        ops.block_copy(pool, pool.clone().bfloat16(), ids)
    with pytest.raises(ValueError, match="beyond P"):
        ops.block_copy(pool, torch.zeros(2, 4, 4, 2, 4), ids)
    with pytest.raises(ValueError, match="different pools"):
        ops.block_copy(pool, pool, ids)
    with pytest.raises(ValueError, match=r"int32 \[M, 2\]"):
        ops.block_copy(pool, pool.clone(), ids.long())
    table = torch.zeros(3, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        ops.pt_walk_rows_any(table, walk[0].long(), *walk[1:], 1)
    with pytest.raises(ValueError, match=r"\[n_rows, max_leaf\]"):
        ops.pt_walk_rows_any(walk[0], walk[0], *walk[1:], 1)


def test_plain_versions_count_no_launches():
    ops.reset_launches()
    rng = np.random.default_rng(0)
    ops.pt_walk(*map(to_torch, walk_inputs(rng, 4, 64, 16)))
    pool = torch.zeros(2, 4, 4, 2, 8)
    ids = torch.tensor([[0, 1]], dtype=torch.int32)
    ops.block_copy(pool, pool.clone(), ids)
    ops.block_copy_pools([(pool, pool.clone()), (pool.clone(), pool.clone())],
                         ids)
    table = torch.zeros(3, 2, dtype=torch.int32)
    ops.pt_walk_rows_any(table, torch.tensor([0, 2], dtype=torch.int32),
                         *map(to_torch, walk_inputs(rng, 4, 64, 16)[1:]), 1)
    i32 = dict(dtype=torch.int32)
    ops.alloc_scan(torch.full((1, 4), 5, **i32), torch.ones((1, 4), **i32),
                   torch.zeros(1, **i32), torch.zeros(1, dtype=torch.bool),
                   torch.full((4,), 2, **i32), torch.ones(1, **i32),
                   torch.full((1,), 12, **i32),
                   torch.ones((1, 4, 4), dtype=torch.bool),
                   torch.ones((1, 4), dtype=torch.bool), n_threads=4,
                   alloc_nodes=(0, 1, 2, 3), thp=False)
    from repro_torch.core import config as cfg
    from repro_torch.kernels import ref
    args, kw = ref.fast_window_inputs(cfg.MachineConfig(n_threads=4), 1, 3, 4, 0)
    ops.fast_window(*args, **kw)
    assert ops.launch_counts() == {"pt_walk": 0, "block_copy": 0,
                                   "paged_attention": 0, "alloc_scan": 0,
                                   "fast_window": 0}

