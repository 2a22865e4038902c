"""The port's table-walk and block-copy kernels against the JAX package's
Pallas kernels (interpret mode) on the shapes of tests/test_kernels.py.

On the CPU the port's wrappers run their plain versions; the CUDA
kernels are held against those plain versions in tests/test_torch_cuda.py.
Everything is integer or copy work, so every comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.block_copy import block_copy_kernel
from repro.kernels.pt_walk import pt_walk_kernel
from repro_torch.kernels import ops


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


def test_plain_versions_count_no_launches():
    ops.reset_launches()
    rng = np.random.default_rng(0)
    ops.pt_walk(*map(to_torch, walk_inputs(rng, 4, 64, 16)))
    pool = torch.zeros(2, 4, 4, 2, 8)
    ops.block_copy(pool, pool.clone(), torch.tensor([[0, 1]], dtype=torch.int32))
    assert ops.launch_counts() == {"pt_walk": 0, "block_copy": 0,
                                   "paged_attention": 0}

