"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Imports no JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py reaches the JAX package.)  Without a
CUDA device every test here skips.
"""
import pytest
import torch

from repro_torch.kernels import ops, ref

# (n_leaf, fanout, n): the walk shapes of tests/test_kernels.py
WALK_SHAPES = [(4, 64, 256), (16, 64, 512), (8, 128, 1024), (8, 128, 512),
               (8, 128, 768), (8, 64, 5), (8, 64, 100), (8, 64, 300),
               (8, 64, 257), (8, 64, 769)]
# (G, P_src, P_dst, M) over [bs 16, KH 16, Dh 64] blocks, Qwen1.5-0.5B's
COPY_SHAPES = [(1, 8, 8, 1), (24, 64, 16, 8), (3, 7, 9, 5)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels have no "
                    "CPU mode (their plain versions are tested against JAX "
                    "in tests/test_torch_kernels.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_pt_walk_kernel_matches_plain_version(cuda_device):
    gen = torch.Generator().manual_seed(7)
    ops.reset_launches()
    for rows in (1, 4):
        for n_leaf, fanout, n in WALK_SHAPES:
            args = [torch.randint(-1, n_leaf, (rows, n_leaf), generator=gen),
                    torch.randint(-1, 2, (n_leaf,), generator=gen),
                    torch.randint(-1, 64, (n_leaf, fanout, 2), generator=gen),
                    torch.randint(0, n_leaf * fanout, (n,), generator=gen)]
            args = [a.to(torch.int32) for a in args]
            dev_args = [a.to(cuda_device) for a in args]
            # the 4-row walks read their entries as the engine does: the
            # slot column of a [n_leaf, F, 2] table, through its strides
            pick = (lambda e: e[:, :, 1]) if rows == 4 else (
                lambda e: e[:, :, 1].contiguous())
            args[2], dev_args[2] = pick(args[2]), pick(dev_args[2])
            want = ref.pt_walk_ref(*args)
            got = ops.pt_walk(*dev_args)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w)
    assert ops.launch_counts()["pt_walk"] == 2 * len(WALK_SHAPES)


@pytest.mark.cuda
def test_pt_walk_kernel_out_of_range_queries(cuda_device):
    """Queries past the upper row and below zero, a leaf id past the
    table: the kernel gives JAX's answer, as the plain version does."""
    args = [torch.tensor(a, dtype=torch.int32) for a in (
        [5, -1, 0, 1], [0, 1, 1], [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]],
        [0, 5, 17, 40, -1, -100, -17, 3])]
    want = ([1, -1, 1, 1, 1, 1, 1, 1], [8, -1, 5, 4, 7, 8, 11, 11])
    for upper in (args[0], torch.stack([args[0], torch.full_like(args[0], -1)])):
        got = ops.pt_walk(upper.to(cuda_device),
                          *[a.to(cuda_device) for a in args[1:]])
        plain = ref.pt_walk_ref(upper, *args[1:])
        for g, p, w in zip(got, plain, want):
            assert torch.equal(g.cpu(), p)
            assert g.reshape(-1, 8)[0].tolist() == w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_copy_kernel_matches_plain_version(cuda_device, dtype):
    gen = torch.Generator().manual_seed(7)
    ops.reset_launches()
    for G, p_src, p_dst, M in COPY_SHAPES:
        src = torch.randn(G, p_src, 16, 16, 64, generator=gen).to(dtype)
        dst = torch.randn(G, p_dst, 16, 16, 64, generator=gen).to(dtype)
        ids = torch.stack([torch.randperm(p_src, generator=gen)[:M],
                           torch.randperm(p_dst, generator=gen)[:M]],
                          1).to(torch.int32)
        want = ref.block_copy_ref(src, dst.clone(), ids)
        got = ops.block_copy(src.to(cuda_device), dst.to(cuda_device),
                             ids.to(cuda_device))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
    assert ops.launch_counts()["block_copy"] == len(COPY_SHAPES)


# (n_pairs, G, P_src, P_dst, block, M): the serving width at the migrations'
# M (1, 6) and at M = 128, and blocks of 2.5 and 1.25 chunks of 16 KiB
POOLS_SHAPES = [(n, 24, 160, 140, (16, 16, 64), m) for n in (1, 2)
                for m in (1, 6, 128)] + [(2, 3, 40, 24, (20, 16, 64), 6),
                                         (1, 1, 12, 9, (5, 32, 64), 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_copy_pools_kernel_matches_plain_version(cuda_device, dtype):
    """One launch over 1 or 2 pool pairs == the plain version per pair;
    id pairs outside the pools are skipped."""
    gen = torch.Generator().manual_seed(8)
    ops.reset_launches()
    for n_pairs, G, p_src, p_dst, block, M in POOLS_SHAPES:
        srcs = [torch.randn((G, p_src) + block, generator=gen).to(dtype)
                for _ in range(n_pairs)]
        dsts = [torch.randn((G, p_dst) + block, generator=gen).to(dtype)
                for _ in range(n_pairs)]
        ids = torch.stack([torch.randperm(p_src, generator=gen)[:M],
                           torch.randperm(p_dst, generator=gen)[:M]],
                          1).to(torch.int32)
        want = [ref.block_copy_ref(s, d.clone(), ids) for s, d in zip(srcs, dsts)]
        bad = torch.tensor([[p_src, 0], [-1, 1], [0, p_dst]], dtype=torch.int32)
        got = ops.block_copy_pools(
            [(s.to(cuda_device), d.to(cuda_device)) for s, d in zip(srcs, dsts)],
            torch.cat([ids, bad]).to(cuda_device))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    assert ops.launch_counts()["block_copy"] == len(POOLS_SHAPES)


@pytest.mark.cuda
def test_pt_walk_rows_any_kernel_matches_plain_version(cuda_device):
    """Rows gathered, walked and reduced in one launch == the plain
    version, at the decode ticks' shapes and larger ones, out-of-range
    queries and row ids included."""
    gen = torch.Generator().manual_seed(9)
    ops.reset_launches()
    cases = [(4, 16, 16, 1, 32), (4, 12, 12, 1, 10), (3, 5, 8, 4, 200),
             (33, 40, 12, 40, 100), (2, 6, 8, 2, 1000)]
    for r, n_seqs, n_leaf, max_leaf, n in cases:
        args = [torch.randint(-1, n_leaf, (n_seqs, max_leaf), generator=gen),
                torch.randint(-2, n_seqs + 2, (r,), generator=gen),
                torch.randint(-1, 2, (n_leaf,), generator=gen),
                torch.randint(-1, 64, (n_leaf, 64, 2), generator=gen),
                torch.randint(-128, (max_leaf + 1) * 64, (n,), generator=gen)]
        args = [a.to(torch.int32) for a in args]
        dev_args = [a.to(cuda_device) for a in args]
        args[3], dev_args[3] = args[3][:, :, 1], dev_args[3][:, :, 1]
        for tier in (0, 1, -1):
            want = ref.pt_walk_rows_any_ref(*args, tier)
            got = ops.pt_walk_rows_any(*dev_args, tier)
            assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)
    assert ops.launch_counts()["pt_walk"] == 3 * len(cases)


# (B, KH, G, Dh, P, bs, NB): test_paged_attention_sweep's shapes, G = 5,
# Dh 32 / 64, and G = 3 / 7 (run on the G = 4 / 8 instances, rows masked)
ATTN_SHAPES = [(1, 1, 1, 128, 8, 8, 2), (2, 2, 4, 128, 16, 16, 4),
               (3, 4, 2, 256, 32, 8, 5), (2, 2, 8, 128, 16, 32, 3),
               (2, 2, 5, 64, 64, 16, 12), (4, 3, 1, 32, 48, 8, 9),
               (2, 2, 3, 64, 16, 16, 4), (3, 1, 7, 128, 24, 8, 6)]
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_matches_plain_version(cuda_device, dtype):
    gen = torch.Generator().manual_seed(7)
    tol = ATTN_TOL[dtype]
    cases = [ref.paged_attention_inputs(
        *shape, dtype, torch.randint(1, shape[6] * shape[5] + 1, (shape[0],),
                                     generator=gen), seed)
        for seed, shape in enumerate(ATTN_SHAPES)]
    # -1 entries past each length, and a row with lengths == 0 (the
    # oracle's uniform mean of V, -1 read as block 0)
    cases.append(ref.paged_attention_inputs(3, 2, 2, 64, 40, 8, 6, dtype,
                                            [9, 48, 20], 100))
    cases.append(ref.paged_attention_inputs(3, 2, 2, 64, 12, 8, 4, dtype,
                                            [9, 32, 0], 101))
    ops.reset_launches()
    for args in cases:
        want = ref.paged_attention_public(*args)
        got = ops.paged_attention(*[a.to(cuda_device) for a in args])
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == want.shape
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   atol=tol, rtol=tol)
    assert ops.launch_counts()["paged_attention"] == len(cases)
