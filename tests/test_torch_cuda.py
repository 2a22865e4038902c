"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Imports no JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py reaches the JAX package.)  Without a
CUDA device every test here skips.
"""
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as pa

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
    """One launch over 1 or 2 pool pairs == the plain version per pair,
    id pairs outside the pools included: JAX's answer, a negative id
    counted from the end once, a source clamped, a destination still
    outside its pool dropped.  The valid pairs' destinations lie in
    ``[2, p_dst - 3)``, so no destination repeats."""
    gen = torch.Generator().manual_seed(8)
    ops.reset_launches()
    for n_pairs, G, p_src, p_dst, block, M in POOLS_SHAPES:
        srcs = [torch.randn((G, p_src) + block, generator=gen).to(dtype)
                for _ in range(n_pairs)]
        dsts = [torch.randn((G, p_dst) + block, generator=gen).to(dtype)
                for _ in range(n_pairs)]
        ids = torch.stack([torch.randperm(p_src, generator=gen)[:M],
                           torch.randperm(p_dst - 5, generator=gen)[:M] + 2],
                          1).to(torch.int32)
        # copies p_src - 1 -> 0, p_src - 1 -> 1, 0 -> p_dst - 3; drops
        # the pairs with destinations p_dst and -p_dst - 1
        bad = torch.tensor([[p_src, 0], [-1, 1], [0, p_dst],
                            [p_src + 5, -p_dst - 1], [-p_src - 3, -3]],
                           dtype=torch.int32)
        ids = torch.cat([ids, bad])
        want = [ref.block_copy_ref(s, d.clone(), ids) for s, d in zip(srcs, dsts)]
        got = ops.block_copy_pools(
            [(s.to(cuda_device), d.to(cuda_device)) for s, d in zip(srcs, dsts)],
            ids.to(cuda_device))
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


ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(ATTN_TOL))
def test_paged_attention_kernel_matches_plain_version(cuda_device, dtype):
    """f32 on CUDA cores, bf16 and f16 on tensor cores, at
    ``ref.ATTN_TEST_SHAPES`` (head dims 16 to 256, blocks of 1 to 32, G
    1 to 12), with -1 entries past each length and rows of length 0.
    Tolerances: the JAX tests' (f32 1e-5, bf16 2e-2); f16 1e-2 (reason
    in tests/test_torch_paged_attention.py)."""
    gen = torch.Generator().manual_seed(7)
    tol = ATTN_TOL[dtype]
    cases = [ref.paged_attention_inputs(
        *shape, dtype, torch.randint(1, shape[6] * shape[5] + 1, (shape[0],),
                                     generator=gen), seed)
        for seed, shape in enumerate(ref.ATTN_TEST_SHAPES)]
    cases += [ref.paged_attention_inputs(*case[:7], dtype, case[7], 100 + i)
              for i, case in enumerate(ref.ATTN_FIXED_LENGTHS)]
    ops.reset_launches()
    for args in cases:
        want = ref.paged_attention_public(*args)
        got = ops.paged_attention(*[a.to(cuda_device) for a in args])
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == want.shape
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   atol=tol, rtol=tol)
        if dtype in ref.ATTN_ROW_TOL:          # row by row, against f32
            want32 = ref.paged_attention_public(*[
                a.float() if a.is_floating_point() else a for a in args])
            assert float(ref.attention_row_error(got.cpu(), want32).max()) \
                <= ref.ATTN_ROW_TOL[dtype]
    assert ops.launch_counts()["paged_attention"] == len(cases)
    # the one-launch kernel leaves its arrival counters at 0 for the next
    # call
    assert all(int(b.abs().sum()) == 0 for b in pa._arrivals.values())


@pytest.mark.cuda
def test_paged_attention_streams_and_graphs_keep_their_own_counters(
        cuda_device):
    """Calls on two streams at once, and two CUDA graphs captured on one
    stream and replayed the later first, each merge their splits right:
    every stream and every capture has its own arrival counters."""
    cases = [ref.paged_attention_inputs(8, 8, 5, 128, 4352, 16, 512,
                                        torch.bfloat16, [8192, 300, 4000, 17,
                                                         0, 8000, 1, 6000],
                                        seed, device=cuda_device)
             for seed in (1, 2)]
    wants = [ref.paged_attention_public(*args) for args in cases]
    tol = ATTN_TOL[torch.bfloat16]
    streams = [torch.cuda.Stream() for _ in cases]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for i, (args, stream) in enumerate(zip(cases, streams)):
            with torch.cuda.stream(stream):
                outs[i].append(ops.paged_attention(*args))
    torch.cuda.synchronize()
    for out, want in zip(outs, wants):
        for got in out:
            torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                       rtol=tol)
    graphs, graph_outs = [], []
    for args in cases:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            graph_outs.append(ops.paged_attention(*args))
        graphs.append(graph)
    for i in (1, 0, 1):
        graphs[i].replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(graph_outs[i].float(), wants[i].float(),
                                   atol=tol, rtol=tol)
    assert all(int(b.abs().sum()) == 0 for b in pa._arrivals.values())


def _alloc_scan_inputs(gen, mc, codes):
    """Carries near the watermark or near zero, a little reserve, random
    requests: every allocation path occurs over a few calls."""
    from repro_torch.core import alloc as talloc
    L, N, T = len(codes), mc.n_nodes, mc.n_threads
    wm = talloc.watermark_pages(mc, "cpu")
    cap = torch.tensor(mc.node_capacity())
    near = torch.rand((L, N), generator=gen) < 0.5
    free = torch.where(near, torch.randint(0, 3, (L, N), generator=gen),
                       wm + torch.randint(-3, 4, (L, N), generator=gen))
    free = torch.where(cap > 0, free.clamp(min=0), 0).to(torch.int32)
    rec = torch.where(cap > 0, torch.randint(0, 3, (L, N), generator=gen),
                      0).to(torch.int32)
    return (free, rec, torch.randint(0, 40, (L,), generator=gen,
                                     dtype=torch.int32),
            torch.rand(L, generator=gen) < 0.1, wm,
            torch.tensor([d for d, _ in codes], dtype=torch.int32),
            torch.tensor([p for _, p in codes], dtype=torch.int32),
            torch.rand((L, T, 4), generator=gen) < 0.3,
            torch.rand((L, T), generator=gen) < 0.7)


@pytest.mark.cuda
def test_alloc_scan_kernel_matches_plain_version(cuda_device):
    """Every output of the allocator scan kernel == the plain loop, on 2-,
    3- and 4-tier machines (one with an empty tier), THP on and off,
    every pair of policy codes, 1 and 6 runs, T = 32 and 48, with and
    without a slot row; then on the crafted cases that cross each
    predicate inside a chunk.  The chunks the kernel replays == those the
    test mirror of its algorithm replays, and both paths occur."""
    from repro_torch.core import config as cfg
    from repro_torch.kernels import alloc_scan
    gen = torch.Generator().manual_seed(17)
    pairs = [(d, p) for d in (0, 1) for p in (10, 11, 12)]
    machines = [cfg.benchmark_machine(), cfg.cxl_machine(n_threads=16),
                cfg.MachineConfig(n_threads=8, tier_pages_per_node=(600, 0,
                                                                    900, 2400)),
                cfg.MachineConfig(n_threads=48)]
    ops.reset_launches()
    calls = mirror_replays = 0

    def run(args, kw, slot_thread):
        nonlocal calls, mirror_replays
        want = ops.alloc_scan(*args, **kw, slot_thread=slot_thread)
        mirror = ref.alloc_scan_speculative_ref(
            *args, kw["n_threads"], kw["alloc_nodes"], kw["thp"], slot_thread)
        got = ops.alloc_scan(*[a.to(cuda_device) for a in args], **kw,
                             slot_thread=None if slot_thread is None
                             else slot_thread.to(cuda_device))
        calls += 1
        mirror_replays += mirror[-1]
        for g, w, m in zip(got, want, mirror):
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
            assert torch.equal(m, w)
        return mirror[-1]

    for mc in machines:
        for thp in (False, True):
            kw = dict(n_threads=mc.n_threads, alloc_nodes=mc.alloc_nodes,
                      thp=thp)
            for codes in [[pair] for pair in pairs] + [pairs]:
                args = _alloc_scan_inputs(gen, mc, codes)
                T = mc.n_threads
                slots = torch.full((len(codes), T // 2), T, dtype=torch.int32)
                slots[:, :T // 4] = torch.arange(0, T, 4, dtype=torch.int32)
                run(args, kw, None)
                run(args, kw, slots)
    random_replays = alloc_scan.replays()
    assert random_replays == mirror_replays
    for case in ref.alloc_scan_cases():
        mc = cfg.MachineConfig(**case["machine"])
        kw = dict(n_threads=mc.n_threads, alloc_nodes=mc.alloc_nodes,
                  thp=mc.page_order > 0)
        assert run(case["args"], kw, case["slot_thread"]) == case["replays"]
    assert alloc_scan.replays() == mirror_replays
    assert 0 < mirror_replays < alloc_scan.chunks
    assert ops.launch_counts()["alloc_scan"] == calls


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["linux_default", "bhi_mig", "tpp",
                                    "nomad"])
def test_simulator_on_the_card_matches_the_cpu_route(cuda_device, policy):
    """The blocked engine and the per-step engine on the card (alloc_scan
    launched once per step with a fault, fast_window once per fast
    segment, no device read inside the loop) == the blocked run on the
    CPU, field for field."""
    import dataclasses

    import numpy as np

    from repro_torch import core
    mc = core.MachineConfig(n_threads=8, va_pages=1 << 13, radix_bits=6,
                            tier_pages_per_node=(400, 300, 2400))
    pc = getattr(core, policy)()
    pc = dataclasses.replace(pc, autonuma_period=32, autonuma_budget=64)
    trace = core.workloads.kv_store(mc, 1 << 12, 256)
    cpu = core.TieredMemSimulator(mc=mc, pc=pc, device="cpu").run(trace)
    for engine in ("blocked", "per_step"):
        ops.reset_launches()
        runner = core.TieredMemSimulator(mc=mc, pc=pc, engine=engine,
                                         debug=True).runner(trace)
        torch.cuda.set_sync_debug_mode("error")
        try:
            runner.advance()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        card = runner.result()
        counts = ops.launch_counts()
        assert counts["alloc_scan"] == \
            int(core.fault_step_mask(trace, mc).sum())
        assert counts["fast_window"] == (
            runner.fast_segments if engine == "blocked" else 0)
        _assert_same_run(card, cpu)


def _assert_same_run(card, cpu):
    import dataclasses

    import numpy as np

    def fields(state, prefix=""):
        for f in dataclasses.fields(state):
            v = getattr(state, f.name)
            if dataclasses.is_dataclass(v):
                yield from fields(v, prefix + f.name + ".")
            else:
                yield prefix + f.name, v

    want = dict(fields(cpu.final_state))
    for name, got in fields(card.final_state):
        w = want[name]
        assert got.dtype == w.dtype and got.shape == w.shape, name
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got, w, rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(got, w, err_msg=name)
    for k, w in cpu.timeline.items():
        np.testing.assert_allclose(card.timeline[k], w, rtol=1e-5, err_msg=k)


def _fast_window_updates(args):
    """Every tensor ``ops.fast_window`` updates in place."""
    caches, acc, counters, hot, row_counts = args[6:]
    return ([t for pair in caches for t in pair] + list(acc) + list(counters)
            + list(hot) + list(row_counts))


@pytest.mark.cuda
def test_fast_window_kernel_matches_plain_version(cuda_device):
    """An event-free segment in one launch (kernel N1) == its plain
    version, exactly: ``cum`` and everything it updates in place (caches,
    accumulators, counters, hotness counts, row counts); segments of 1, 7,
    64, 128 and 256 rows, T = 4 and 32, L = 1 and 3, benchmark_machine()
    and cxl_machine() geometry, THP on and off, inactive rows and an
    OOM-killed state."""
    from repro_torch.core import config as cfg
    ops.reset_launches()
    calls = 0
    for mc in (cfg.benchmark_machine(), cfg.cxl_machine(thp=True),
               cfg.benchmark_machine(thp=True)):
        for R, T, L, oom in ((1, 4, 1, False), (7, 32, 3, False),
                             (64, 32, 1, False), (128, 4, 3, False),
                             (256, 32, 3, False), (64, 32, 1, True)):
            want_args, kw = ref.fast_window_inputs(mc, L, R, T, seed=calls,
                                                   oom=oom)
            got_args, _ = ref.fast_window_inputs(mc, L, R, T, seed=calls,
                                                 oom=oom, device=cuda_device)
            want = ops.fast_window(*want_args, **kw)
            got = ops.fast_window(*got_args, **kw)
            calls += 1
            for g, w in zip([got] + _fast_window_updates(got_args),
                            [want] + _fast_window_updates(want_args)):
                assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    assert ops.launch_counts()["fast_window"] == calls
