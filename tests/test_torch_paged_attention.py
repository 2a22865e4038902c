"""The port's decode attention against the JAX package's Pallas kernel
(interpret mode) and its oracle, on the shapes of tests/test_kernels.py.

Inputs come from numpy seeds and go to both packages.  On the CPU
``ops.paged_attention`` runs the plain version; the CUDA kernel is held
against that plain version in tests/test_torch_cuda.py.  Tolerances are
the JAX tests' own: f32 ``1e-5``, bf16 ``2e-2``; f16, which the JAX tests
do not cover, ``1e-2``: its 11-bit significand rounds the inputs, the
kernel's P and the output 8 times finer than bf16's 8 bits, and half the
bf16 tolerance leaves that margin to sums over thousands of positions in
another order.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention_kernel
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as pa

TOL = {jnp.float32: 1e-5, jnp.bfloat16: 2e-2, jnp.float16: 1e-2}


def to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def as_np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def attn_inputs(rng, B, KH, G, Dh, P, bs, NB, dtype, holes=False):
    """``holes``: -1 entries past each length, as a paged cache leaves
    them."""
    q = jnp.asarray(rng.normal(size=(B, KH, G, Dh)), dtype)
    kp = jnp.asarray(rng.normal(size=(KH, P, bs, Dh)), dtype)
    vp = jnp.asarray(rng.normal(size=(KH, P, bs, Dh)), dtype)
    tables = rng.choice(P, size=B * NB, replace=False).reshape(B, NB)
    lengths = rng.integers(1, NB * bs + 1, B)
    if holes:
        used = -(-lengths // bs)
        tables[np.arange(NB)[None, :] >= used[:, None]] = -1
    return q, kp, vp, tables.astype(np.int32), lengths.astype(np.int32)


def port(q, kp, vp, tables, lengths):
    """The port's public entry point on the JAX kernel-native inputs."""
    B, KH, G, Dh = q.shape
    out = ops.paged_attention(to_torch(q).reshape(B, KH * G, Dh),
                              to_torch(kp), to_torch(vp), to_torch(tables),
                              to_torch(lengths))
    assert out.dtype == to_torch(q).dtype and out.shape == (B, KH * G, Dh)
    return as_np(out.reshape(B, KH, G, Dh))


def close(got, want, tol):
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,KH,G,Dh,P,bs,NB", [
    (1, 1, 1, 128, 8, 8, 2),
    (2, 2, 4, 128, 16, 16, 4),
    (3, 4, 2, 256, 32, 8, 5),
    (2, 2, 8, 128, 16, 32, 3),
])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_paged_attention_sweep_matches_jax_kernel(B, KH, G, Dh, P, bs, NB,
                                                  dtype):
    rng = np.random.default_rng(B * 100 + G * 10 + NB)
    args = attn_inputs(rng, B, KH, G, Dh, P, bs, NB, dtype)
    want = paged_attention_kernel(*map(jnp.asarray, args), interpret=True)
    close(port(*args), want, TOL[dtype])


def test_paged_attention_matches_dense():
    """Paged attention over a permuted pool == dense attention (the case
    of test_paged_attention_matches_dense)."""
    rng = np.random.default_rng(3)
    B, KH, G, Dh, bs, NB = 2, 2, 2, 128, 8, 4
    S, P = bs * NB, B * NB
    q = rng.normal(size=(B, KH, G, Dh)).astype(np.float32)
    k = rng.normal(size=(B, KH, S, Dh)).astype(np.float32)
    v = rng.normal(size=(B, KH, S, Dh)).astype(np.float32)
    perm = rng.permutation(P)
    kp = np.zeros((KH, P, bs, Dh), np.float32)
    vp = np.zeros((KH, P, bs, Dh), np.float32)
    for b in range(B):
        for j in range(NB):
            kp[:, perm[b * NB + j]] = k[b, :, j * bs:(j + 1) * bs]
            vp[:, perm[b * NB + j]] = v[b, :, j * bs:(j + 1) * bs]
    tables = perm.reshape(B, NB).astype(np.int32)
    lengths = np.asarray([S, S - 3], np.int32)
    s = jnp.einsum("bkgd,bksd->bkgs", q, k) / np.sqrt(Dh)
    mask = jnp.arange(S)[None, :] < lengths[:, None]
    s = jnp.where(mask[:, None, None, :], s, -1e30)
    want = jnp.einsum("bkgs,bksd->bkgd", jax.nn.softmax(s, -1), v)
    close(port(q, kp, vp, tables, lengths), want, 1e-5)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_paged_attention_minus_one_past_length(dtype):
    """-1 table entries past each length: the JAX kernel and the JAX
    oracle agree (a masked block adds exactly 0), and the port matches
    both."""
    rng = np.random.default_rng(11)
    args = attn_inputs(rng, 3, 2, 2, 64, 40, 8, 6, dtype, holes=True)
    assert (args[3] == -1).any()
    jargs = list(map(jnp.asarray, args))
    kern = paged_attention_kernel(*jargs, interpret=True)
    oracle = jref.paged_attention_ref(*jargs)
    close(np.asarray(kern, np.float32), oracle, TOL[dtype])
    got = port(*args)
    close(got, kern, TOL[dtype])
    close(got, oracle, TOL[dtype])


def test_paged_attention_zero_length_is_the_oracles_uniform_mean():
    """A row with lengths == 0: every score is -1e30, so the oracle gives
    the uniform mean of V over all NB gathered blocks, a -1 entry read as
    block 0 (``maximum(tables, 0)``).  The interpret-mode Pallas kernel
    wraps a -1 to block P-1 here instead, so this case is held against the
    oracle, which ``ops.paged_attention`` runs off the TPU."""
    rng = np.random.default_rng(12)
    B, KH, G, Dh, P, bs, NB = 3, 2, 2, 64, 12, 8, 4
    q, kp, vp, tables, _ = attn_inputs(rng, B, KH, G, Dh, P, bs, NB,
                                       jnp.float32)
    lengths = np.asarray([9, 32, 0], np.int32)
    tables[0, 2:] = -1
    tables[2, 1:] = -1
    want = jref.paged_attention_ref(q, kp, vp, jnp.asarray(tables),
                                    jnp.asarray(lengths))
    got = port(q, kp, vp, tables, lengths)
    close(got, want, 1e-5)
    blocks = np.maximum(tables[2], 0)
    mean = np.asarray(vp)[:, blocks].reshape(KH, NB * bs, Dh).mean(1)
    close(got[2], np.broadcast_to(mean[:, None], (KH, G, Dh)), 1e-5)


def test_paged_attention_head_mapping_matches_jax_ops():
    """[B, H, Dh] <-> [B, KH, G, Dh] at G = 5 (Qwen2.5-14B's grouping):
    query head h reads KV head h // G, as in the JAX ``ops``."""
    rng = np.random.default_rng(14)
    B, KH, G, Dh, P, bs, NB = 2, 2, 5, 32, 16, 8, 4
    q, kp, vp, tables, lengths = attn_inputs(rng, B, KH, G, Dh, P, bs, NB,
                                             jnp.float32, holes=True)
    qh = np.asarray(q).reshape(B, KH * G, Dh)
    want = jops.paged_attention(jnp.asarray(qh), kp, vp,
                                jnp.asarray(tables), jnp.asarray(lengths))
    got = ops.paged_attention(to_torch(qh), to_torch(kp), to_torch(vp),
                              to_torch(tables), to_torch(lengths))
    close(got.numpy(), want, 1e-5)
    # head h of the output moves with KV head h // G and nothing else
    vp2 = np.asarray(vp).copy()
    vp2[1] += 1.0
    moved = ops.paged_attention(to_torch(qh), to_torch(kp), to_torch(vp2),
                                to_torch(tables), to_torch(lengths))
    delta = (moved - got).abs().amax(dim=(0, 2)).numpy()
    np.testing.assert_allclose(delta[G:], 1.0, rtol=1e-5)
    np.testing.assert_array_equal(delta[:G], 0.0)


@pytest.mark.parametrize("G", [3, 7])
def test_paged_attention_public_helpers_match_jax_ops(G):
    """``ref.paged_attention_inputs`` leaves -1 past each length (a row of
    length 0 keeps its first entry), and ``ref.paged_attention_public``,
    the plain version the card's checks hold the kernel to, equals the
    JAX ``ops.paged_attention`` on them, at groups the kernel runs on a
    larger instance."""
    B, KH, Dh, P, bs, NB = 3, 2, 64, 16, 8, 4
    args = ref.paged_attention_inputs(B, KH, G, Dh, P, bs, NB, torch.float32,
                                      [9, 32, 0], 5)
    tables = args[3].numpy()
    np.testing.assert_array_equal(tables < 0, [[0, 0, 1, 1], [0, 0, 0, 0],
                                               [0, 1, 1, 1]])
    assert len(set(tables[tables >= 0].tolist())) == (tables >= 0).sum()
    want = jops.paged_attention(*(jnp.asarray(a.numpy()) for a in args))
    close(ref.paged_attention_public(*args).numpy(), want, 1e-5)
    close(ops.paged_attention(*args).numpy(), want, 1e-5)


# (Dh, bs, NB): head dims off the old 32/64/128/256 (hubert-xlarge's 80,
# nemotron-4-340b's 192, the smallest, 16) and blocks of 1, 4 and 12
# positions
WIDE_DOMAIN = [(16, 1, 11), (80, 4, 6), (192, 12, 3)]


@pytest.mark.parametrize("Dh,bs,NB", WIDE_DOMAIN)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.float16])
def test_paged_attention_wide_domain_matches_jax(dtype, Dh, bs, NB):
    """float16, any head dim that is a multiple of 16 and any block size:
    the port equals JAX's ``ops.paged_attention`` (its reference route)
    and the Pallas kernel in interpret mode, with -1 entries past each
    length."""
    rng = np.random.default_rng(Dh * 10 + bs)
    B, KH, G, P = 2, 2, 3, 2 * NB + 3
    q, kp, vp, tables, lengths = attn_inputs(rng, B, KH, G, Dh, P, bs, NB,
                                             dtype, holes=True)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, tables, lengths)]
    got = port(q, kp, vp, tables, lengths)
    kern = paged_attention_kernel(*jargs, interpret=True)
    qh = jargs[0].reshape(B, KH * G, Dh)
    via_ops = jops.paged_attention(qh, *jargs[1:]).reshape(B, KH, G, Dh)
    close(got, np.asarray(kern, np.float32), TOL[dtype])
    close(got, np.asarray(via_ops, np.float32), TOL[dtype])


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.float16])
def test_paged_attention_wide_domain_zero_length_matches_jax_ops(dtype):
    """lengths == 0 at Dh 80 and bs 4, with -1 entries: the uniform mean of
    V over all NB blocks, -1 read as block 0, as JAX's ``ops`` gives it
    off the TPU (the interpret-mode kernel reads -1 as P-1 there)."""
    rng = np.random.default_rng(31)
    B, KH, G, Dh, P, bs, NB = 3, 2, 5, 80, 20, 4, 5
    q, kp, vp, tables, _ = attn_inputs(rng, B, KH, G, Dh, P, bs, NB, dtype)
    lengths = np.asarray([0, 7, NB * bs], np.int32)
    tables[0, 1:] = -1
    tables[1, 2:] = -1
    qh = jnp.asarray(q).reshape(B, KH * G, Dh)
    want = jops.paged_attention(qh, kp, vp, jnp.asarray(tables),
                                jnp.asarray(lengths)).reshape(B, KH, G, Dh)
    got = port(q, kp, vp, tables, lengths)
    close(got, np.asarray(want, np.float32), TOL[dtype])


def tensor_core_numerics(q, kp, vp, tables, lengths, splits, warps, tile=16,
                         drop=None):
    """The 16-bit kernel's arithmetic (``mma_partial_kernel`` of
    csrc/paged_attention.cu) in plain PyTorch: each of ``splits`` chunks
    of ceil(NB / splits) blocks is cut into tiles of ``tile`` positions
    dealt to ``warps`` streams in turn; per tile the f32 scores of the
    inputs as given are scaled by log2(e)/sqrt(Dh), masked to -1e30 (past
    the length) or -inf (past the chunk), and enter an online softmax in
    base 2; P is rounded to q's type before P·V, l sums the f32 P; the
    streams, then the chunks, merge in f32.  ``drop``: a split left out
    of the merge, a planted fault for the checks to catch."""
    B, KH, G, Dh = q.shape
    _, P, bs, _ = kp.shape
    NB = tables.shape[1]
    safe = tables.long().clamp(0, P - 1)
    k = kp[:, safe].movedim(0, 1).reshape(B, KH, NB * bs, Dh).float()
    v = vp[:, safe].movedim(0, 1).reshape(B, KH, NB * bs, Dh).float()
    cb = -(-NB // splits)
    n_it = -(-(-(-cb * bs // tile)) // warps)
    s_ = torch.arange(splits)[:, None, None, None]
    pos = (s_ * cb * bs + (torch.arange(warps)[:, None]
                           + torch.arange(n_it)[:, None, None] * warps)
           * tile + torch.arange(tile))                  # [S, I, W, T]
    lengths = lengths.long()
    visited = torch.where(lengths > 0, (-(-lengths // bs)).clamp(max=NB), NB)
    tok1 = torch.minimum((s_[None] + 1) * cb, visited[:, None, None, None,
                                                      None]) * bs
    inside = pos[None] < tok1                            # [B, S, I, W, T]
    if drop is not None:
        inside &= (s_ != drop)[None]
    at = pos.clamp(max=NB * bs - 1)
    kt, vt = k[:, :, at], v[:, :, at]                    # [B, KH, S, I, W, T, Dh]
    sc = torch.einsum("bkgd,bksiwtd->bkgsiwt", q.float(), kt)
    sc = sc * (math.log2(math.e) / math.sqrt(Dh))
    sc = torch.where((pos[None] < lengths[:, None, None, None, None])
                     [:, None, None], sc, ref.NEG_INF)
    sc = torch.where(inside[:, None, None], sc, -math.inf)
    m = torch.full((B, KH, G, splits, warps), ref.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, KH, G, splits, warps, Dh)
    for i in range(n_it):
        s_i = sc[:, :, :, :, i]                          # [B, KH, G, S, W, T]
        m_new = torch.maximum(m, s_i.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s_i - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgswt,bkswtd->bkgswd", p.to(q.dtype).float(), vt[:, :, :, i])
        m = m_new
    for axis in (4, 3):                                  # the streams, the chunks
        mx = m.amax(axis, keepdim=True)
        w = torch.exp2(m - mx)
        acc = (w[..., None] * acc).sum(axis)
        l = (w * l).sum(axis)
        m = mx.squeeze(axis)
    return (acc / l.clamp(min=1e-30)[..., None]).to(q.dtype)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.float16])
def test_tensor_core_numerics_fit_the_tolerance(dtype):
    """The 16-bit kernel's rounding (Q as given, the scale on the f32
    scores, P rounded to the working type before P·V) at a Qwen2.5-14B
    head (G = 5, Dh 128, bs 16, 512 blocks in the 11 splits of its full
    width on an H100, 4 warps per CTA): within the JAX tests' tolerance of
    JAX's oracle, at full length, mid-block, over one block and at length
    0.  In f32, where nothing is rounded, the same arithmetic is held to
    1e-5, which shows that the mirror's splits, streams and merges are
    the oracle's softmax."""
    rng = np.random.default_rng(5)
    B, KH, G, Dh, P, bs, NB = 4, 1, 5, 128, 2048, 16, 512
    q, kp, vp, tables, _ = attn_inputs(rng, B, KH, G, Dh, P, bs, NB, dtype)
    lengths = np.asarray([NB * bs, 2500, 17, 0], np.int32)
    splits = pa.num_splits(8, 8, G, NB, 132, pa.ctas_per_sm(torch.bfloat16, Dh))
    assert splits == 11
    want = jref.paged_attention_ref(*map(jnp.asarray, (q, kp, vp, tables,
                                                       lengths)))
    got = tensor_core_numerics(*map(to_torch, (q, kp, vp, tables, lengths)),
                               splits, 4)
    close(as_np(got), np.asarray(want, np.float32), TOL[dtype])


@pytest.mark.parametrize("G,Dh,NB,splits", [(1, 64, 256, 9), (5, 128, 512, 11)])
@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float16])
def test_row_check_catches_a_dropped_split(dtype, G, Dh, NB, splits):
    """``ref.ATTN_ROW_TOL``, the per-row check that chip_smoke.py and the
    card tests put on the 16-bit kernel, at the heads and splits of
    Qwen1.5-0.5B's and Qwen2.5-14B's full widths on an H100: the kernel's
    arithmetic (the mirror) stays under it against JAX's f32 oracle on the
    same inputs, and the same arithmetic with one split of a full-length
    sequence left out of the merge is over ten times the limit, though
    its absolute error (about 0.02) is within the JAX tests' 2e-2; the
    shorter sequences, which end before that split, stay under it."""
    rng = np.random.default_rng(11)
    B, KH, P, bs = 3, 1, 1536, 16
    q, kp, vp, tables, _ = attn_inputs(rng, B, KH, G, Dh, P, bs, NB, dtype)
    lengths = np.asarray([NB * bs, NB * bs // 3, 17], np.int32)
    want = to_torch(jref.paged_attention_ref(*[
        jnp.asarray(a, jnp.float32) for a in (q, kp, vp)],
        jnp.asarray(tables), jnp.asarray(lengths)))
    args = [to_torch(a) for a in (q, kp, vp, tables, lengths)]
    limit = ref.ATTN_ROW_TOL[args[0].dtype]
    got = tensor_core_numerics(*args, splits, 4)
    assert float(ref.attention_row_error(got, want).max()) <= limit
    bad = tensor_core_numerics(*args, splits, 4, drop=splits // 2)
    rows = ref.attention_row_error(bad, want)
    assert float(rows[0].min()) > 10 * limit
    assert float(rows[1:].max()) <= limit      # they end before that split


@pytest.mark.parametrize("dtype,head_dim,want", [
    (torch.bfloat16, 64, 3), (torch.float16, 16, 3), (torch.float16, 80, 2),
    (torch.bfloat16, 128, 2), (torch.bfloat16, 192, 1), (torch.float16, 256, 1),
    (torch.float32, 64, 3), (torch.float32, 128, 3)])
def test_ctas_per_sm_fixed_by_the_ring(dtype, head_dim, want):
    """The split rule's CTAs per SM: the tensor-core kernel's shared-memory
    ring (64, 96, 128 KB on the head-dim instances 64, 128, 256) leaves
    3, 2 and 1 resident on an H100 (chip_smoke.py holds this to the card's
    occupancy query); f32 takes 3 throughout."""
    assert pa.ctas_per_sm(dtype, head_dim) == want


def test_paged_attention_cuda_route_raises_without_a_card(monkeypatch):
    """The kernel's route never falls back to the plain version: without
    CUDA, or given CPU tensors, it raises."""
    rng = np.random.default_rng(0)
    args = [to_torch(a) for a in attn_inputs(rng, 1, 1, 1, 32, 4, 8, 2,
                                             jnp.float32)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        pa.paged_attention_cuda(*args)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pa.paged_attention_cuda(*args)


def test_paged_attention_rejects_bad_arguments():
    """The kernel's domain ends at float64, a head dim that is not a
    multiple of 16 (24) or above 256 (272), and a block of 0 positions;
    both routes refuse these alike."""
    rng = np.random.default_rng(1)
    q, kp, vp, tables, lengths = [to_torch(a) for a in attn_inputs(
        rng, 2, 2, 2, 32, 8, 8, 2, jnp.float32)]
    q = q.reshape(2, 4, 32)
    with pytest.raises(ValueError, match="differ in dtype"):
        ops.paged_attention(q, kp.bfloat16(), vp, tables, lengths)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        ops.paged_attention(q.double(), kp.double(), vp.double(), tables,
                            lengths)
    with pytest.raises(ValueError, match="multiple of 16 up to 256, got 24"):
        ops.paged_attention(q[..., :24].contiguous(), kp[..., :24].contiguous(),
                            vp[..., :24].contiguous(), tables, lengths)
    wide = [torch.cat([t] * 9, -1)[..., :272].contiguous() for t in (q, kp, vp)]
    with pytest.raises(ValueError, match="multiple of 16 up to 256, got 272"):
        ops.paged_attention(*wide, tables, lengths)
    with pytest.raises(ValueError, match="at least 1"):
        ops.paged_attention(q, kp[:, :, :0].contiguous(),
                            vp[:, :, :0].contiguous(), tables, lengths)
    with pytest.raises(ValueError, match="int32"):
        ops.paged_attention(q, kp, vp, tables.long(), lengths)
    with pytest.raises(ValueError, match="contiguous"):
        ops.paged_attention(q, kp, vp, tables.t().contiguous().t(), lengths)
    with pytest.raises(ValueError, match="group"):
        ops.paged_attention(q[:, :3].contiguous(), kp, vp, tables, lengths)


def test_paged_attention_plain_version_counts_no_launch():
    rng = np.random.default_rng(2)
    ops.reset_launches()
    port(*attn_inputs(rng, 1, 2, 1, 64, 4, 8, 2, jnp.float32))
    assert ops.launch_counts()["paged_attention"] == 0


@pytest.mark.parametrize("B,KH,G,NB,want", [
    (8, 16, 1, 256, 9), (8, 8, 5, 512, 17), (1, 1, 1, 2, 2),
    (64, 64, 1, 100, 1), (2, 1, 24, 4, 4)])
def test_num_splits_depends_on_shapes_only(B, KH, G, NB, want):
    """Splits are fixed on the host from B * KH (* group chunks), NB and
    the card's SM count (132 on an H100 SXM): about 8 partial CTAs per
    SM (8/3 of the 3 that f32 counts resident), at most one split per
    block."""
    assert pa.num_splits(B, KH, G, NB, 132, pa.ctas_per_sm(torch.float32, 64)) \
        == want



@pytest.mark.parametrize("B,KH,G,NB,resident,want", [
    (8, 16, 1, 256, 3, 9), (8, 8, 5, 512, 2, 11), (1, 1, 1, 4096, 3, 512),
    (64, 64, 12, 100, 2, 1)])
def test_num_splits_of_the_tensor_core_kernel(B, KH, G, NB, resident, want):
    """bf16/f16: 8/3 of the CTAs an SM holds at once (3 at Dh <= 64, 2
    at Dh 128 on an H100) over 132 SMs, at most one split per block and
    MAX_SPLITS (the last CTA's merge holds a weight per split in shared
    memory)."""
    assert pa.num_splits(B, KH, G, NB, 132, resident) == want
