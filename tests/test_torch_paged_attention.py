"""The port's decode attention against the JAX package's Pallas kernel
(interpret mode) and its oracle, on the shapes of tests/test_kernels.py.

Inputs come from numpy seeds and go to both packages.  On the CPU
``ops.paged_attention`` runs the plain version; the CUDA kernel is held
against that plain version in tests/test_torch_cuda.py.  Tolerances are
the JAX tests' own: f32 ``1e-5``, bf16 ``2e-2``.
"""
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

TOL = {jnp.float32: 1e-5, jnp.bfloat16: 2e-2}


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
    rng = np.random.default_rng(1)
    q, kp, vp, tables, lengths = [to_torch(a) for a in attn_inputs(
        rng, 2, 2, 2, 32, 8, 8, 2, jnp.float32)]
    q = q.reshape(2, 4, 32)
    with pytest.raises(ValueError, match="differ in dtype"):
        ops.paged_attention(q, kp.bfloat16(), vp, tables, lengths)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.paged_attention(q.double(), kp.double(), vp.double(), tables,
                            lengths)
    with pytest.raises(ValueError, match="head_dim"):
        ops.paged_attention(q[..., :16].contiguous(), kp[..., :16].contiguous(),
                            vp[..., :16].contiguous(), tables, lengths)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.paged_attention(q, kp[:, :, :4].contiguous(),
                            vp[:, :, :4].contiguous(), tables, lengths)
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
    SM, at most one split per block."""
    assert pa.num_splits(B, KH, G, NB, 132) == want
