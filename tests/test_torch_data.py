"""The port's synthetic token pipeline (``repro_torch.data.pipeline``) held
to the JAX package's bit for bit: tokens and targets over 64 steps at
vocab 512, 32,768 and 151,936, whole batches and host shards; the twins
of tests/test_training.py's two data tests; and the two places where
torch's defaults would part from the reference: f32 ``pow`` (the port
runs glibc's ``powf``, equal to the reference's on all 2^24 inputs) and
the saturating cast of the ranks to int32.

Tolerance: none anywhere (integers and f32 bits compared exactly).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as tpipe
from repro_torch import libm

VOCABS = (512, 32768, 151936)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread_and_clear_jax_caches():
    """torch on one thread in this module (xdist runs a worker per core,
    and torch's OpenMP threads would contend across them), and this
    module's JAX programs, and those of the modules before it, dropped as
    it starts and at its end, so an xdist worker does not gather them."""
    jax.clear_caches()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.clear_caches()


def both(vocab, seq_len=512, global_batch=8):
    return (jpipe.DataConfig(vocab=vocab, seq_len=seq_len,
                             global_batch=global_batch),
            tpipe.DataConfig(vocab=vocab, seq_len=seq_len,
                             global_batch=global_batch))


@pytest.mark.parametrize("vocab", VOCABS)
def test_batches_bit_for_bit(vocab):
    """64 steps of 8 x 512 tokens (262,656 draws a vocabulary) and the
    shards of 2 and 4 hosts at four of those steps: every token and
    target equal to the reference's, int32 on the device asked for."""
    jc, tc = both(vocab)
    for step in range(64):
        want = jpipe.batch_at(jc, step)
        got = tpipe.batch_at(tc, step, device="cpu")
        for key in ("tokens", "targets"):
            assert got[key].dtype == torch.int32
            assert got[key].device.type == "cpu"
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]),
                                          err_msg=f"step {step} {key}")
        if step % 16 == 5:
            for n_hosts in (2, 4):
                per = jc.global_batch // n_hosts
                for h in range(n_hosts):
                    rows = (h * per, per)
                    np.testing.assert_array_equal(
                        tpipe.batch_at(tc, step, host_rows=rows,
                                       device="cpu")["tokens"].numpy(),
                        np.asarray(jpipe.batch_at(jc, step,
                                                  host_rows=rows)["tokens"]))


def test_powf_is_the_references_pow_on_every_draw():
    """Every u the pipeline can draw (k / 2^24): the port's ``powf(1 - u,
    -10)`` equals the reference's f32 ``pow`` bit for bit, where torch's
    own f32 ``pow`` differs on tens of thousands and moves the token of
    thousands."""
    k = np.arange(1 << 24, dtype=np.uint32)
    u = k.astype(np.float32) / np.float32(1 << 24)
    expo = -1.0 / (1.1 - 1.0)
    want = np.asarray(jax.jit(lambda u: jnp.power(1.0 - u, expo))(u))
    tu = torch.from_numpy(u)
    got = libm.powf(1.0 - tu, expo).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    plain = torch.pow(1.0 - tu, expo).numpy()
    assert (plain != want).sum() > 10_000

    def token(r):
        return np.minimum(r - 1.0, 2.0 ** 24).astype(np.int64)
    assert (token(plain) != token(want)).sum() > 1_000


def test_ranks_saturate_as_the_references_cast():
    """Draws with u above 0.883 give ranks past 2^31 (inf near u = 1):
    the reference's cast to int32 saturates them to 2^31 - 1, so they
    become ``vocab - 1``; torch's cast gives -2^31 on the CPU, which a
    plain ``clip`` would turn into token 0.  The port clamps in f32 first
    and gives ``vocab - 1``."""
    vocab = 512
    jc, tc = both(vocab)
    cpu = torch.device("cpu")
    kept = np.arange(tc.seq_len + 1) % 3 != 0      # not an n-gram token
    kept[:2] = True
    n_huge = 0
    for step in range(4):
        ranks = tpipe._ranks(tc, step, 0, tc.global_batch, cpu)
        huge = (ranks >= 2.0 ** 31).numpy() & kept[None, :]
        n_huge += int(huge.sum())
        naive = ranks.to(torch.int32).clamp(0, vocab - 1).numpy()
        assert (naive[huge] == 0).all()
        jb = jpipe.batch_at(jc, step)
        tb = tpipe.batch_at(tc, step, device=cpu)
        want = np.concatenate([np.asarray(jb["tokens"]),
                               np.asarray(jb["targets"])[:, -1:]], axis=1)
        got = torch.cat([tb["tokens"], tb["targets"][:, -1:]], 1).numpy()
        assert (want[huge] == vocab - 1).all() and (got[huge] == vocab - 1).all()
    assert n_huge > 1000


def test_data_deterministic_and_elastic():
    """Twin of tests/test_training.py::test_data_deterministic_and_elastic."""
    dc = tpipe.DataConfig(vocab=1000, seq_len=32, global_batch=8)
    b1 = tpipe.batch_at(dc, 7, device="cpu")
    b2 = tpipe.batch_at(dc, 7, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    # host shards concatenate to the global batch, for any host count
    for n_hosts in (2, 4):
        per = dc.global_batch // n_hosts
        shards = [tpipe.batch_at(dc, 7, host_rows=(h * per, per),
                                 device="cpu")["tokens"]
                  for h in range(n_hosts)]
        assert torch.equal(torch.cat(shards), b1["tokens"])


def test_data_targets_shifted():
    """Twin of tests/test_training.py::test_data_targets_shifted."""
    dc = tpipe.DataConfig(vocab=1000, seq_len=16, global_batch=2)
    b = tpipe.batch_at(dc, 0, device="cpu")
    assert torch.equal(b["tokens"][:, 1:], b["targets"][:, :-1])


def test_host_iter_matches_the_reference():
    """``host_iter`` yields the reference's shards, step after step."""
    jc, tc = both(32768, seq_len=64, global_batch=8)
    jit_, tit = jpipe.host_iter(jc, 1, 4, start_step=3), \
        tpipe.host_iter(tc, 1, 4, start_step=3, device="cpu")
    for _ in range(3):
        want, got = next(jit_), next(tit)
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(want["tokens"]))
        np.testing.assert_array_equal(got["targets"].numpy(),
                                      np.asarray(want["targets"]))


def test_batch_at_runs_on_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tpipe.batch_at(tpipe.DataConfig(vocab=512, seq_len=8,
                                        global_batch=2), 0)
