"""The port's checkpoints (``repro_torch.checkpoint.ckpt``): the twins of
tests/test_checkpoint.py, and the on-disk format held to the JAX
package's byte for byte: a checkpoint either package writes restores in
the other bit for bit (bf16 included), with the same files and the same
manifest text.  Also: an async save copies the tree to the host before it
returns, so a step that updates the params in place right after cannot
change what is written.  Tolerance: none (bits compared)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro_torch.checkpoint import ckpt


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


def tree(key=0):
    g = torch.Generator().manual_seed(key)
    return {"params": {"w": torch.randn((4, 8), generator=g),
                       "b": torch.zeros((8,), dtype=torch.bfloat16)},
            "opt": {"m": torch.ones((4, 8)),
                    "step": torch.tensor(7, dtype=torch.int32)}}


def meta(t):
    return {k: meta(v) if isinstance(v, dict)
            else torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in t.items()}


def leaves(t):
    return [v for k in sorted(t) for v in
            (leaves(t[k]) if isinstance(t[k], dict) else [t[k]])]


def test_roundtrip(tmp_path):
    t = tree()
    ckpt.save(str(tmp_path), 10, t)
    assert ckpt.latest_step(str(tmp_path)) == 10
    back = ckpt.restore(str(tmp_path), 10, meta(t), device="cpu")
    for a, b in zip(leaves(t), leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_ignores_partial_saves(tmp_path):
    t = tree()
    ckpt.save(str(tmp_path), 5, t)
    # a crashed save: directory without a manifest
    (tmp_path / "step_9").mkdir()
    (tmp_path / "step_12.tmp").mkdir()
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_restore_validates_shapes(tmp_path):
    t = tree()
    ckpt.save(str(tmp_path), 1, t)
    bad = {k: {n: torch.empty((3,) + tuple(v.shape), dtype=v.dtype,
                              device="meta") for n, v in d.items()}
           for k, d in t.items()}
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), 1, bad, device="cpu")


def test_async_save(tmp_path):
    t = tree()
    th = ckpt.save(str(tmp_path), 3, t, blocking=False)
    th.join()
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_overwrite_same_step(tmp_path):
    t1, t2 = tree(0), tree(1)
    ckpt.save(str(tmp_path), 2, t1)
    ckpt.save(str(tmp_path), 2, t2)
    back = ckpt.restore(str(tmp_path), 2, meta(t2), device="cpu")
    assert torch.equal(back["params"]["w"], t2["params"]["w"])


def test_async_save_copies_before_it_returns(tmp_path):
    """The train step writes params and moments in place: what an async
    save writes is the tree as it was when ``save`` returned."""
    t = tree()
    want = [a.clone() for a in leaves(t)]
    th = ckpt.save(str(tmp_path), 4, t, blocking=False)
    with torch.no_grad():
        for a in leaves(t):
            a.add_(1)
    th.join()
    back = ckpt.restore(str(tmp_path), 4, meta(t), device="cpu")
    for a, b in zip(want, leaves(back)):
        assert torch.equal(a, b)


def jax_tree(t):
    """The same values as a tree of jax arrays (bf16 through its bits)."""
    def one(v):
        if v.dtype == torch.bfloat16:
            return jnp.asarray(v.view(torch.int16).numpy()).view(jnp.bfloat16)
        return jnp.asarray(v.numpy())
    return {k: jax_tree(v) if isinstance(v, dict) else one(v)
            for k, v in t.items()}


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A tree with f32, bf16 (random bits, not only zeros) and a 0-dim
    int32 step: written by either package, every file and the manifest
    are the same bytes, and each package restores the other's checkpoint
    bit for bit."""
    t = tree(3)
    t["params"]["b"] = torch.randn((8,), generator=torch.Generator()
                                   .manual_seed(4)).to(torch.bfloat16)
    jt = jax_tree(t)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jckpt.save(str(jdir), 6, jt)
    ckpt.save(str(tdir), 6, t)
    jfiles = sorted(p.name for p in (jdir / "step_6").iterdir())
    assert jfiles == sorted(p.name for p in (tdir / "step_6").iterdir())
    assert "params__b.npy" in jfiles and "opt__step.npy" in jfiles
    for name in jfiles:
        assert (jdir / "step_6" / name).read_bytes() == \
            (tdir / "step_6" / name).read_bytes(), name
    manifest = json.loads((tdir / "step_6" / "manifest.json").read_text())
    assert manifest["leaves"]["params/b"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["opt/step"] == {
        "file": "opt__step.npy", "shape": [], "dtype": "int32"}
    # the port restores the JAX package's checkpoint, and the reverse
    back = ckpt.restore(str(jdir), 6, meta(t), device="cpu")
    for a, b in zip(leaves(t), leaves(back)):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
    example = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                           jt)
    jback = jckpt.restore(str(tdir), 6, example)
    for a, b in zip(jax.tree.leaves(jt), jax.tree.leaves(jback)):
        assert a.dtype == b.dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    assert ckpt.latest_step(str(jdir)) == jckpt.latest_step(str(tdir)) == 6


def test_restore_runs_on_cuda_by_default(tmp_path, monkeypatch):
    t = tree()
    ckpt.save(str(tmp_path), 1, t)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ckpt.restore(str(tmp_path), 1, meta(t))
