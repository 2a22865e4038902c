"""The port's model stack (``repro_torch.models``) held against the JAX
package's on the same parameters (``jax.random`` draws carried across by
``models.from_numpy``) and the same numpy batches: the twins of
tests/test_models.py (the arch smoke x10, prefill/decode consistency x3,
the VLM loss), every reduced arch at f32 and bf16, the prefill KV caches,
the decode-state layout and the f8 cache.

Tolerances: f32 whole models ``rtol = atol = 1e-4`` (sum order through
4-8 layers); rwkv's f32 forward 1e-3, because the reference rounds each
step of its parallel time-mix to bf16 and a sum-order difference can flip
one rounding (2^-8 relative on that step); bf16 the JAX suite's own
``ATOL`` (0.12, rwkv 0.35) with a mean deviation below 0.02.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import models as jm
from repro_torch import configs, models

import test_models as ref

F32_TOL = 1e-4
F32_TOL_RWKV = 1e-3


def cfgs(arch_id, dtype):
    """The reduced config of ``arch_id`` at ``dtype``: (port's, JAX's)."""
    return (dataclasses.replace(configs.reduced(configs.get_config(arch_id)),
                                dtype=dtype),
            dataclasses.replace(jcfg.reduced(jcfg.get_config(arch_id)),
                                dtype=dtype))


def params_both(tcfg, jc_, seed):
    jp = jm.make_params(jc_, jax.random.PRNGKey(seed))
    return models.from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                             device="cpu"), jp


def batch_np(jc_, B, S, kind, seed):
    """tests/test_models.py's batch, drawn with numpy."""
    r = np.random.default_rng(seed)
    out = {}
    for k, v in jm.input_specs(jc_, S, B, kind).items():
        if v.dtype == jnp.int32:
            out[k] = r.integers(0, jc_.vocab, v.shape).astype(np.int32)
        else:
            out[k] = (r.standard_normal(v.shape) * 0.02).astype(np.float32)
    if "mrope_pos" in out:
        out["mrope_pos"] = np.tile(np.arange(S, dtype=np.int32)[None, :, None],
                                   (B, 1, 3))
    return out


def batch_both(batch, dtype):
    jd = jnp.dtype(dtype)
    jb = {k: jnp.asarray(v).astype(jd) if v.dtype == np.float32
          else jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(np.asarray(jb[k].astype(jnp.float32)))
          .to(getattr(torch, dtype)) if v.dtype == np.float32
          else torch.from_numpy(v) for k, v in batch.items()}
    return jb, tb


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_matches(got, want, arch_id, dtype, what):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, what
    if dtype == "float32":
        tol = F32_TOL_RWKV if arch_id == "rwkv6-3b" else F32_TOL
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=f"{arch_id} f32 {what}")
    else:
        tol = ref.ATOL.get(arch_id, 0.12)
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=f"{arch_id} bf16 {what}")
        assert np.abs(got - want).mean() < 0.02, (arch_id, what)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's outputs, computed once per (arch, dtype) in a
    worker and shared by the tests that read them."""
    cache = {}

    def get(arch_id, dtype, B=2, S=64):
        key = (arch_id, dtype, B, S)
        if key not in cache:
            tcfg, jc_ = cfgs(arch_id, dtype)
            tp, jp = params_both(tcfg, jc_, 0)
            batch = batch_np(jc_, B, S, "train", 1)
            jb, tb = batch_both(batch, dtype)
            out = dict(tcfg=tcfg, tp=tp, tb=tb, loss=jax.jit(
                lambda p, b: jm.lm_loss(jc_, p, b))(jp, jb))
            if jc_.has_decode:
                pre = {k: v for k, v in jb.items() if k != "targets"}
                out["prefill"] = jax.jit(
                    lambda p, b: jm.prefill(jc_, p, b))(jp, pre)
                state = jm.init_decode_state(jc_, B, S + 4)
                out["decode"] = jax.jit(
                    lambda p, s, t: jm.decode_step(jc_, p, s, t, jnp.asarray(
                        S, jnp.int32)))(jp, state, jnp.arange(B, dtype=jnp.int32))
            cache[key] = out
        return cache[key]

    return get


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch_id", jcfg.ARCH_IDS)
def test_arch_smoke(arch_id, dtype, reference):
    """Twin of tests/test_models.py::test_arch_smoke (B, S = 2, 64): the
    port's loss is finite and near ln(vocab), prefill and one decode step
    give finite logits of the right shape; and each equals the
    reference's on the same params and batch."""
    r = reference(arch_id, dtype)
    tcfg, tp, tb = r["tcfg"], r["tp"], r["tb"]
    B, S = 2, 64
    loss = models.lm_loss(tcfg, tp, tb)
    assert torch.isfinite(loss)
    assert abs(float(loss) - np.log(tcfg.vocab)) < 2.0, float(loss)
    assert_matches(loss, r["loss"], arch_id, dtype, "loss")
    if not tcfg.has_decode:
        assert "prefill" not in r
        return
    pre = {k: v for k, v in tb.items() if k != "targets"}
    logits, kvs = models.prefill(tcfg, tp, pre)
    assert logits.shape == (B, tcfg.vocab)
    assert torch.isfinite(logits.float()).all()
    jlogits, jkvs = r["prefill"]
    assert_matches(logits, jlogits, arch_id, dtype, "prefill logits")
    assert len(kvs) == len(jkvs)
    for (k, v), (jk, jv) in zip(kvs, jkvs):
        assert_matches(k, jk, arch_id, dtype, "prefill K cache")
        assert_matches(v, jv, arch_id, dtype, "prefill V cache")
    state = models.init_decode_state(tcfg, B, S + 4, device="cpu")
    state, lg = models.decode_step(tcfg, tp, state,
                                   torch.arange(B, dtype=torch.int32), S)
    assert torch.isfinite(lg.float()).all()
    jstate, jlg = r["decode"]
    assert_matches(lg, jlg, arch_id, dtype, "decode logits")
    for pos, fields in jstate.items():
        for name, want in fields.items():
            got = state[pos][name]
            assert tuple(got.shape) == want.shape
            assert str(got.dtype)[6:] == str(want.dtype)
            assert_matches(got, want, arch_id, dtype, f"state {pos}/{name}")


@pytest.mark.parametrize("arch_id", ["qwen1.5-0.5b", "rwkv6-3b",
                                     "jamba-v0.1-52b"])
def test_prefill_decode_consistency(arch_id):
    """Twin of tests/test_models.py::test_prefill_decode_consistency: the
    port's teacher-forced decode reproduces its own parallel forward at
    the JAX suite's tolerance, and its decode logits equal the
    reference's decode at every position."""
    tcfg, jc_ = cfgs(arch_id, "bfloat16")
    tp, jp = params_both(tcfg, jc_, 1)
    B, S = 2, 16
    toks = np.random.default_rng(1).integers(0, tcfg.vocab, (B, S)) \
        .astype(np.int32)
    tt = torch.from_numpy(toks)
    h, _, _ = models.forward(tcfg, tp, {"tokens": tt}, remat_policy="none")
    head = tp["embed"].T if tcfg.tie_embeddings else tp["lm_head"]
    full = h @ head
    state = models.init_decode_state(tcfg, B, S, device="cpu")
    outs = []
    for t in range(S):
        state, lg = models.decode_step(tcfg, tp, state, tt[:, t], t)
        outs.append(lg)
    dec = torch.stack(outs, dim=1)
    a, b = f32(dec), f32(full)
    tol = ref.ATOL[arch_id]
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)
    assert np.abs(a - b).mean() < 0.02, np.abs(a - b).mean()

    jstate = jm.init_decode_state(jc_, B, S)
    step = jax.jit(lambda p, s, t, i: jm.decode_step(jc_, p, s, t, i))
    jouts = []
    for t in range(S):
        jstate, lg = step(jp, jstate, jnp.asarray(toks[:, t]),
                          jnp.asarray(t, jnp.int32))
        jouts.append(lg)
    assert_matches(dec, jnp.stack(jouts, axis=1), arch_id, "bfloat16",
                   "teacher-forced decode")


def test_vlm_loss_uses_text_positions_only(reference):
    """Twin of tests/test_models.py::test_vlm_loss_uses_text_positions_only
    (B, S = 2, 64: 48 text positions, 16 patches), the loss equal to the
    reference's."""
    r = reference("qwen2-vl-2b", "bfloat16")
    loss = models.lm_loss(r["tcfg"], r["tp"], r["tb"])
    assert torch.isfinite(loss)
    assert r["tb"]["tokens"].shape[1] == 48
    assert r["tb"]["patch_embeds"].shape[1] == 16
    assert_matches(loss, r["loss"], "qwen2-vl-2b", "bfloat16", "loss")


@pytest.mark.parametrize("arch_id", jcfg.ARCH_IDS)
def test_decode_state_layout_matches(arch_id):
    """The reference's stacked layout, key for key, shape and dtype, also
    abstract (``meta``) and with an f8 KV dtype."""
    cfg, jc_ = configs.get_config(arch_id), jcfg.get_config(arch_id)
    if not cfg.has_decode:
        return
    for kv_dtype in (None, "float8_e4m3fn"):
        got = models.init_decode_state(cfg, 2, 4096, abstract=True,
                                       kv_dtype=kv_dtype)
        want = jm.init_decode_state(jc_, 2, 4096, abstract=True,
                                    kv_dtype=kv_dtype)
        assert got.keys() == want.keys()
        for pos in want:
            assert got[pos].keys() == want[pos].keys()
            for name, w in want[pos].items():
                g = got[pos][name]
                assert g.device.type == "meta"
                assert (tuple(g.shape), str(g.dtype)[6:]) == \
                    (w.shape, str(w.dtype)), (arch_id, pos, name)


def test_f8_cache_decode_keeps_the_reference_nan():
    """An f8 KV cache (``kv_dtype="float8_e4m3fn"``), K pushed past 448 by
    its bias in one head: the reference stores NaN there (ml_dtypes), and
    so does the port (torch's cast would store 448); the cache's bits and
    the logits (NaN where the reference's are) equal the reference's."""
    tcfg, jc_ = cfgs("qwen1.5-0.5b", "float32")
    jp = jm.make_params(jc_, jax.random.PRNGKey(4))
    bk = np.zeros(jp["layers"]["pos0"]["attn"]["bk"].shape, np.float32)
    bk[0, :32] = 1000.0                     # group 0, KV head 0
    jp["layers"]["pos0"]["attn"]["bk"] = jnp.asarray(bk)
    tp = models.from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    B, S = 2, 8
    toks = np.array([5, 9], np.int32)
    st = models.init_decode_state(tcfg, B, S, kv_dtype="float8_e4m3fn",
                                  device="cpu")
    jst = jm.init_decode_state(jc_, B, S, kv_dtype="float8_e4m3fn")
    for t in range(2):
        st, lg = models.decode_step(tcfg, tp, st, torch.from_numpy(toks), t)
        jst, jlg = jm.decode_step(jc_, jp, jst, jnp.asarray(toks),
                                  jnp.asarray(t, jnp.int32))
    k, jk = st["pos0"]["k"], np.asarray(jst["pos0"]["k"])
    assert np.isnan(jk.astype(np.float32)).any()
    np.testing.assert_array_equal(np.isnan(f32(k)),
                                  np.isnan(jk.astype(np.float32)))
    # every stored value holds the reference's bits (NaN's own bits aside)
    ok = ~np.isnan(jk.astype(np.float32))
    np.testing.assert_array_equal(k.view(torch.uint8).numpy()[ok],
                                  jk.view(np.uint8)[ok])
    np.testing.assert_array_equal(np.isnan(f32(lg)), np.isnan(f32(jlg)))
    fin = ~np.isnan(f32(jlg))
    np.testing.assert_allclose(f32(lg)[fin], f32(jlg)[fin], rtol=F32_TOL,
                               atol=F32_TOL)


def test_remat_policy_takes_the_reference_values():
    tcfg, _ = cfgs("qwen1.5-0.5b", "float32")
    tp = models.make_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    outs = [models.forward(tcfg, tp, batch, remat_policy=p)[0]
            for p in ("full", "dots", "none")]
    assert all(torch.equal(o, outs[0]) for o in outs)
    with pytest.raises(ValueError, match="remat_policy"):
        models.forward(tcfg, tp, batch, remat_policy="offload")


def test_decode_step_takes_a_device_position_and_writes_in_place():
    """``pos`` as a 0-dim tensor gives the same step as an int, and the
    step writes the stacked cache in place (the state's storage is kept)."""
    tcfg, _ = cfgs("qwen1.5-0.5b", "float32")
    tp = models.make_params(tcfg, torch.Generator().manual_seed(1), "cpu")
    toks = torch.tensor([1, 2], dtype=torch.int32)
    a = models.init_decode_state(tcfg, 2, 8, device="cpu")
    b = models.init_decode_state(tcfg, 2, 8, device="cpu")
    ptr = a["pos0"]["k"].data_ptr()
    a, la = models.decode_step(tcfg, tp, a, toks, 3)
    b, lb = models.decode_step(tcfg, tp, b, toks, torch.tensor(3))
    assert a["pos0"]["k"].data_ptr() == ptr
    assert torch.equal(la, lb) and torch.equal(a["pos0"]["k"], b["pos0"]["k"])
    written = a["pos0"]["k"].abs().sum(dim=(0, 1, 3, 4))
    assert written[3] > 0 and (written[torch.arange(8) != 3] == 0).all()
