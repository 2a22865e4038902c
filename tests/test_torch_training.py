"""The port's training path (``repro_torch.training``, ``models.lm_loss``
under autograd) held against the JAX package's on the same params
(``models.from_numpy``) and batches: the optimizer's pieces, one jitted
train step of each reduced arch at f32 and bf16, microbatching, the remat
policies, and the twins of tests/test_training.py's five training tests
(its two data tests are in tests/test_torch_data.py).

Tolerances, stated once:

* the bias corrections and ``quantize_int8``: bitwise (the port calls
  glibc's ``powf``, as XLA's CPU backend does, and multiplies by the f32
  reciprocal where XLA folds a division by a constant into one); the
  learning rate within one ulp of its peak (torch's ``cos``, not glibc's
  ``cosf``);
* ``adamw_update`` / ``_factored_update`` / ``clip_by_global_norm``: 4
  ulps (``2^-21``) of each element and of its leaf's largest value:
  XLA's CPU backend contracts ``b1 * m + (1 - b1) * g`` into one fused
  multiply-add, the port rounds the product (shown bitwise by
  ``test_xla_fuses_the_moment_update``), which shows most where the two
  products nearly cancel;
* a train step, f32: loss, grad norm and params after the step to
  ``rtol = atol = 1e-4``; the moments (0.1 and 0.05 of the clipped grad
  and its square) to ``1e-4`` of each leaf's largest value.  rwkv:
  ``1e-2`` of the leaf's largest and of the grad norm (its grads inherit
  the reference's bf16 rounding of each time-mix step, which gives its
  forward the 1e-3 of tests/test_torch_models.py);
* a train step, bf16: the JAX suite's ``ATOL`` (0.12; rwkv 0.35) on the
  loss, the grad norm (relative) and the params; the moments to ``ATOL``
  of each leaf's largest value with a mean error below 0.02 of it, but
  two cases where the jitted reference keeps f32 inside its fused ops
  and so differs from any op-by-op bf16 run (its own eager run too):
  the expert weights of the MoE archs (near-tied experts swap a token),
  held by the mean, and rwkv's grads, held by its loss and params.  Both
  are held at ATOL against the reference run op by op
  (``test_bf16_grads_match_the_reference_op_by_op``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import models as jm
from repro.training import optimizer as jopt
from repro.training import train as jtrain
from repro_torch import configs, models
from repro_torch.checkpoint.ckpt import _flatten
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.models.modules import tree_leaves, tree_map
from repro_torch.training import optimizer as topt
from repro_torch.training import train as ttrain

import test_models as ref
from test_torch_models import batch_both, batch_np, cfgs, f32, params_both

F32_TOL = 1e-4
F32_TOL_RWKV_GRADS = 1e-2
BF16_MEAN = 0.02
OPT_RTOL = 2.0 ** -21
MOE_ARCHS = ("llama4-maverick-400b-a17b", "llama4-scout-17b-16e",
             "jamba-v0.1-52b")


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


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def reference():
    """One jitted step of the JAX package's ``make_train_step`` (default
    ``TrainConfig``) per (arch, dtype), at B, S = 2, 64, computed once per
    worker; with the port's params and batch for the same step."""
    cache = {}

    def get(arch_id, dtype):
        key = (arch_id, dtype)
        if key not in cache:
            tcfg, jc = cfgs(arch_id, dtype)
            tp, jp = params_both(tcfg, jc, 0)
            jb, tb = batch_both(batch_np(jc, 2, 64, "train", 1), dtype)
            step = jax.jit(jtrain.make_train_step(jc, jtrain.TrainConfig()))
            jps, jst, jmet = step(jp, jopt.init_opt_state(jp), jb)
            cache[key] = dict(tcfg=tcfg, jc=jc, jp=jp, jb=jb, tb=tb,
                              params=np_tree(jps), opt=np_tree(jst),
                              metrics=np_tree(jmet),
                              tp=tree_map(lambda a: a.clone(), tp))
        r = cache[key]
        return dict(r, tp=tree_map(lambda a: a.clone(), r["tp"]))

    return get


def port_step(r, tc=None):
    tp = r["tp"]
    st = topt.init_opt_state(tp)
    step = ttrain.make_train_step(r["tcfg"], tc or ttrain.TrainConfig(),
                                  device="cpu")
    return step(tp, st, r["tb"])


def leaf_errors(got, want):
    """{path: (max, mean) |got - want| over the leaf's largest |want|}."""
    out = {}
    for k, g in _flatten(got).items():
        g, w = f32(g), f32(_flatten(want)[k])
        assert g.shape == w.shape, k
        scale = max(float(np.abs(w).max()), 1e-30)
        d = np.abs(g - w)
        out[k] = (float(d.max()) / scale, float(d.mean()) / scale)
    return out


# ---------------------------------------------------------------------------
# the optimizer's pieces
# ---------------------------------------------------------------------------
OPT_CONFIGS = (dict(), dict(lr=3e-3, warmup_steps=20, total_steps=100),
               dict(lr=1e-3, warmup_steps=0, total_steps=300, b1=0.8,
                    b2=0.999))


@pytest.mark.parametrize("kw", OPT_CONFIGS)
def test_schedule_and_bias_corrections_bitwise(kw):
    """Steps 0-10,000, each computed by the reference as the jitted step
    computes it (a 0-dim step): ``1 - b ** step`` equal bit for bit
    (glibc's ``powf``; torch's own ``pow`` and the division by the warmup
    and decay lengths differ on thousands of them), the learning rate
    within one ulp of its peak (torch's ``cos`` against glibc's
    ``cosf``)."""
    jc, tc = jopt.OptConfig(**kw), topt.OptConfig(**kw)

    def one(s):
        return jnp.stack([jopt.schedule(jc, s),
                          1.0 - jc.b1 ** s.astype(jnp.float32),
                          1.0 - jc.b2 ** s.astype(jnp.float32)])
    steps = np.arange(0, 10001, dtype=np.int32)
    want = np.asarray(jax.jit(lambda s: jax.lax.map(one, s))(steps))
    ts = torch.from_numpy(steps)
    got = torch.stack([topt.schedule(tc, ts),
                       topt._bias_correction(tc.b1, ts),
                       topt._bias_correction(tc.b2, ts)], 1).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got[:, 1:].view(np.int32),
                                  want[:, 1:].view(np.int32))
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=0,
                               atol=np.spacing(np.float32(jc.lr)))


def assert_opt_close(got, want, what=""):
    got, want = f32(got), f32(want)
    np.testing.assert_allclose(got, want, rtol=OPT_RTOL,
                               atol=OPT_RTOL * float(np.abs(want).max()),
                               err_msg=what)


def opt_inputs(r, dtype, shapes):
    p = {k: (r.standard_normal(s) * 0.5).astype(np.float32)
         for k, s in shapes.items()}
    jp = {k: jnp.asarray(v).astype(dtype) for k, v in p.items()}
    tp = {k: torch.from_numpy(np.array(jp[k].astype(jnp.float32)))
          .to(getattr(torch, dtype)) for k in p}
    return jp, tp


SHAPES = {"a": (16, 8), "b": (8,), "c": (3, 4, 5)}


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_optimizer_updates_match_jax(dtype, factored):
    """Four clipped ``adamw_update`` (or ``_factored_update``) steps on
    1-, 2- and 3-dim leaves: the grad norm, params, moments and step
    equal the reference's within 4 ulps, the update in place (the params'
    and moments' storage kept), the factored moments' dtypes the
    reference's (m bf16, vr / vc f32)."""
    r = np.random.default_rng(0)
    jp, tp = opt_inputs(r, dtype, SHAPES)
    kw = dict(lr=1e-2, warmup_steps=2, factored=factored)
    jcfg_, tcfg_ = jopt.OptConfig(**kw), topt.OptConfig(**kw)
    js = jopt.init_opt_state(jp, factored=factored)
    ts = topt.init_opt_state(tp, factored=factored)
    ptrs = [t.data_ptr() for t in tree_leaves(tp) + tree_leaves(ts)]
    upd = jax.jit(lambda p, g, s: jopt.adamw_update(jcfg_, p, g, s))
    clip = jax.jit(lambda g: jopt.clip_by_global_norm(g, 1.0))
    for _ in range(4):
        g = {k: (r.standard_normal(s) * 0.3).astype(np.float32)
             for k, s in SHAPES.items()}
        jg, jn = clip({k: jnp.asarray(v).astype(dtype) for k, v in g.items()})
        tg, tn = topt.clip_by_global_norm(
            {k: torch.from_numpy(v).to(getattr(torch, dtype))
             for k, v in g.items()}, 1.0)
        assert all(tg[k].dtype == tp[k].dtype for k in tg)
        assert_opt_close(tn, jn)
        for k in tg:
            assert_opt_close(tg[k], jg[k], k)
        jp, js = upd(jp, jg, js)
        tp2, ts2 = topt.adamw_update(tcfg_, tp, tg, ts)
        assert tp2 is tp and ts2 is ts
    assert [t.data_ptr() for t in tree_leaves(tp) + tree_leaves(ts)] == ptrs
    assert int(ts["step"]) == int(js["step"]) == 4
    assert ts["step"].dtype == torch.int32
    for name in js:
        if name == "step":
            continue
        for k in SHAPES:
            assert str(ts[name][k].dtype)[6:] == str(js[name][k].dtype)
            assert_opt_close(ts[name][k], js[name][k], f"{name}/{k}")
    for k in SHAPES:
        assert_opt_close(tp[k], jp[k], k)


def test_xla_fuses_the_moment_update():
    """Why the optimizer is held to 4 ulps and not bitwise: the reference's
    ``b1 * m + (1 - b1) * g`` comes out of XLA's CPU backend as one fused
    multiply-add (bitwise equal to it computed in f64 and rounded once),
    where the port, as written, rounds the product first."""
    r = np.random.default_rng(1)
    m = (r.standard_normal(100_000) * 0.01).astype(np.float32)
    g = r.standard_normal(100_000).astype(np.float32)
    want = np.asarray(jax.jit(lambda m, g: 0.9 * m + (1 - 0.9) * g)(m, g))
    b1, ob1 = np.float32(0.9), np.float32(1 - 0.9)
    fused = (np.float64(b1) * m + (ob1 * g).astype(np.float64)) \
        .astype(np.float32)
    np.testing.assert_array_equal(fused, want)
    tm, tg = torch.from_numpy(m), torch.from_numpy(g)
    plain = (float(b1) * tm + float(ob1) * tg).numpy()
    assert (plain != want).any()
    assert_opt_close(plain, want)


def test_opt_state_layouts_match():
    """``init_opt_state`` / ``abstract_opt_state`` (on ``meta``) give the
    reference's keys, shapes and dtypes, factored and not, for a reduced
    arch's whole param tree."""
    cfg, jc = cfgs("jamba-v0.1-52b", "bfloat16")
    tp = models.make_abstract_params(cfg)
    jp = jm.make_abstract_params(jc)
    for factored in (False, True):
        for got in (topt.abstract_opt_state(tp, factored),
                    topt.init_opt_state(tree_map(
                        lambda a: torch.zeros(a.shape, dtype=a.dtype), tp),
                        factored)):
            want = jopt.abstract_opt_state(jp, factored)
            gf, wf = _flatten(got), _flatten(want)
            assert list(gf) == list(wf)
            for k in wf:
                assert (tuple(gf[k].shape), str(gf[k].dtype)[6:]) == \
                    (tuple(wf[k].shape), str(wf[k].dtype)), k
        assert topt.abstract_opt_state(tp, factored)["step"].device.type \
            == "meta"


def test_quantize_int8_matches_jax():
    """Ties at .5 round to even, as ``jnp.round``; random grads: the same
    codes and the same f32 scale (the division by 127 as XLA folds it)."""
    ties = np.array([127, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -127, 126.5],
                    np.float32)
    r = np.random.default_rng(2)
    for g in (ties, r.standard_normal(1000).astype(np.float32) * 0.37):
        q, s = jax.jit(jtrain.quantize_int8)(g)
        tq, tsc = ttrain.quantize_int8(torch.from_numpy(g))
        assert tq.dtype == torch.int8 and tsc.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
        assert float(tsc) == float(s)
        np.testing.assert_array_equal(
            ttrain.dequantize_int8(tq, tsc).numpy(),
            np.asarray(jtrain.dequantize_int8(q, s)))
    q, _ = ttrain.quantize_int8(torch.from_numpy(ties))
    assert q.tolist() == [127, 0, 2, 2, 0, -2, 4, -127, 126]


# ---------------------------------------------------------------------------
# a train step against the reference's
# ---------------------------------------------------------------------------
def expert_leaf(arch_id, key):
    return arch_id in MOE_ARCHS and "/moe/w_" in key


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch_id", jcfg.ARCH_IDS)
def test_train_step_matches_jax(arch_id, dtype, reference):
    """One step of ``make_train_step`` (default TrainConfig: remat "full",
    clipping at 1.0, warmup 100): the metrics, every param and moment
    after the step, against the reference's jitted step, at the module's
    tolerances; the step counter, the dtypes, and the params and moments
    updated in place."""
    r = reference(arch_id, dtype)
    tp = r["tp"]
    ptrs = [t.data_ptr() for t in tree_leaves(tp)]
    tp2, st, met = port_step(r)
    assert tp2 is tp and [t.data_ptr() for t in tree_leaves(tp)] == ptrs
    assert int(st["step"]) == 1 and st["step"].dtype == torch.int32
    assert set(met) == {"loss", "grad_norm", "lr"}
    assert all(m.dtype == torch.float32 and m.dim() == 0
               for m in met.values())
    jmet = r["metrics"]
    assert float(met["lr"]) == float(jmet["lr"])
    rwkv = arch_id == "rwkv6-3b"
    if rwkv and dtype == "bfloat16":
        # its grads: test_bf16_grads_match_the_reference_op_by_op
        tol = ref.ATOL[arch_id]
        np.testing.assert_allclose(f32(met["loss"]), jmet["loss"], rtol=tol,
                                   atol=tol)
        for got, want in zip(tree_leaves(tp), jax.tree.leaves(r["params"])):
            np.testing.assert_allclose(f32(got), f32(want), rtol=tol,
                                       atol=tol)
        return
    if dtype == "float32":
        tol, mv_tol = F32_TOL, (F32_TOL_RWKV_GRADS if rwkv else F32_TOL)
    else:
        tol = mv_tol = ref.ATOL.get(arch_id, 0.12)
    np.testing.assert_allclose(f32(met["loss"]), jmet["loss"], rtol=tol,
                               atol=tol)
    for got, want in zip(tree_leaves(tp), jax.tree.leaves(r["params"])):
        assert str(got.dtype)[6:] == str(want.dtype)
        np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(f32(met["grad_norm"]), jmet["grad_norm"],
                               rtol=mv_tol)
    errs = leaf_errors({"m": st["m"], "v": st["v"]},
                       {"m": r["opt"]["m"], "v": r["opt"]["v"]})
    for k, (mx, mean) in errs.items():
        if dtype == "bfloat16":
            assert mean < BF16_MEAN, (arch_id, k, mean)
            if expert_leaf(arch_id, k):
                continue
        assert mx <= mv_tol, (arch_id, dtype, k, mx)


def port_grads(r):
    """The port's grads of ``lm_loss`` for a reference entry's params and
    batch, as a tree."""
    tp = r["tp"]
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    it = iter(torch.autograd.grad(models.lm_loss(r["tcfg"], tp, r["tb"]),
                                  leaves, allow_unused=True,
                                  materialize_grads=True))
    return tree_map(lambda _: next(it), tp)


@pytest.mark.parametrize("arch_id,B,S", [("llama4-scout-17b-16e", 2, 64),
                                         ("rwkv6-3b", 1, 16)])
def test_bf16_grads_match_the_reference_op_by_op(arch_id, B, S):
    """Why some bf16 grads are held loosely against the jitted reference:
    the jitted step keeps f32 inside its fused ops where eager JAX (and
    torch) round each op's result to bf16, and in these two archs that
    moves the grads (scout: a token's near-tied experts swap; rwkv: its
    group norm amplifies the bf16 rounding of each time-mix step).  Run
    op by op (``jax.disable_jit``), the reference's grads equal the
    port's at ATOL of each leaf's largest value with a mean below 0.02 of
    it; its jitted grads differ from those by more than ATOL."""
    tcfg, jc = cfgs(arch_id, "bfloat16")
    tp, jp = params_both(tcfg, jc, 0)
    jb, tb = batch_both(batch_np(jc, B, S, "train", 1), "bfloat16")
    grad = jax.value_and_grad(lambda p, b: jm.lm_loss(jc, p, b))
    _, g_jit = jax.jit(grad)(jp, jb)
    with jax.disable_jit():
        _, g_eager = grad(jp, jb)
    g_port = port_grads(dict(tcfg=tcfg, tp=tp, tb=tb))
    atol = ref.ATOL.get(arch_id, 0.12)
    port = leaf_errors(g_port, np_tree(g_eager))
    assert max(v[0] for v in port.values()) <= atol, port
    assert max(v[1] for v in port.values()) < BF16_MEAN
    jit = leaf_errors(np_tree(g_jit), np_tree(g_eager))
    assert max(v[0] for v in jit.values()) > atol


def test_microbatches_match_jax():
    """Four microbatches (grads summed in f32, then divided): the port's
    step equals the reference's four-microbatch step in f32 at the
    step's tolerances, grads in f32 through clipping."""
    tcfg, jc = cfgs("qwen1.5-0.5b", "float32")
    tp, jp = params_both(tcfg, jc, 3)
    jb, tb = batch_both(batch_np(jc, 8, 32, "train", 2), "float32")
    jps, jst, jmet = jax.jit(jtrain.make_train_step(
        jc, jtrain.TrainConfig(microbatches=4)))(jp, jopt.init_opt_state(jp),
                                                 jb)
    st = topt.init_opt_state(tp)
    tp, st, met = ttrain.make_train_step(
        tcfg, ttrain.TrainConfig(microbatches=4), device="cpu")(tp, st, tb)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(f32(met[k]), np.asarray(jmet[k]),
                                   rtol=F32_TOL, atol=F32_TOL)
    for got, want in zip(tree_leaves(tp), jax.tree.leaves(jps)):
        np.testing.assert_allclose(f32(got), f32(want), rtol=F32_TOL,
                                   atol=F32_TOL)
    for k, (mx, _) in leaf_errors({"m": st["m"], "v": st["v"]},
                                  np_tree({"m": jst["m"],
                                           "v": jst["v"]})).items():
        assert mx <= F32_TOL, (k, mx)


@pytest.mark.parametrize("arch_id", jcfg.ARCH_IDS)
def test_remat_policies_are_bitwise_equal(arch_id):
    """"full", "dots" and "none" change only what autograd keeps: on the
    CPU one train step under each gives the same loss, grad norm,
    params and moments, bit for bit (f32, B, S = 1, 64)."""
    tcfg, _ = cfgs(arch_id, "float32")
    p0 = models.make_params(tcfg, torch.Generator().manual_seed(5), "cpu")
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in
             batch_np(cfgs(arch_id, "float32")[1], 1, 64, "train", 4).items()}
    outs = []
    for policy in ("full", "dots", "none"):
        tp = tree_map(lambda a: a.clone(), p0)
        st = topt.init_opt_state(tp)
        tc = ttrain.TrainConfig(remat_policy=policy,
                                opt=topt.OptConfig(lr=1e-3, warmup_steps=0))
        outs.append(ttrain.make_train_step(tcfg, tc, device="cpu")(
            tp, st, batch))
    for got in outs[1:]:
        for part, want in zip(got, outs[0]):
            for a, b in zip(tree_leaves(part), tree_leaves(want)):
                assert torch.equal(a, b), arch_id


# ---------------------------------------------------------------------------
# twins of tests/test_training.py
# ---------------------------------------------------------------------------
def test_adamw_matches_reference():
    cfg = topt.OptConfig(lr=1e-2, warmup_steps=0, total_steps=10**9,
                         weight_decay=0.0, grad_clip=1e9)
    params = {"w": torch.tensor([1.0, -2.0, 3.0])}
    grads = {"w": torch.tensor([0.1, 0.2, -0.3])}
    state = topt.init_opt_state(params)
    new_p, state = topt.adamw_update(cfg, params, grads, state)
    # closed-form first step: m_hat = g, v_hat = g^2  =>  delta = sign(g)
    lr = float(topt.schedule(cfg, state["step"]))
    want = np.asarray([1.0, -2.0, 3.0]) - lr * np.sign([0.1, 0.2, -0.3])
    np.testing.assert_allclose(new_p["w"].numpy(), want, atol=1e-4)


def test_factored_update_runs_and_tracks_adamw():
    g = torch.Generator().manual_seed(0)
    w = torch.randn((16, 8), generator=g)
    grads = {"w": torch.randn((16, 8), generator=g) * 0.1}
    p1 = {"w": w.clone()}
    p2 = {"w": w.clone()}
    full = topt.init_opt_state(p1)
    fact = topt.init_opt_state(p2, factored=True)
    topt.adamw_update(topt.OptConfig(lr=1e-3, warmup_steps=0), p1, grads,
                      full)
    topt.adamw_update(topt.OptConfig(lr=1e-3, warmup_steps=0, factored=True),
                      p2, grads, fact)
    # same direction, comparable magnitude (factored v is an approximation)
    d1 = (p1["w"] - w).flatten().numpy()
    d2 = (p2["w"] - w).flatten().numpy()
    cos = d1 @ d2 / (np.linalg.norm(d1) * np.linalg.norm(d2))
    assert cos > 0.7, cos


def test_int8_roundtrip_error_bound():
    g = torch.randn((256,), generator=torch.Generator().manual_seed(0))
    q, scale = ttrain.quantize_int8(g)
    back = ttrain.dequantize_int8(q, scale)
    assert float((back - g).abs().max()) <= float(scale) * 0.5 + 1e-6


def test_loss_decreases_small_model():
    cfg = configs.reduced(configs.get_config("qwen1.5-0.5b"))
    params = models.make_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tc = ttrain.TrainConfig(opt=topt.OptConfig(lr=3e-3, warmup_steps=5,
                                               total_steps=10000))
    step = ttrain.make_train_step(cfg, tc, device="cpu")
    opt_state = topt.init_opt_state(params)
    dc = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8)
    losses = []
    for i in range(30):
        params, opt_state, metrics = step(params, opt_state,
                                          batch_at(dc, i, device="cpu"))
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


def test_microbatching_matches_full_batch():
    cfg = configs.reduced(configs.get_config("qwen1.5-0.5b"))
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8)
    batch = batch_at(dc, 0, device="cpu")
    outs = []
    for tc in (ttrain.TrainConfig(microbatches=1),
               ttrain.TrainConfig(microbatches=4)):
        params = models.make_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
        opt_state = topt.init_opt_state(params)
        step = ttrain.make_train_step(cfg, tc, device="cpu")
        params, _, metrics = step(params, opt_state, batch)
        outs.append((params, metrics))
    np.testing.assert_allclose(float(outs[0][1]["loss"]),
                               float(outs[1][1]["loss"]), rtol=2e-2)
    for a, b in zip(tree_leaves(outs[0][0]), tree_leaves(outs[1][0])):
        np.testing.assert_allclose(f32(a), f32(b), atol=3e-2)


# ---------------------------------------------------------------------------
# one device
# ---------------------------------------------------------------------------
def test_mesh_options_name_the_distributed_slice(tmp_path):
    """The options that once waited for the distributed slice run: on a
    one-rank gloo (1, 1) mesh, ``make_train_step(mesh=...)`` with
    ``seq_shard`` and two microbatches (every placement replicated, the
    batch sharded over a DP axis of 1) equals the one-device step
    bitwise, and so does ``make_compressed_train_step`` without
    compression; with ``compress_grads="int8"`` the grads move by at most
    half a quantum of their scale, so the params stay within ``2 lr``."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import sharding as sh
    cfg = dataclasses.replace(
        configs.reduced(configs.get_config("qwen1.5-0.5b")), dtype="float32")
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    batch = batch_at(dc, 0, device="cpu")
    opt = topt.OptConfig(lr=1e-3, warmup_steps=1)
    base = models.make_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def fresh():
        p = tree_map(lambda a: a.clone(), base)
        return p, topt.init_opt_state(p)

    tc = ttrain.TrainConfig(microbatches=2, seq_shard=True, opt=opt)
    want = ttrain.make_train_step(cfg, tc, device="cpu")(*fresh(), batch)
    plain = ttrain.make_train_step(cfg, ttrain.TrainConfig(opt=opt),
                                   device="cpu")(*fresh(), batch)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = sh.make_mesh((1, 1), ("data", "model"), "cpu")
        specs = models.param_specs(cfg)
        p, st = fresh()
        p = sh.distribute(p, sh.param_shardings(specs, mesh))
        st = sh.distribute(st, sh.opt_state_shardings(specs, mesh))
        got = ttrain.make_train_step(cfg, tc, mesh)(p, st, batch)
        comp = {c: ttrain.make_compressed_train_step(
            cfg, ttrain.TrainConfig(compress_grads=c, opt=opt), mesh)(
                *fresh(), batch) for c in (None, "int8")}
    finally:
        dist.destroy_process_group()
    assert all(isinstance(x, DTensor) for x in tree_leaves(got[0]))
    assert float(got[2]["loss"]) == float(want[2]["loss"])
    for a, b in zip(tree_leaves(got[0]), tree_leaves(want[0])):
        assert torch.equal(a.full_tensor(), b)
    for a, b in zip(tree_leaves(comp[None][0]), tree_leaves(plain[0])):
        assert torch.equal(a, b)
    assert float(comp[None][2]["loss"]) == float(plain[2]["loss"])
    lr = float(plain[2]["lr"])
    err = max(float((a - b).abs().max()) for a, b in
              zip(tree_leaves(comp["int8"][0]), tree_leaves(plain[0])))
    assert 0 < err <= 2 * lr + 1e-6, err


def test_train_step_runs_on_cuda_by_default(monkeypatch):
    cfg = configs.reduced(configs.get_config("qwen1.5-0.5b"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ttrain.make_train_step(cfg, ttrain.TrainConfig())
    step = ttrain.make_train_step(cfg, ttrain.TrainConfig(), device="cpu")
    params = models.make_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params["embed"] = params["embed"].to("meta")
    with pytest.raises(ValueError, match="must lie on"):
        step(params, {}, {})
