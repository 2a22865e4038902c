"""The model stack's modules on the port (``repro_torch.models``: layers,
moe, mamba, rwkv, modules) held against the JAX package's on the same
numpy inputs, module by module, and the cases where PyTorch's default
differs from JAX's, each of which the naive mapping fails:

  * GELU: ``jax.nn.gelu`` is the tanh approximation, ``F.gelu`` is not;
  * top-k ties: ``jax.lax.top_k`` gives the lower index;
  * MoE capacity: positions token-major, dropped tokens, ``seq_chunk``;
  * f8 stores: ml_dtypes casts past e4m3fn's range to NaN, torch
    saturates to 448;
  * RWKV's parallel time-mix rounds each step's output to bf16;
  * bf16 numpy arrays, which ``torch.from_numpy`` refuses;
  * a fully masked attention row is the uniform mean, not NaN.

Tolerances, each with its reason: f32 elementwise ops 1e-6 (the same f32
ops, libm against XLA's transcendental functions); f32 products and sums
1e-5 (sum order); bf16 outputs (``bf16_close``) within 2^-6 of the
output's largest magnitude, two bf16 steps there, and a mean error below
2^-8 of its mean magnitude: XLA's compiled code may keep a bf16
intermediate in f32 (its excess-precision rule drops an f32 -> bf16 -> f32
round trip), which the port's eager ops round, and a sum-order difference
can flip a rounding.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import layers as jl, mamba as jmb, moe as jmoe, \
    rwkv as jrw, modules as jmod
from repro_torch.models import layers as tl, mamba as tmb, moe as tmoe, \
    rwkv as trw, modules as tmod
from repro_torch.models.model import store_cast
from test_torch_engine import fresh_jax_caches  # noqa: F401 (autouse)

F32_EW, F32_SUM = 1e-6, 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def rng(seed):
    return np.random.default_rng(seed)


def normal(r, shape, scale=1.0):
    return (r.standard_normal(shape) * scale).astype(np.float32)


def both(a, dtype="float32"):
    """numpy f32 -> (jax array, torch tensor) of ``dtype``, equal values."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(a).astype(jd)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)
    return j, t


def tree_both(tree, dtype="float32"):
    js, ts = {}, {}
    for k, v in tree.items():
        js[k], ts[k] = both(v, dtype)
    return js, ts


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def bf16_close(got, want, mean_rel=2 ** -8):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert err.max() <= 2 ** -6 * np.abs(want).max(), \
        (err.max(), np.abs(want).max())
    assert err.mean() <= mean_rel * np.abs(want).mean(), \
        (err.mean(), np.abs(want).mean())


def close(got, want, dtype="float32", tol=F32_SUM, mean_rel=2 ** -8):
    if dtype == "bfloat16":
        bf16_close(got, want, mean_rel)
    else:
        np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


# --------------------------------------------------------------------------
# norms, rotary embeddings, positions
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_norms(dtype):
    r = rng(0)
    jx, tx = both(normal(r, (2, 8, 128), 3.0), dtype)
    js, ts = both(1 + normal(r, (128,), 0.1))
    jb, tb = both(normal(r, (128,), 0.1))
    close(tl.rms_norm(tx, ts), jl.rms_norm(jx, js), dtype, F32_EW)
    close(tl.layer_norm(tx, ts, tb), jl.layer_norm(jx, js, jb), dtype, F32_EW)
    assert tl.rms_norm(tx, ts).dtype == tx.dtype


@pytest.mark.parametrize("dtype", DTYPES)
def test_rope_and_mrope(dtype):
    r = rng(1)
    jx, tx = both(normal(r, (2, 64, 4, 32)), dtype)
    pos = np.arange(64, dtype=np.int32)[None, :] + np.array([[0], [7]],
                                                             np.int32)
    close(tl.apply_rope(tx, torch.from_numpy(pos)),
          jl.apply_rope(jx, jnp.asarray(pos)), dtype, F32_SUM)
    pos3 = r.integers(0, 64, (2, 64, 3)).astype(np.int32)
    close(tl.apply_mrope(tx, torch.from_numpy(pos3)),
          jl.apply_mrope(jx, jnp.asarray(pos3)), dtype, F32_SUM)


def test_sinusoidal_positions():
    close(tl.sinusoidal_positions(64, 128), jl.sinusoidal_positions(64, 128),
          tol=F32_SUM)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,chunks", [(True, (16, 32)), (True, (64, 64)),
                                           (False, (32, 16))])
def test_chunked_attention(dtype, causal, chunks):
    r = rng(2)
    jq, tq = both(normal(r, (2, 64, 4, 32)), dtype)
    jk, tk = both(normal(r, (2, 64, 2, 32)), dtype)
    jv, tv = both(normal(r, (2, 64, 2, 32)), dtype)
    got = tl.chunked_attention(tq, tk, tv, causal=causal, q_chunk=chunks[0],
                               kv_chunk=chunks[1])
    want = jl.chunked_attention(jq, jk, jv, causal=causal, q_chunk=chunks[0],
                                kv_chunk=chunks[1])
    assert got.dtype == tq.dtype
    close(got, want, dtype, F32_SUM)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_lengths_and_fully_masked_row(dtype):
    """Row 0 has length 0: every score masked, so the reference's finite
    NEG_INF gives the uniform mean of V (``-inf`` would give NaN)."""
    r = rng(3)
    jq, tq = both(normal(r, (3, 4, 32)), dtype)
    jk, tk = both(normal(r, (3, 20, 2, 32)), dtype)
    jv, tv = both(normal(r, (3, 20, 2, 32)), dtype)
    lengths = np.array([0, 5, 20], np.int32)
    got = tl.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    want = jl.decode_attention(jq, jk, jv, jnp.asarray(lengths))
    close(got, want, dtype, F32_SUM)
    assert np.isfinite(f32(got)).all()
    mean = f32(tv)[0].mean(axis=0)                        # [KH, Dh]
    close(got[0].reshape(2, 2, 32), np.broadcast_to(mean[:, None], (2, 2, 32)),
          dtype, F32_SUM)
    close(tl.decode_attention(tq, tk, tv), jl.decode_attention(jq, jk, jv),
          dtype, F32_SUM)


def test_f8_store_matches_the_reference_nan_and_all():
    """The reference's cast to float8_e4m3fn turns what rounds past 448
    into NaN; torch's ``.to`` saturates to 448.  ``store_cast`` keeps the
    reference's bits, on f32 and bf16 sources, NaN and inf included."""
    vals = np.array([0.0, 1e-9, -3.3, 448.0, 463.9, 464.0, 464.01, 465.0,
                     479.0, 1000.0, -1000.0, np.inf, -np.inf, np.nan],
                    np.float32)
    for dtype in DTYPES:
        jx, tx = both(vals, dtype)
        want = np.asarray(jx.astype(jnp.float8_e4m3fn)).view(np.uint8)
        got = store_cast(tx, torch.float8_e4m3fn).view(torch.uint8).numpy()
        np.testing.assert_array_equal(np.isnan(f32(store_cast(
            tx, torch.float8_e4m3fn))), np.isnan(np.asarray(
                jx.astype(jnp.float8_e4m3fn)).astype(np.float32)))
        finite = ~np.isnan(np.asarray(jx.astype(jnp.float8_e4m3fn))
                           .astype(np.float32))
        np.testing.assert_array_equal(got[finite], want[finite])
        # the naive cast saturates where the reference has NaN
        naive = tx.to(torch.float8_e4m3fn).float().numpy()
        assert np.isnan(naive[~finite & ~np.isnan(vals)]).sum() == 0
        assert (~finite & ~np.isnan(vals)).any()


def test_decode_attention_f8_cache():
    r = rng(4)
    jq, tq = both(normal(r, (2, 4, 32)), "bfloat16")
    k, v = normal(r, (2, 16, 2, 32)), normal(r, (2, 16, 2, 32))
    jk = jnp.asarray(k).astype(jnp.float8_e4m3fn)
    jv = jnp.asarray(v).astype(jnp.float8_e4m3fn)
    tk = store_cast(torch.from_numpy(k), torch.float8_e4m3fn)
    tv = store_cast(torch.from_numpy(v), torch.float8_e4m3fn)
    np.testing.assert_array_equal(tk.view(torch.uint8).numpy(),
                                  np.asarray(jk).view(np.uint8))
    lengths = np.array([9, 16], np.int32)
    close(tl.decode_attention(tq, tk, tv, torch.from_numpy(lengths)),
          jl.decode_attention(jq, jk, jv, jnp.asarray(lengths)), "bfloat16")


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------
def mlp_weights(r, kind, d=64, f=96):
    if kind == "swiglu":
        return {"w_gate": normal(r, (d, f), 0.1), "w_up": normal(r, (d, f), 0.1),
                "w_down": normal(r, (f, d), 0.1)}
    w = {"w_in": normal(r, (d, f), 0.1), "w_out": normal(r, (f, d), 0.1)}
    if kind == "gelu":
        w.update(b_in=normal(r, (f,), 0.1), b_out=normal(r, (d,), 0.1))
    return w


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["swiglu", "squared_relu", "gelu"])
def test_mlp_apply(kind, dtype):
    r = rng(5)
    jx, tx = both(normal(r, (2, 8, 64)), dtype)
    jw, tw = tree_both(mlp_weights(r, kind), dtype)
    close(tl.mlp_apply(kind, tx, tw), jl.mlp_apply(kind, jx, jw), dtype)


def test_gelu_is_the_tanh_approximation():
    """With identity projections and zero biases ``mlp_apply("gelu")`` is
    the activation itself: the port equals ``jax.nn.gelu``'s default to
    1e-6; PyTorch's default (``approximate='none'``) misses by more."""
    x = np.linspace(-6, 6, 64, dtype=np.float32)[None, None, :]
    eye = np.eye(64, dtype=np.float32)
    w = {"w_in": eye, "w_out": eye, "b_in": np.zeros(64, np.float32),
         "b_out": np.zeros(64, np.float32)}
    jw, tw = tree_both(w)
    jx, tx = both(x)
    want = jl.mlp_apply("gelu", jx, jw)
    close(tl.mlp_apply("gelu", tx, tw), want, tol=F32_EW)
    assert np.abs(F.gelu(tx).numpy() - f32(want)).max() > 1e-4


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------
def moe_weights(r, mlp="swiglu", shared=False, d=64, f=32, e=4):
    specs = tmoe.moe_param_specs(d, f, e, mlp, shared, "float32")
    return {k: normal(r, s.shape, 0.2) for k, s in specs.items()}


def moe_both(w, dtype):
    """Router in f32 (its spec's dtype), the rest in ``dtype``."""
    jw, tw = tree_both(w, dtype)
    jw["router"], tw["router"] = both(w["router"])
    return jw, tw


def positions_loop(sel, E):
    """Each (token, k-slot)'s place in its expert's buffer, counted
    token-major (s, then k): the reference's capacity order."""
    B, S, K = sel.shape
    pos = np.zeros_like(sel)
    for b in range(B):
        seen = np.zeros(E, np.int64)
        for s in range(S):
            for k in range(K):
                pos[b, s, k] = seen[sel[b, s, k]]
                seen[sel[b, s, k]] += 1
    return pos


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mlp,shared,top_k", [("swiglu", True, 1),
                                              ("swiglu", False, 2),
                                              ("squared_relu", False, 2)])
def test_moe_apply_matches(mlp, shared, top_k, dtype):
    r = rng(6)
    w = moe_weights(r, mlp, shared)
    jw, tw = moe_both(w, dtype)
    jx, tx = both(normal(r, (2, 16, 64)), dtype)
    got, aux = tmoe.moe_apply(tw, tx, top_k=top_k, capacity_factor=1.25,
                              mlp=mlp)
    want, jaux = jmoe.moe_apply(jw, jx, top_k=top_k, capacity_factor=1.25,
                                mlp=mlp)
    close(got, want, dtype)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=F32_SUM)


def test_moe_routing_integers_exact_and_dropped_tokens():
    """At capacity factor 0.5 (C = 4 for 16 tokens, top-2 of 4 experts)
    tokens overflow: ``sel`` equals ``jax.lax.top_k`` on the reference's
    probabilities, positions and the keep mask equal the token-major
    count, the dispatch one-hots hold each kept slot once, a token whose
    slots both dropped comes out zero, and the output equals the
    reference's.  A k-major count would keep other tokens."""
    r = rng(7)
    w = moe_weights(r)
    jw, tw = moe_both(w, "float32")
    jx, tx = both(normal(r, (2, 16, 64)), "float32")
    rt = tmoe.route(tw["router"], tx, top_k=2, capacity_factor=0.5)
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", jx, jw["router"]), -1)
    jvals, jsel = jax.lax.top_k(probs, 2)
    np.testing.assert_array_equal(rt.sel.numpy(), np.asarray(jsel))
    close(rt.gate_vals, jvals, tol=F32_EW)
    pos = positions_loop(rt.sel.numpy(), 4)
    np.testing.assert_array_equal(rt.pos.numpy(), pos)
    np.testing.assert_array_equal(rt.keep.numpy(), pos < 4)
    assert not rt.keep.all()
    kmajor = positions_loop(rt.sel.numpy().transpose(0, 2, 1)[..., None]
                            .reshape(2, 32, 1), 4).reshape(2, 2, 16) \
        .transpose(0, 2, 1)
    assert ((kmajor < 4) != (pos < 4)).any()
    d = rt.dispatch.numpy()                               # [B,S,E,C]
    assert set(np.unique(d)) <= {0.0, 1.0}
    assert d.sum() == rt.keep.sum() and (d.sum(axis=1) <= 1).all()
    got, _ = tmoe.moe_apply(tw, tx, top_k=2, capacity_factor=0.5,
                            mlp="swiglu")
    want, _ = jmoe.moe_apply(jw, jx, top_k=2, capacity_factor=0.5,
                             mlp="swiglu")
    close(got, want)
    dropped = ~rt.keep.numpy().any(-1)
    assert dropped.any() and (got.numpy()[dropped] == 0).all()


def test_moe_top_k_ties_go_to_the_lower_index():
    """Experts 0, 1 and 3 have one router column, so every token's
    probabilities tie among them (the pattern
    [0.5, 0.5, 0.1, 0.5]): JAX picks experts 0 and 1, the port too, and the experts'
    own weights differ, so the output shows the choice."""
    r = rng(8)
    w = moe_weights(r)
    col = normal(r, (64,), 0.2)
    w["router"][:, [0, 1, 3]] = col[:, None]
    w["router"][:, 2] = -col
    jw, tw = moe_both(w, "float32")
    jx, tx = both(np.abs(normal(r, (1, 8, 64))), "float32")
    rt = tmoe.route(tw["router"], tx, top_k=2, capacity_factor=4.0)
    p = rt.probs.numpy()
    assert (p[..., 0] == p[..., 1]).all() and (p[..., 1] == p[..., 3]).all()
    assert (rt.sel.numpy() == [0, 1]).all()
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", jx, jw["router"]), -1)
    np.testing.assert_array_equal(np.asarray(jax.lax.top_k(probs, 2)[1]),
                                  rt.sel.numpy())
    vals, sel = tmoe.stable_top_k(torch.tensor([0.5, 0.5, 0.1, 0.5]), 2)
    assert sel.tolist() == [0, 1] and vals.tolist() == [0.5, 0.5]
    close(tmoe.moe_apply(tw, tx, top_k=2, capacity_factor=4.0,
                         mlp="swiglu")[0],
          jmoe.moe_apply(jw, jx, top_k=2, capacity_factor=4.0,
                         mlp="swiglu")[0])


def test_moe_seq_chunk_has_its_own_capacity():
    """S = 32 in chunks of 8: capacity and positions per chunk, aux the
    chunks' mean, as the reference; without the split the drops differ."""
    r = rng(9)
    w = moe_weights(r)
    jw, tw = moe_both(w, "float32")
    jx, tx = both(normal(r, (2, 32, 64)), "float32")
    got, aux = tmoe.moe_apply(tw, tx, top_k=2, capacity_factor=1.0,
                              mlp="swiglu", seq_chunk=8)
    want, jaux = jmoe.moe_apply(jw, jx, top_k=2, capacity_factor=1.0,
                                mlp="swiglu", seq_chunk=8)
    close(got, want)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=F32_SUM)
    whole, _ = tmoe.moe_apply(tw, tx, top_k=2, capacity_factor=1.0,
                              mlp="swiglu")
    assert np.abs(whole.numpy() - f32(want)).max() > 1e-3


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mlp,shared,top_k", [("swiglu", True, 1),
                                              ("squared_relu", False, 2)])
def test_moe_two_seq_chunks_match(mlp, shared, top_k, dtype):
    """S = 2 * seq_chunk: the port's chunk loop against the reference's
    scan over two chunks, output and aux loss."""
    r = rng(10)
    w = moe_weights(r, mlp, shared)
    jw, tw = moe_both(w, dtype)
    jx, tx = both(normal(r, (2, 16, 64)), dtype)
    got, aux = tmoe.moe_apply(tw, tx, top_k=top_k, capacity_factor=1.0,
                              mlp=mlp, seq_chunk=8)
    want, jaux = jmoe.moe_apply(jw, jx, top_k=top_k, capacity_factor=1.0,
                                mlp=mlp, seq_chunk=8)
    close(got, want, dtype)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=F32_SUM)


# --------------------------------------------------------------------------
# Mamba
# --------------------------------------------------------------------------
def mamba_weights(r, d=64):
    specs = tmb.mamba_param_specs(d, 16, 4, 2, "float32")
    w = {k: normal(r, s.shape, 0.2) for k, s in specs.items()}
    w["A_log"] = np.log(np.tile(np.arange(1, 17, dtype=np.float32), (128, 1)))
    w["D"] = np.ones(128, np.float32)
    return w


def mamba_both(w, dtype):
    jw, tw = tree_both(w, dtype)
    for k in ("dt_bias", "A_log", "D"):        # f32 in their specs
        jw[k], tw[k] = both(w[k])
    return jw, tw


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_apply_and_decode(dtype):
    """The chunked forward (chunks of 8 over 32 steps, the state and conv
    tail carried) and step-by-step decode against the reference's."""
    r = rng(10)
    jw, tw = mamba_both(mamba_weights(r), dtype)
    jx, tx = both(normal(r, (2, 32, 64)), dtype)
    # bf16: the reference's compiled scan keeps each step's bf16 output in
    # f32 (excess precision), the port rounds it as the code says: a mean
    # error of 2^-7 of the output here, hence 2^-6
    close(tmb.mamba_apply(tw, tx, chunk=8), jmb.mamba_apply(jw, jx, chunk=8),
          dtype, mean_rel=2 ** -6)
    close(tmb.causal_conv(tx @ tw["in_proj"][:, :128], tw["conv_w"],
                          tw["conv_b"]),
          jmb.causal_conv(jnp.einsum("bsd,de->bse", jx, jw["in_proj"])[..., :128],
                          jw["conv_w"], jw["conv_b"]), dtype)
    st = tmb.mamba_decode_init(tw, 2)
    jst = jmb.mamba_decode_init(jw, 2)
    for t in range(4):
        st, y = tmb.mamba_decode(tw, st, tx[:, t])
        jst, jy = jmb.mamba_decode(jw, jst, jx[:, t])
        close(y, jy, dtype)
        close(st["ssm"], jst["ssm"], dtype)
        close(st["conv"], jst["conv"], dtype)


# --------------------------------------------------------------------------
# RWKV
# --------------------------------------------------------------------------
def rwkv_weights(r, d=128, f=256):
    tm = {k: normal(r, s.shape, 0.3 if s.dtype == "float32" else 0.1)
          for k, s in trw.rwkv_time_mix_specs(d, "float32").items()}
    tm["mu_r"] = r.uniform(0, 1, d).astype(np.float32)
    tm["decay_base"] = np.full(d, -1.0, np.float32)
    cm = {k: normal(r, s.shape, 0.1)
          for k, s in trw.rwkv_channel_mix_specs(d, f, "float32").items()}
    return tm, cm


def rwkv_both(w, dtype, f32_keys):
    jw, tw = tree_both(w, dtype)
    for k in f32_keys:
        jw[k], tw[k] = both(w[k])
    return jw, tw


TM_F32 = ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "decay_base", "decay_A",
          "decay_B", "bonus_u", "ln_scale")


def test_rwkv_time_mix_rounds_its_steps_to_bf16():
    """f32 weights and input: the reference's parallel time-mix rounds each
    step's output to bf16 and its decode does not.  The port's parallel
    path sits at the reference's (a sum-order flip of one bf16 rounding
    at most), far closer than the reference's own decode path, which is
    what a port without the rounding would give."""
    r = rng(11)
    tm, _ = rwkv_weights(r)
    jw, tw = rwkv_both(tm, "float32", TM_F32)
    jx, tx = both(normal(r, (2, 32, 128)), "float32")
    want = f32(jrw.time_mix_apply(jw, jx, chunk=8))
    got = f32(trw.time_mix_apply(tw, tx, chunk=8))
    st = jnp.zeros((2, 2, 64, 64), jnp.float32)
    prev = jnp.zeros((2, 128), jnp.float32)
    no_round = []
    for t in range(32):
        st, y = jrw.time_mix_decode(jw, st, prev, jx[:, t])
        prev = jx[:, t]
        no_round.append(f32(y))
    naive_err = np.abs(np.stack(no_round, 1) - want).mean()
    err = np.abs(got - want).mean()
    assert naive_err > 1e-5
    assert err < naive_err / 20, (err, naive_err)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rwkv_decode_and_channel_mix(dtype):
    r = rng(12)
    tm, cm = rwkv_weights(r)
    jw, tw = rwkv_both(tm, dtype, TM_F32)
    jc, tc = rwkv_both(cm, dtype, ("mu_k", "mu_r"))
    jx, tx = both(normal(r, (2, 8, 128)), dtype)
    close(trw.channel_mix_apply(tc, tx), jrw.channel_mix_apply(jc, jx), dtype)
    close(trw.time_mix_apply(tw, tx), jrw.time_mix_apply(jw, jx), dtype,
          2e-3)   # its bf16 steps: one rounding may flip (see above)
    st, jst = torch.zeros(2, 2, 64, 64), jnp.zeros((2, 2, 64, 64))
    prev, jprev = tx[:, 0] * 0, jx[:, 0] * 0
    for t in range(3):
        st, y = trw.time_mix_decode(tw, st, prev, tx[:, t])
        jst, jy = jrw.time_mix_decode(jw, jst, jprev, jx[:, t])
        close(y, jy, dtype)
        close(st, jst, "float32")
        close(trw.channel_mix_decode(tc, prev, tx[:, t]),
              jrw.channel_mix_decode(jc, jprev, jx[:, t]), dtype)
        prev, jprev = tx[:, t], jx[:, t]


# --------------------------------------------------------------------------
# modules: specs, init, bf16 numpy
# --------------------------------------------------------------------------
def test_init_params_follows_the_reference_init():
    specs = {"a": jmod.ParamSpec((4096, 8), ("x", "y"), "float32", "normal"),
             "b": {"c": jmod.ParamSpec((1024, 64), ("x", "y"), "bfloat16",
                                       "scaled"),
                   "z": jmod.ParamSpec((3,), ("x",), "float32", "zeros"),
                   "o": jmod.ParamSpec((3,), ("x",), "bfloat16", "ones")}}
    tspecs = {"a": tmod.ParamSpec(*dataclasses.astuple(specs["a"])),
              "b": {k: tmod.ParamSpec(*dataclasses.astuple(s))
                    for k, s in specs["b"].items()}}
    p = tmod.init_params(tspecs, torch.Generator().manual_seed(0), "cpu")
    jp = jmod.init_params(specs, jax.random.PRNGKey(0))
    for path, (got, want) in {"a": (p["a"], jp["a"]),
                              "c": (p["b"]["c"], jp["b"]["c"]),
                              "z": (p["b"]["z"], jp["b"]["z"]),
                              "o": (p["b"]["o"], jp["b"]["o"])}.items():
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype)[6:] == str(want.dtype), path
        # same distribution: std within 5% (32k draws), zeros and ones exact
        np.testing.assert_allclose(f32(got).std(), f32(want).std(), rtol=0.05)
    assert (p["b"]["z"] == 0).all() and (p["b"]["o"] == 1).all()
    np.testing.assert_allclose(p["b"]["c"].float().std(), 0.02 / 32, rtol=0.05)
    assert tmod.count_params(tspecs) == jmod.count_params(specs)
    abstract = tmod.abstract_params(tspecs)
    assert abstract["b"]["c"].device.type == "meta"
    assert abstract["b"]["c"].dtype == torch.bfloat16
    again = tmod.init_params(tspecs, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["a"], p["a"])


def test_bf16_numpy_arrays_cross_bit_for_bit():
    """``torch.from_numpy`` refuses ml_dtypes' bfloat16; ``from_numpy``
    carries the bits across exactly."""
    from repro import configs as jcfg, models as jm
    from repro_torch import configs, models
    cfg = configs.reduced(configs.get_config("qwen1.5-0.5b"))
    jp = jax.tree.map(np.asarray, jm.make_params(
        jcfg.reduced(jcfg.get_config("qwen1.5-0.5b")), jax.random.PRNGKey(3)))
    assert jp["embed"].dtype == ml_dtypes.bfloat16
    with pytest.raises(TypeError):
        torch.from_numpy(jp["embed"])
    tp = models.from_numpy(cfg, jp, device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["embed"].view(torch.int16).numpy(),
                                  jp["embed"].view(np.int16))
    w = tp["layers"]["pos0"]["attn"]["wq"]
    np.testing.assert_array_equal(
        w.float().numpy(), jp["layers"]["pos0"]["attn"]["wq"].astype(np.float32))
    assert tp["layers"]["pos0"]["norm1_scale"].dtype == torch.float32
    bad = dict(jp, embed=jp["embed"][:, :64])
    with pytest.raises(ValueError, match="shape"):
        models.from_numpy(cfg, bad, device="cpu")
