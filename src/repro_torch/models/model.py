"""Architecture assembly: ArchConfig -> params / loss / prefill / decode
(twin of the JAX package's ``models/model.py``, same names, parameter
layout and decode-state layout).

Layers are grouped into *periods* (dense archs: period 1; llama4-maverick:
2 — MoE every other layer; jamba: 8 — attention at offset 3, MoE on odd
offsets) and parameters are stacked over period groups: every leaf under
``params["layers"]["pos{i}"]`` has a leading group axis ``G``.  Where the
reference scans over the groups, the port loops over them in Python,
running one group's views of the stacked tensors.

Decode state per period position (stacked over groups, as the reference's):
  attention  -> KV cache {"k", "v"}: [G, B, S, KH, Dh]
  mamba      -> {"conv": [G, B, K-1, di], "ssm": [G, B, di, d_state] f32}
  rwkv       -> {"wkv": [G, B, H, 64, 64] f32, "x_tm", "x_cm": [G, B, D]}
``decode_step`` updates it in place (the cache write at ``pos`` is one
``index_copy_``; the reference's ``.at[:, pos].set`` is aliased by XLA).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..configs.base import ArchConfig, torch_dtype
from ..device import resolve_device
from . import layers, mamba as mamba_mod, moe as moe_mod, rwkv as rwkv_mod
from .modules import (REMAT_POLICIES, ParamSpec, abstract_params,
                      batch_layout, init_params, local_share, merge_heads,
                      on_dims, pinned, reduce_over, remat, replicated,
                      row_parallel, settled, split_heads, tree_leaves,
                      tree_map, whole)

F32 = torch.float32


# ---------------------------------------------------------------------------
# layer schedule
# ---------------------------------------------------------------------------
def period_of(cfg: ArchConfig) -> int:
    p = cfg.attn_every
    if cfg.moe is not None:
        p = max(p, cfg.moe.every)
        if p % cfg.moe.every:
            raise ValueError(f"period {p} vs moe.every {cfg.moe.every}")
    if cfg.attn_every > 1 and p % cfg.attn_every:
        raise ValueError(f"period {p} vs attn_every {cfg.attn_every}")
    return p


def layer_kinds(cfg: ArchConfig) -> List[Tuple[str, str]]:
    """(mixer, ffn) kind per period position."""
    kinds = []
    for i in range(period_of(cfg)):
        if cfg.rwkv:
            mixer = "time_mix"
        elif cfg.mamba is not None and cfg.attn_every > 1:
            # jamba: one attention layer per period, at offset attn_every//2-1
            mixer = "attn" if i == (cfg.attn_every // 2 - 1) else "mamba"
        else:
            mixer = "attn"
        if cfg.rwkv:
            ffn = "channel_mix"
        elif cfg.moe is not None and (i % cfg.moe.every
                                      == cfg.moe.every - 1):
            ffn = "moe"
        else:
            ffn = "mlp"
        kinds.append((mixer, ffn))
    return kinds


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------
def _norm_specs(cfg: ArchConfig, name: str) -> Dict[str, ParamSpec]:
    s = {f"{name}_scale": ParamSpec((cfg.d_model,), ("embed",),
                                    dtype="float32", init="ones")}
    if cfg.encoder_only:   # hubert uses LayerNorm with bias
        s[f"{name}_bias"] = ParamSpec((cfg.d_model,), ("embed",),
                                      dtype="float32", init="zeros")
    return s


def _attn_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, H, KH, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype
    s = {
        "wq": ParamSpec((d, H * Dh), ("embed", "heads_mm"), dtype=dt),
        "wk": ParamSpec((d, KH * Dh), ("embed", "kv_mm"), dtype=dt),
        "wv": ParamSpec((d, KH * Dh), ("embed", "kv_mm"), dtype=dt),
        "wo": ParamSpec((H * Dh, d), ("heads_mm", "embed"), dtype=dt,
                        init="scaled"),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((H * Dh,), ("heads_mm",), dtype=dt, init="zeros")
        s["bk"] = ParamSpec((KH * Dh,), ("kv_mm",), dtype=dt, init="zeros")
        s["bv"] = ParamSpec((KH * Dh,), ("kv_mm",), dtype=dt, init="zeros")
    return s


def _mlp_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    if cfg.mlp == "swiglu":
        return {"w_gate": ParamSpec((d, f), ("embed", "ff"), dtype=dt),
                "w_up": ParamSpec((d, f), ("embed", "ff"), dtype=dt),
                "w_down": ParamSpec((f, d), ("ff", "embed"), dtype=dt,
                                    init="scaled")}
    if cfg.mlp == "squared_relu":
        return {"w_in": ParamSpec((d, f), ("embed", "ff"), dtype=dt),
                "w_out": ParamSpec((f, d), ("ff", "embed"), dtype=dt,
                                   init="scaled")}
    # gelu (hubert)
    return {"w_in": ParamSpec((d, f), ("embed", "ff"), dtype=dt),
            "b_in": ParamSpec((f,), ("ff",), dtype=dt, init="zeros"),
            "w_out": ParamSpec((f, d), ("ff", "embed"), dtype=dt,
                               init="scaled"),
            "b_out": ParamSpec((d,), ("embed",), dtype=dt, init="zeros")}


def _position_specs(cfg: ArchConfig, mixer: str, ffn: str) -> Dict:
    s: Dict[str, Any] = {}
    s.update(_norm_specs(cfg, "norm1"))
    if mixer == "attn":
        s["attn"] = _attn_specs(cfg)
    elif mixer == "mamba":
        mb = cfg.mamba
        s["mamba"] = mamba_mod.mamba_param_specs(
            cfg.d_model, mb.d_state, mb.d_conv, mb.expand, cfg.dtype)
    elif mixer == "time_mix":
        s["time_mix"] = rwkv_mod.rwkv_time_mix_specs(cfg.d_model, cfg.dtype)
    s.update(_norm_specs(cfg, "norm2"))
    if ffn == "moe":
        s["moe"] = moe_mod.moe_param_specs(
            cfg.d_model, cfg.moe.d_ff, cfg.moe.n_experts, cfg.mlp,
            cfg.moe.shared_expert, cfg.dtype)
    elif ffn == "mlp":
        s["mlp"] = _mlp_specs(cfg)
    else:
        s["channel_mix"] = rwkv_mod.rwkv_channel_mix_specs(
            cfg.d_model, cfg.d_ff, cfg.dtype)
    return s


def _stack_specs(tree, n: int):
    """Prepend a stacking ("layers") axis to every spec in the tree."""
    return tree_map(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.logical_axes,
                            dtype=s.dtype, init=s.init, scale=s.scale), tree)


def param_specs(cfg: ArchConfig) -> Dict:
    period = period_of(cfg)
    n_groups = cfg.n_layers // period
    if n_groups * period != cfg.n_layers:
        raise ValueError(f"{cfg.n_layers} layers in periods of {period}")
    kinds = layer_kinds(cfg)
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                           dtype=cfg.dtype),
        "final_norm": _norm_specs(cfg, "final"),
        "layers": {f"pos{i}": _stack_specs(_position_specs(cfg, *kinds[i]),
                                           n_groups)
                   for i in range(period)},
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab),
                                     ("embed", "vocab"), dtype=cfg.dtype)
    if cfg.frontend == "vision":
        specs["patch_proj"] = ParamSpec((cfg.d_model, cfg.d_model),
                                        ("embed", "embed_out"),
                                        dtype=cfg.dtype)
    return specs


def _n_groups(layers) -> int:
    return tree_leaves(layers)[0].shape[0]


def _group(tree, g: int):
    """Group ``g``'s views of a tree of stacked tensors."""
    return tree_map(lambda a: a[g], tree)


def _groups(tree):
    """Every group's views of a tree of stacked tensors, one group at a
    time, through one ``unbind`` per leaf (whose backward stacks the
    groups' grads once, where indexing would add a full-size zero tensor
    per group).  A DTensor view is pinned to its layout as its group comes
    up, so that the backward pass lays each group's grad out as its param
    (a partial sum reduced into its shards) as soon as the group's own
    backward ends: autograd runs a later-made node first, and a pin made
    before the previous group's ops would wait for the last group."""
    parts = tree_map(lambda a: a.unbind(0), tree)
    for g in range(_n_groups(tree)):
        yield tree_map(lambda t: pinned(t[g]), parts)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------
def _norm(cfg: ArchConfig, p, name, x):
    if cfg.encoder_only:
        return layers.layer_norm(x, p[f"{name}_scale"], p[f"{name}_bias"],
                                 cfg.norm_eps)
    return layers.rms_norm(x, p[f"{name}_scale"], cfg.norm_eps)


def _qkv(cfg: ArchConfig, w, x):
    """q, k, v projections of x [..., D] (biases added), unsplit."""
    q, k, v = x @ w["wq"], x @ w["wk"], x @ w["wv"]
    if cfg.qkv_bias:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    return q, k, v


def _attn_full(cfg: ArchConfig, w, x, positions, mrope_pos=None):
    """Training/prefill attention over the full sequence."""
    B, S, D = x.shape
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _qkv(cfg, w, x)
    q = split_heads(q, H, Dh, KH)
    k = split_heads(k, KH, Dh, KH)
    v = split_heads(v, KH, Dh, KH)
    if cfg.rope == "rope":
        q = layers.apply_rope(q, positions)
        k = layers.apply_rope(k, positions)
    elif cfg.rope == "mrope":
        q = layers.apply_mrope(q, mrope_pos)
        k = layers.apply_mrope(k, mrope_pos)
    out = layers.chunked_attention(q, k, v, causal=not cfg.encoder_only)
    return row_parallel(merge_heads(out), w["wo"]), (k, v)


def _apply_group_full(cfg: ArchConfig, kinds, gparams, x, positions,
                      mrope_pos, collect_kv: bool, kv_constraint=None):
    """One period of layers (full-sequence mode).  Returns (x, aux, kvs)."""
    aux = torch.zeros((), dtype=F32, device=x.device)
    kvs = []
    for i, (mixer, ffn) in enumerate(kinds):
        p = gparams[f"pos{i}"]
        h = _norm(cfg, p, "norm1", x)
        if mixer == "attn":
            y, kv = _attn_full(cfg, p["attn"], h, positions, mrope_pos)
            if collect_kv:
                kvs.append(kv if kv_constraint is None
                           else tuple(kv_constraint(t) for t in kv))
        elif mixer == "mamba":
            y = mamba_mod.mamba_apply(p["mamba"], h)
        else:
            y = rwkv_mod.time_mix_apply(p["time_mix"], h)
        x = x + settled(y)
        h = _norm(cfg, p, "norm2", x)
        if ffn == "moe":
            y, a = moe_mod.moe_apply(p["moe"], h, top_k=cfg.moe.top_k,
                                     capacity_factor=cfg.moe.capacity_factor,
                                     mlp=cfg.mlp)
            aux = aux + a
        elif ffn == "mlp":
            y = layers.mlp_apply(cfg.mlp, h, p["mlp"])
        else:
            y = rwkv_mod.channel_mix_apply(p["channel_mix"], h)
        x = x + settled(y)
    return x, aux, kvs


def _vocab_slice(mesh, vocab, rows: int, ids):
    """(``ids`` as indices into this rank's slice of a vocab sharded over
    the mesh dims ``vocab``, ``rows`` ids a slice, clamped into it; the
    mask of the ids the slice holds)."""
    first = 0
    for i in sorted(vocab):
        first = first * mesh.size(i) + mesh.get_local_rank(i)
    t = ids.long() - first * rows
    return t.clamp(0, rows - 1), (t >= 0) & (t < rows)


def _lookup(embed, tokens):
    """``embed[tokens]``.  A DTensor table has its embed dim gathered first
    (under ``FSDP_RULES`` it is sharded over "data", as the batch is, and
    DTensor would gather the batch, then the whole [B, S, D] result), and
    one sharded over its vocab is read on each rank's vocab slice and its
    batch rows: each rank looks up the tokens its slice holds, the rows
    are summed across the vocab ranks, and the table's grad stays on the
    slice (DTensor's ``index`` gathers the whole table, and the backward
    of its ``embedding`` makes a grad of the whole table on every rank)."""
    if not isinstance(embed, DTensor):
        return embed[tokens]
    embed = whole(embed, -1)
    mesh = embed.device_mesh
    vocab = {i for i, p in enumerate(embed.placements) if p == Shard(0)}
    if not vocab:
        return embed[tokens]
    tokens = replicated(tokens, mesh)
    batch, tpl = batch_layout(tokens, vocab)
    table = local_share(embed, on_dims(mesh.ndim, vocab, Shard(0)), batch)
    t, mine = _vocab_slice(mesh, vocab, table.shape[0],
                           tokens.redistribute(mesh, tpl).to_local())
    return reduce_over(torch.where(mine[..., None], table[t], 0), mesh,
                       vocab, pl=tpl)


def _embed(cfg: ArchConfig, params, batch):
    """Token/frontend embedding.  Returns (x [B,S,D], mrope_pos or None)."""
    dt = torch_dtype(cfg.dtype)
    if cfg.frontend == "audio":
        x = batch["frame_embeds"].to(dt)
        pe = layers.sinusoidal_positions(x.shape[1], cfg.d_model, x.device)
        return x + pe.to(x.dtype), None
    x = _lookup(params["embed"], batch["tokens"])
    mrope_pos = None
    if cfg.frontend == "vision":
        patches = batch["patch_embeds"].to(x.dtype) @ params["patch_proj"]
        x = torch.cat([patches, x], dim=1)
        mrope_pos = batch["mrope_pos"]
    return x, mrope_pos


def _head(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _logits_chunk(cfg, params, h):
    return h @ _head(cfg, params)


def forward(cfg: ArchConfig, params, batch, *, remat_policy: str = "full",
            collect_kv: bool = False, act_constraint=None,
            kv_constraint=None):
    """Full-sequence forward.  Returns (hidden [B,S,D], aux, kv_caches).

    ``kv_caches``: one (k, v) pair per attention position of the period,
    each [G, B, S, KH, Dh] (empty unless ``collect_kv``).
    ``remat_policy`` ("full", "dots", "none", the reference's) chooses
    what autograd keeps of each layer group for the backward pass
    (``modules.remat``): "full" the group's input only, "dots" also its
    products with no batch dims, "none" everything.  The values do not
    depend on it, and without autograd it costs nothing.
    ``act_constraint``: optional fn applied to the [B,S,D] residual stream
    at every group boundary.
    ``kv_constraint``: optional fn applied to each layer's collected k and
    v [B,S,KH,Dh] (``sharding.kv_constraint``).
    """
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {remat_policy!r} not in "
                         f"{REMAT_POLICIES}")
    kinds = layer_kinds(cfg)
    x, mrope_pos = _embed(cfg, params, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    if act_constraint is not None:
        x = act_constraint(x)

    def group_fn(gparams, x):
        y, aux, kv = _apply_group_full(cfg, kinds, gparams, x, positions,
                                       mrope_pos, collect_kv, kv_constraint)
        if act_constraint is not None:
            y = act_constraint(y)
        return y, aux, kv

    auxs, kvs = [], []
    for gparams in _groups(params["layers"]):
        x, aux, kv = remat(group_fn, gparams, x, policy=remat_policy)
        auxs.append(aux)
        kvs.append(kv)
    x = _norm(cfg, params["final_norm"], "final", x)
    stacked = tuple((torch.stack([kv[j][0] for kv in kvs]),
                     torch.stack([kv[j][1] for kv in kvs]))
                    for j in range(len(kvs[0]))) if collect_kv else ()
    return x, torch.stack(auxs).sum(), stacked


def _vocab_parallel_loss_chunk(head, hc, tc, vocab):
    """``_loss_chunk`` on each rank's batch rows and vocab slice, where the
    DTensor ``head`` [D, V] shards V over the mesh dims ``vocab``: the
    logits stay [B / dp, C, V / tp] (the reference's GSPMD layout), the
    logsumexp combines each rank's max and sum of exponentials over the
    vocab ranks, and the target's logit comes from the rank whose slice
    holds it (a mask, then a sum over the vocab ranks).  Returns the sum
    as a 0-dim DTensor, partial over the batch's mesh dims."""
    mesh = head.device_mesh
    batch, xpl = batch_layout(hc, vocab)
    hc_l = local_share(hc, xpl, vocab)
    head_l = local_share(head, on_dims(mesh.ndim, vocab, Shard(1)), batch)
    tc_l = replicated(tc, mesh).redistribute(mesh, xpl).to_local()

    def over_vocab(x, op):
        return reduce_over(x, mesh, vocab, op).to_local()
    logits = (hc_l @ head_l).to(F32)
    mx = over_vocab(logits.detach().amax(dim=-1), "max")
    lse = mx + torch.log(over_vocab(
        torch.exp(logits - mx[..., None]).sum(dim=-1), "sum"))
    t, mine = _vocab_slice(mesh, vocab, logits.shape[-1], tc_l)
    picked = torch.gather(logits, -1, t[..., None])[..., 0]
    picked = over_vocab(torch.where(mine, picked, 0.0), "sum")
    return DTensor.from_local((lse - picked).sum(), mesh,
                              on_dims(mesh.ndim, batch, Partial()))


def _loss_chunk(head, hc, tc):
    """Summed cross entropy of one chunk: hc [B, C, D], tc [B, C]."""
    if isinstance(head, DTensor):
        vocab = {i for i, p in enumerate(head.placements) if p == Shard(1)}
        if vocab:
            return _vocab_parallel_loss_chunk(head, hc, tc, vocab)
    logits = whole((hc @ head).to(F32), -1)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, tc[..., None].long())[..., 0]
    return (lse - picked).sum()


def lm_loss(cfg: ArchConfig, params, batch, *, remat_policy: str = "full",
            loss_chunk: int = 512, aux_weight: float = 0.01,
            act_constraint=None):
    """Next-token (or frame-target) cross entropy, chunked over S.  Under
    autograd the layer groups follow ``remat_policy`` (see ``forward``)
    and each loss chunk is rematerialized, as the reference's (its
    [B, chunk, V] logits are never kept for the backward pass)."""
    h, aux, _ = forward(cfg, params, batch, remat_policy=remat_policy,
                        act_constraint=act_constraint)
    targets = batch["targets"]
    if cfg.frontend == "vision":     # loss over text positions only
        h = h[:, -targets.shape[1]:, :]
    B, S, D = h.shape
    loss_chunk = min(loss_chunk, S)
    nc = S // loss_chunk
    head = _head(cfg, params)
    total = torch.zeros((), dtype=F32, device=h.device)
    for c in range(nc):
        sl = slice(c * loss_chunk, (c + 1) * loss_chunk)
        total = total + remat(_loss_chunk, head, h[:, sl], targets[:, sl])
    return total / (B * nc * loss_chunk) + aux_weight * aux


def prefill(cfg: ArchConfig, params, batch, *, remat_policy: str = "none",
            act_constraint=None, kv_constraint=None):
    """Returns (last-token logits [B, V], stacked KV caches per position)."""
    h, _, kvs = forward(cfg, params, batch, remat_policy=remat_policy,
                        collect_kv=cfg.n_heads > 0 and not cfg.rwkv,
                        act_constraint=act_constraint,
                        kv_constraint=kv_constraint)
    logits = _logits_chunk(cfg, params, h[:, -1:, :])[:, 0]
    return logits, kvs


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
# |x| above this rounds past float8_e4m3fn's largest finite value (448):
# the reference (ml_dtypes) gives NaN there, torch's cast saturates
_E4M3FN_OVERFLOW = 464.0


def store_cast(x, dtype: torch.dtype):
    """``x.astype(dtype)`` as the reference casts into the decode state."""
    y = x.to(dtype)
    if dtype == torch.float8_e4m3fn:
        y = torch.where(x.abs() > _E4M3FN_OVERFLOW,
                        torch.full_like(y, float("nan")), y)
    return y


def _write_at(cache, pos, x):
    """cache[:, pos] = x (cast as the reference casts), in place: one
    ``index_copy_``, through a byte view for f8 caches (which
    ``index_copy_`` does not take)."""
    x = store_cast(x, cache.dtype)[:, None]
    if cache.element_size() == 1:
        cache, x = cache.view(torch.uint8), x.view(torch.uint8)
    cache.index_copy_(1, pos, x)


def on_cache_shards(q, k, v, k_state, v_state, g: int, pos):
    """Group ``g``'s cache write and decode attention on each rank's shard
    of the DTensor caches ``k_state`` / ``v_state`` [G, B, S, KH, Dh], laid
    out as ``kv_cache_sharding`` lays them out (batch over DP, Dh over
    "model"): q [B, H, Dh] and the new k, v [B, KH, Dh] are laid out as
    the caches' shards, k and v written into the local shards, the
    scores' partial sums over the local Dh summed across the ranks that
    hold the rest of it (an all-reduce of [B, KH, G, S]), and the value
    product taken on the local shards.  No DTensor op sees the cache
    (DTensor's own einsums over it gather the query's heads and the
    probabilities instead); on a mesh whose every dim replicates, the
    local ops are the one-device path's."""
    mesh = k_state.device_mesh
    to_qkv = {1: 0, 4: 2}              # cache dim -> dim of q / k / v
    if any(isinstance(p, Shard) and p.dim not in to_qkv
           for p in k_state.placements):
        raise ValueError(f"cache placements {k_state.placements}")
    pl = [Shard(to_qkv[p.dim]) if isinstance(p, Shard) else Replicate()
          for p in k_state.placements]
    shape = tuple(q.shape)
    q, k, v = (x.redistribute(mesh, pl).to_local() for x in (q, k, v))
    k_cache, v_cache = k_state.to_local()[g], v_state.to_local()[g]
    _write_at(k_cache, pos, k)
    _write_at(v_cache, pos, v)
    partial = [Partial() if isinstance(p, Shard) and p.dim == 2 else p
               for p in pl]
    whole = [Replicate() if isinstance(p, Partial) else p for p in partial]

    def score_sum(s):
        if partial == whole:
            return s
        glob = (shape[0],) + tuple(s.shape[1:])
        st = DTensor.from_local(s, mesh, partial, shape=torch.Size(glob),
                                stride=_strides(glob))
        return st.redistribute(mesh, whole).to_local()
    length = (pos + 1).expand(q.shape[0])
    out = layers.decode_attention(q, k_cache, v_cache, length=length,
                                  head_dim=shape[-1], score_sum=score_sum)
    return DTensor.from_local(out, mesh, pl, shape=torch.Size(shape),
                              stride=_strides(shape))


def _strides(shape) -> tuple:
    return tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))


def init_decode_state(cfg: ArchConfig, batch: int, max_seq: int,
                      abstract: bool = False,
                      kv_dtype: Optional[str] = None, device=None) -> Dict:
    """Per-period-position decode state, stacked over groups (zeros, or
    ``meta`` tensors when ``abstract``).

    ``kv_dtype``: override the KV-cache element type (e.g.
    "float8_e4m3fn"; values past its range are stored as NaN, as the
    reference's cast stores them).
    """
    period = period_of(cfg)
    G = cfg.n_layers // period
    kinds = layer_kinds(cfg)
    dt = torch_dtype(kv_dtype or cfg.dtype)
    dev = torch.device("meta") if abstract else resolve_device(device)
    state: Dict[str, Any] = {}

    def make(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    for i, (mixer, _) in enumerate(kinds):
        key = f"pos{i}"
        if mixer == "attn":
            KH, Dh = cfg.n_kv_heads, cfg.head_dim
            state[key] = {
                "k": make((G, batch, max_seq, KH, Dh), dt),
                "v": make((G, batch, max_seq, KH, Dh), dt)}
        elif mixer == "mamba":
            di = cfg.mamba.expand * cfg.d_model
            K = cfg.mamba.d_conv
            state[key] = {
                "conv": make((G, batch, K - 1, di), dt),
                "ssm": make((G, batch, di, cfg.mamba.d_state), F32)}
        else:  # rwkv time-mix (+ channel-mix shift registers)
            H = cfg.d_model // rwkv_mod.HEAD
            state[key] = {
                "wkv": make((G, batch, H, rwkv_mod.HEAD, rwkv_mod.HEAD), F32),
                "x_tm": make((G, batch, cfg.d_model), dt),
                "x_cm": make((G, batch, cfg.d_model), dt)}
    return state


def decode_step(cfg: ArchConfig, params, state: Dict, tokens,
                pos) -> Tuple[Dict, torch.Tensor]:
    """One decode step: tokens [B] (int), pos (the cache write index: an
    int, or a 0-dim integer tensor on the state's device, which keeps the
    step free of host reads).

    Returns (state, logits [B, V]); ``state`` is the same dict, updated
    in place.
    """
    kinds = layer_kinds(cfg)
    x = _lookup(params["embed"], tokens)                 # [B, D]
    B, D = x.shape
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if any(m == "attn" for m, _ in kinds):
        pos = torch.as_tensor(pos, device=x.device).reshape(1).long()
        posv = pos.expand(B)[:, None]                    # [B, 1]
        length = (pos + 1).expand(B)

    for g in range(_n_groups(params["layers"])):
        gparams = _group(params["layers"], g)
        for i, (mixer, ffn) in enumerate(kinds):
            p = gparams[f"pos{i}"]
            full = state[f"pos{i}"]
            h = _norm(cfg, p, "norm1", x)
            if mixer == "attn":
                q, k, v = _qkv(cfg, p["attn"], h)
                q = split_heads(q, H, Dh, KH)
                k = split_heads(k, KH, Dh, KH)
                v = split_heads(v, KH, Dh, KH)
                if cfg.rope in ("rope", "mrope"):
                    # decode positions are text positions; M-RoPE with equal
                    # (t, h, w) components reduces exactly to RoPE
                    q = layers.apply_rope(q[:, None], posv)[:, 0]
                    k = layers.apply_rope(k[:, None], posv)[:, 0]
                if isinstance(full["k"], DTensor):
                    y = on_cache_shards(q, k, v, full["k"], full["v"], g, pos)
                else:
                    k_cache, v_cache = full["k"][g], full["v"][g]
                    _write_at(k_cache, pos, k)
                    _write_at(v_cache, pos, v)
                    y = layers.decode_attention(q, k_cache, v_cache,
                                                length=length)
                y = merge_heads(y) @ p["attn"]["wo"]
            elif mixer == "mamba":
                st = {"conv": full["conv"][g], "ssm": full["ssm"][g]}
                ns, y = mamba_mod.mamba_decode(p["mamba"], st, h)
                for key in ("conv", "ssm"):
                    full[key][g].copy_(store_cast(ns[key], full[key].dtype))
            else:
                wkv, y = rwkv_mod.time_mix_decode(p["time_mix"], full["wkv"][g],
                                                  full["x_tm"][g], h)
                full["wkv"][g].copy_(wkv)
                full["x_tm"][g].copy_(store_cast(h, full["x_tm"].dtype))
            x = x + y
            h = _norm(cfg, p, "norm2", x)
            if ffn == "moe":
                y, _ = moe_mod.moe_apply(p["moe"], h[:, None, :],
                                         top_k=cfg.moe.top_k,
                                         capacity_factor=4.0, mlp=cfg.mlp)
                y = y[:, 0]
            elif ffn == "mlp":
                y = layers.mlp_apply(cfg.mlp, h, p["mlp"])
            else:
                y = rwkv_mod.channel_mix_decode(p["channel_mix"],
                                                full["x_cm"][g], h)
                full["x_cm"][g].copy_(store_cast(h, full["x_cm"].dtype))
            x = x + y
    x = _norm(cfg, params["final_norm"], "final", x)
    return state, _logits_chunk(cfg, params, x)


# ---------------------------------------------------------------------------
# input specs (stand-ins for the stubbed frontends), params
# ---------------------------------------------------------------------------
def input_specs(cfg: ArchConfig, seq_len: int, batch: int,
                kind: str) -> Dict[str, torch.Tensor]:
    """The batch's inputs as ``meta`` tensors (shape and dtype)."""
    i32 = torch.int32
    dt = torch_dtype(cfg.dtype)

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if kind == "decode":
        return {"tokens": spec((batch,), i32)}
    if cfg.frontend == "audio":
        specs = {"frame_embeds": spec((batch, seq_len, cfg.d_model), dt)}
        if kind == "train":
            specs["targets"] = spec((batch, seq_len), i32)
        return specs
    if cfg.frontend == "vision":
        s_img = seq_len // 4                       # stubbed patch stream
        s_txt = seq_len - s_img
        specs = {
            "tokens": spec((batch, s_txt), i32),
            "patch_embeds": spec((batch, s_img, cfg.d_model), dt),
            "mrope_pos": spec((batch, seq_len, 3), i32),
        }
        if kind == "train":
            specs["targets"] = spec((batch, s_txt), i32)
        return specs
    specs = {"tokens": spec((batch, seq_len), i32)}
    if kind == "train":
        specs["targets"] = spec((batch, seq_len), i32)
    return specs


def make_abstract_params(cfg: ArchConfig):
    return abstract_params(param_specs(cfg))


def make_params(cfg: ArchConfig, generator: torch.Generator, device=None):
    return init_params(param_specs(cfg), generator, device)


def from_numpy(cfg: ArchConfig, tree, device=None) -> Dict:
    """The port's params from a tree of numpy arrays with the reference's
    layout (e.g. ``jax.tree.map(np.asarray, params)`` of the JAX
    package's ``make_params``), each cast to its spec's dtype.  bfloat16
    arrays (``ml_dtypes``, which ``torch.from_numpy`` refuses) go through
    their 16-bit pattern."""
    dev = resolve_device(device)

    def tensor(spec: ParamSpec, a):
        a = np.asarray(a)
        if a.shape != tuple(spec.shape):
            raise ValueError(f"shape {a.shape} != spec {spec.shape}")
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        return t.to(device=dev, dtype=torch_dtype(spec.dtype))

    specs = param_specs(cfg)
    if set(tree) != set(specs):
        raise ValueError(f"keys {sorted(tree)} != {sorted(specs)}")
    return tree_map(tensor, specs, tree)
