"""The port's mesh half on four ``gloo`` ranks (twins of
tests/test_distributed.py, held tighter than its "losses finite"), the
``torchrun`` launcher, and the simulator's lane mesh (twins of
tests/test_service.py's lane-sharding tests).

Each rank is a process of its own (``run_ranks``): it joins a ``gloo``
group through a ``FileStore`` in ``tmp_path`` (so xdist workers never
collide), runs one thread, and prints one JSON line; a rank that fails,
or outlives its timeout, fails the test.

Tolerances: f32 throughout.  A mesh step sums its products and its
reductions in another order than the one-device step, so the loss is
held to rtol 1e-5, the moments to 1e-4 of each leaf's largest, and a
param to ``2 lr + 1e-5`` per step taken: Adam's first step moves an
element by about ``lr`` either way where its grad lies within rounding
of 0.  The factored update's bf16 first moment is held to one bf16
rounding step of each element per step taken.  The int8 compressed step
is held to the JAX package's in quanta of the shared scale: each rank's
quantized grad may round the other way where its f32 grad differs in the
last bits, so the mean over ranks may differ by one quantum.
"""
import fcntl
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core.sweep import LaneMesh, lane_mesh

from test_distributed import run_sub
from test_torch_blocked import assert_bitwise
from test_torch_engine import fresh_jax_caches  # noqa: F401 (autouse)
from test_torch_service import (MIXED_POLICIES, SimQuery, broker,
                                random_trace, solo, tiny_machine)

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
WORLD = 4
PRELUDE = """
import json, os, sys, warnings
warnings.filterwarnings("ignore")
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group(
    "gloo", store=dist.FileStore(os.environ["STORE"], WORLD), rank=RANK,
    world_size=WORLD)
"""
QWEN_F32 = """
import dataclasses
from repro_torch import configs, models
cfg = dataclasses.replace(configs.reduced(configs.get_config("qwen1.5-0.5b")),
                          dtype="float32")
"""


def run_ranks(tmp_path, *code, world=WORLD, timeout=300):
    """``code`` (its parts dedented and joined, after the prelude above)
    as ``world`` gloo ranks; returns
    each rank's last stdout line, parsed as JSON.  A rank that exits
    non-zero, or is still running at ``timeout``, fails the test."""
    script = tmp_path / "rank.py"
    script.write_text(PRELUDE + "".join(textwrap.dedent(c) for c in code)
                      + "\ndist.destroy_process_group()\n")
    procs = []
    for r in range(world):
        env = dict(os.environ, PYTHONPATH=SRC, RANK=str(r),
                   WORLD_SIZE=str(world), STORE=str(tmp_path / "store"),
                   OMP_NUM_THREADS="1")
        out = open(tmp_path / f"rank{r}.out", "w")
        err = open(tmp_path / f"rank{r}.err", "w")
        procs.append((subprocess.Popen([sys.executable, str(script)],
                                       env=env, stdout=out, stderr=err,
                                       cwd=tmp_path), out, err))
    try:
        for p, _, _ in procs:
            p.wait(timeout=timeout)
    finally:
        for p, out, err in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
            err.close()
    results = []
    for r, (p, _, _) in enumerate(procs):
        out = (tmp_path / f"rank{r}.out").read_text()
        assert p.returncode == 0, (
            f"rank {r} exited {p.returncode}\n{out}\n"
            + (tmp_path / f"rank{r}.err").read_text()[-6000:])
        results.append(json.loads(out.strip().splitlines()[-1]))
    return results


def shared_ranks(tmp_path_factory, key, code):
    """``run_ranks`` once for every test of this session that asks by
    ``key`` (the cases of one parametrised test read one spawn of the
    ranks): the first to ask runs ``code(folder)`` (which may write the
    ranks' inputs there and returns their code) and the ranks under a
    file lock, in a folder shared by the session's xdist workers, and the
    rest read its rows.  Returns (rows, folder).  A spawn that fails
    writes no rows, so each test that asks runs it again and fails
    alike."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent                 # the session's, not the worker's
    rows, folder = base / f"{key}.json", base / key
    with open(base / f"{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not rows.exists():
            folder.mkdir(exist_ok=True)
            rows.write_text(json.dumps(run_ranks(folder, *code(folder))))
    return json.loads(rows.read_text()), folder


# ---------------------------------------------------------------------------
# the mesh train step == the one-device step
# ---------------------------------------------------------------------------
MESH_RULES = ["DEFAULT_RULES", "FSDP_RULES"]


@pytest.mark.parametrize("rules", MESH_RULES)
def test_train_step_on_mesh_fsdp_and_tp(tmp_path_factory, rules):
    """(2, 2) mesh, ``microbatches=2``, ``seq_shard=True``, reduced
    Qwen1.5-0.5B in f32: two steps against the port's one-device step on
    the same params and batches (every param a DTensor, some sharded).
    One spawn of the ranks runs both rule sets (``shared_ranks``)."""
    rows, _ = shared_ranks(tmp_path_factory, "mesh_step", lambda _: (
        QWEN_F32, MESH_STEP_CODE))
    rows = [r[rules] for r in rows]
    for r in rows:
        assert r == rows[0]                  # every rank reads the same
    assert rows[0]["sharded"] > 5
    budget = 1e-5
    for i, row in enumerate(rows[0]["rows"]):
        budget += 2 * row["lr"]
        assert row["step"] == i + 1
        assert abs(row["loss"] - row["want"]) <= 1e-5 * abs(row["want"]), row
        assert row["perr"] <= budget, (row, budget)
        assert row["merr"] <= 1e-4, row


MESH_STEP_CODE = f"""
    from torch.distributed.tensor import DTensor
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.distributed import sharding as sh
    from repro_torch.models.modules import tree_leaves, tree_map
    from repro_torch.training import optimizer as topt, train as ttrain
    mesh = sh.make_mesh((2, 2), ("data", "model"), "cpu")
    specs = models.param_specs(cfg)
    dc = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8)
    tc = ttrain.TrainConfig(microbatches=2, seq_shard=True,
                            opt=topt.OptConfig(lr=1e-3, warmup_steps=1))
    base = models.make_params(cfg, torch.Generator().manual_seed(0), "cpu")
    fresh = lambda: tree_map(lambda a: a.clone(), base)
    one_p = fresh()
    one_s = topt.init_opt_state(one_p)
    one = ttrain.make_train_step(cfg, tc, device="cpu")
    batches = [batch_at(dc, i, device="cpu") for i in range(2)]
    ones = []
    for b in batches:
        one_p, one_s, om = one(one_p, one_s, b)
        ones.append((tree_map(lambda a: a.detach().clone(), one_p),
                     tree_map(lambda a: a.detach().clone(), one_s), om))
    step = ttrain.make_train_step(cfg, tc, mesh)
    got = {{}}
    for name in {MESH_RULES!r}:
        rules = getattr(sh, name)
        p = sh.distribute(fresh(), sh.param_shardings(specs, mesh, rules))
        s = sh.distribute(topt.init_opt_state(fresh()),
                          sh.opt_state_shardings(specs, mesh, rules))
        out = []
        for b, (one_p, one_s, om) in zip(batches, ones):
            p, s, m = step(p, s, b)
            assert all(isinstance(x, DTensor) for x in tree_leaves(p))
            perr = max(float((a.full_tensor() - w).abs().max())
                       for a, w in zip(tree_leaves(p), tree_leaves(one_p)))
            merr = max(float((a.full_tensor() - w).abs().max()
                             / max(float(w.abs().max()), 1e-30))
                       for k in ("m", "v") for a, w in
                       zip(tree_leaves(s[k]), tree_leaves(one_s[k])))
            out.append(dict(loss=float(m["loss"]), want=float(om["loss"]),
                            lr=float(om["lr"]), perr=perr, merr=merr,
                            step=int(s["step"].full_tensor())))
        sharded = sum(any(pl.is_shard() for pl in x.placements)
                      for x in tree_leaves(p))
        got[name] = dict(rows=out, sharded=sharded)
    fac = []
    tcf = dataclasses.replace(tc, opt=dataclasses.replace(tc.opt,
                                                          factored=True))
    one_f = ttrain.make_train_step(cfg, tcf, device="cpu")
    step_f = ttrain.make_train_step(cfg, tcf, mesh)
    fp = fresh()
    fs = topt.init_opt_state(fp, factored=True)
    p = sh.distribute(fresh(), sh.param_shardings(specs, mesh, sh.FSDP_RULES))
    s = sh.distribute(topt.init_opt_state(fresh(), factored=True),
                      sh.opt_state_shardings(specs, mesh, sh.FSDP_RULES,
                                             factored=True))
    for b in batches:
        fp, fs, om = one_f(fp, fs, b)
        p, s, m = step_f(p, s, b)
        perr = max(float((a.full_tensor() - w).abs().max())
                   for a, w in zip(tree_leaves(p), tree_leaves(fp)))
        merr = max(float((a.full_tensor() - w).abs().max()
                         / max(float(w.abs().max()), 1e-30))
                   for k in ("vr", "vc") for a, w in
                   zip(tree_leaves(s[k]), tree_leaves(fs[k])))
        # the bf16 first moment: its error in units of the larger of one
        # bf16 rounding step of the element and 1e-4 of the leaf's largest
        mq = max(float(((a.full_tensor().float() - w.float()).abs()
                        / torch.clamp(w.float().abs() * 2.0 ** -7,
                                      min=1e-4 * float(w.float().abs().max())
                                      + 1e-30)).max())
                 for a, w in zip(tree_leaves(s["m"]), tree_leaves(fs["m"])))
        fac.append(dict(loss=float(m["loss"]), want=float(om["loss"]),
                        lr=float(om["lr"]), perr=perr, merr=merr, mq=mq,
                        step=int(s["step"].full_tensor())))
    got["factored"] = fac
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import model as tmodel
    chunks = []
    vp = tmodel._vocab_parallel_loss_chunk
    tmodel._vocab_parallel_loss_chunk = lambda *a: chunks.append(1) or vp(*a)
    pv = sh.distribute(fresh(), sh.param_shardings(specs, mesh))
    bv = {{k: ttrain._shard_rows(v, mesh) for k, v in batches[0].items()}}
    p1 = fresh()
    for t in tree_leaves(p1) + tree_leaves(pv):
        t.requires_grad_(True)
    l1 = models.lm_loss(cfg, p1, batches[0])
    g1 = torch.autograd.grad(l1, tree_leaves(p1))
    with implicit_replication():
        lv = models.lm_loss(cfg, pv, bv,
                            act_constraint=ttrain.seq_constraint(mesh))
        gv = torch.autograd.grad(lv, tree_leaves(pv))
    tmodel._vocab_parallel_loss_chunk = vp
    got["vocab"] = dict(
        chunks=len(chunks),
        loss=abs(float(lv.full_tensor()) - float(l1)) / abs(float(l1)),
        grads=max(float((a.full_tensor() - w).abs().max()
                        / max(float(w.abs().max()), 1e-30))
                  for a, w in zip(gv, g1)))
    serve = sh.distribute(fresh(), sh.param_shardings(specs, mesh))
    one_st = models.init_decode_state(cfg, 4, 32, device="cpu")
    st = sh.distribute(models.init_decode_state(cfg, 4, 32, device="cpu"),
                       sh.kv_cache_sharding(mesh, one_st))
    toks = torch.randint(0, cfg.vocab, (6, 4),
                         generator=torch.Generator().manual_seed(1))
    lerr = cerr = 0.0
    with torch.no_grad(), implicit_replication():
        for t in range(6):
            one_st, want = models.decode_step(cfg, base, one_st, toks[t], t)
            st, lg = models.decode_step(cfg, serve, st, toks[t], t)
            lerr = max(lerr, float((lg.full_tensor() - want).abs().max()
                                   / want.abs().max()))
    for k in ("k", "v"):
        a, w = st["pos0"][k], one_st["pos0"][k]
        cerr = max(cerr, float((a.full_tensor() - w).abs().max()
                               / w.abs().max()))
    got["decode"] = dict(lerr=lerr, cerr=cerr, placements=[
        str(p) for p in st["pos0"]["k"].placements])
    from repro_torch.models import rwkv
    rwkv.YS_DTYPE = torch.float32   # the steps' bf16 rounding flips apart
    loops = {{}}
    for arch in ("rwkv6-3b", "jamba-v0.1-52b"):
        c = dataclasses.replace(configs.reduced(configs.get_config(arch)),
                                dtype="float32")
        p1 = models.make_params(c, torch.Generator().manual_seed(2), "cpu")
        pm = sh.distribute(tree_map(lambda a: a.clone(), p1),
                           sh.param_shardings(models.param_specs(c), mesh))
        b = batch_at(DataConfig(vocab=c.vocab, seq_len=64, global_batch=4),
                     0, device="cpu")
        bm = {{k: ttrain._shard_rows(v, mesh) for k, v in b.items()}}
        for t in tree_leaves(p1) + tree_leaves(pm):
            t.requires_grad_(True)
        l1 = models.lm_loss(c, p1, b)
        g1 = torch.autograd.grad(l1, tree_leaves(p1))

        def on_mesh():
            with implicit_replication():
                lm = models.lm_loss(
                    c, pm, bm, act_constraint=ttrain.batch_constraint(mesh))
                return lm, torch.autograd.grad(lm, tree_leaves(pm))
        lm, gm = on_mesh()
        # the loops through DTensor's dispatch op by op, as before on_shards
        from repro_torch.models import mamba
        for mod in (rwkv, mamba):
            mod.DTensor = type("NoDTensor", (), {{}})
        try:
            ld, gd = on_mesh()
        finally:
            rwkv.DTensor = mamba.DTensor = DTensor

        def err(gs, ws):
            return max(float((a.full_tensor() - w).abs().max()
                             / max(float(w.abs().max()), 1e-30))
                       for a, w in zip(gs, ws))
        loops[arch] = dict(
            loss=abs(float(lm.full_tensor()) - float(l1)) / abs(float(l1)),
            grads=err(gm, g1),
            dispatch=err(gm, [a.full_tensor() for a in gd]),
            dispatch_loss=float(lm.full_tensor()) == float(ld.full_tensor()))
    got["loops"] = loops
    print(json.dumps(got))
    """


def test_factored_update_on_mesh_matches_one_device(tmp_path_factory):
    """The factored AdamW update (Adafactor-style second moment, bf16
    first moment) on the (2, 2) mesh under ``FSDP_RULES``, its row and
    column means taken across the ranks and its elementwise tail on each
    rank's shard: two steps of reduced Qwen1.5-0.5B in f32 against the
    one-device factored step, the loss to rtol 1e-5, the params to ``2 lr
    + 1e-5`` per step, the factored moments to 1e-4 of each leaf's largest
    and the bf16 first moment to one bf16 rounding step of each element
    (``2^-7`` of it) per step taken, or 1e-4 of the leaf's largest (its
    f32 value, summed in another order, may round the other way).  Read
    from the mesh step's spawn of the ranks."""
    rows, _ = shared_ranks(tmp_path_factory, "mesh_step", lambda _: (
        QWEN_F32, MESH_STEP_CODE))
    rows = [r["factored"] for r in rows]
    for r in rows:
        assert r == rows[0]
    budget = 1e-5
    for i, row in enumerate(rows[0]):
        budget += 2 * row["lr"]
        assert row["step"] == i + 1
        assert abs(row["loss"] - row["want"]) <= 1e-5 * abs(row["want"]), row
        assert row["perr"] <= budget, (row, budget)
        assert row["merr"] <= 1e-4 and row["mq"] <= i + 1, row


def test_vocab_parallel_loss_matches_one_device(tmp_path_factory):
    """``lm_loss`` of reduced Qwen1.5-0.5B in f32 on the (2, 2) mesh under
    ``DEFAULT_RULES`` (the tied head's vocab over "model", the residual
    stream over "data" and "model") runs each loss chunk vocab-parallel
    and equals one device's: the loss to rtol 1e-5, each grad within 1e-5
    of its largest.  Read from the mesh step's spawn of the ranks."""
    rows, _ = shared_ranks(tmp_path_factory, "mesh_step", lambda _: (
        QWEN_F32, MESH_STEP_CODE))
    rows = [r["vocab"] for r in rows]
    for r in rows:
        assert r == rows[0]
    assert rows[0]["chunks"] >= 1
    assert rows[0]["loss"] <= 1e-5 and rows[0]["grads"] <= 1e-5, rows[0]


def test_decode_step_on_mesh_keeps_the_cache_sharded(tmp_path_factory):
    """Six decode steps of reduced Qwen1.5-0.5B in f32 on the (2, 2) mesh
    (params under ``DEFAULT_RULES``, the state as ``kv_cache_sharding``
    lays it out: batch over "data", Dh over "model") against the
    one-device steps: the logits and the caches within 1e-5 of their
    largest (the scores' partial sums over each rank's Dh add in another
    order), and the caches still laid out as they came.  Read from the
    mesh step's spawn of the ranks."""
    rows, _ = shared_ranks(tmp_path_factory, "mesh_step", lambda _: (
        QWEN_F32, MESH_STEP_CODE))
    rows = [r["decode"] for r in rows]
    for r in rows:
        assert r == rows[0]
    assert rows[0]["placements"] == ["S(1)", "S(4)"]
    assert rows[0]["lerr"] <= 1e-5 and rows[0]["cerr"] <= 1e-5, rows[0]


def test_step_loops_on_local_shards_match_one_device(tmp_path_factory):
    """RWKV's and Mamba's step loops run on each rank's shards on the mesh
    (``modules.on_shards``): reduced rwkv6-3b and jamba-v0.1-52b in f32 on
    the (2, 2) mesh.  ``lm_loss`` equal, and its grads within 1e-5 of
    each grad's largest, to the same mesh step with the loops run through
    DTensor's dispatch op by op (the partial grads of the replicated
    inputs add in another order); against one device, the loss within
    1e-5 and the grads within 1e-3 of each largest (rwkv reads 2.3e-4
    either way: the mesh's sum order; its steps' outputs kept in f32 here,
    since a bf16 rounding that flips moves a grad by 2^-8 of itself).
    Read from the mesh step's spawn of the ranks."""
    rows, _ = shared_ranks(tmp_path_factory, "mesh_step", lambda _: (
        QWEN_F32, MESH_STEP_CODE))
    rows = [r["loops"] for r in rows]
    for r in rows:
        assert r == rows[0]
    for arch, r in rows[0].items():
        assert r["dispatch_loss"] and r["dispatch"] <= 1e-5, (arch, r)
        assert r["loss"] <= 1e-5 and r["grads"] <= 1e-3, (arch, r)


# ---------------------------------------------------------------------------
# the int8 compressed step == the JAX package's
# ---------------------------------------------------------------------------
def test_compressed_train_step_matches_jax(tmp_path):
    """DP 4, lr 1e-3 from the first step: the port's ``compressed_psum`` of
    each rank's grads within one quantum of the shared scale of JAX's, and
    one ``make_compressed_train_step`` step (``compress_grads="int8"``)
    against JAX's: the loss and the grad norm to rtol 1e-5, the params
    within ``2 lr + 1e-5``, and the moments to the grad they were made
    from: ``m / (1 - b1)`` and ``sqrt(v / (1 - b2))`` (the synced grad,
    clipped) within one quantum of the leaf's shared scale, times the
    clip factor, of JAX's.  Adam's first step moves each param by about
    ``lr`` whatever its grad, so the moments are what show the sync."""
    npz = tmp_path / "jax.npz"
    run_sub(f"""
        import dataclasses
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import PartitionSpec as P
        from repro import configs
        from repro.data.pipeline import DataConfig, batch_at
        from repro.distributed import sharding as sh
        from repro.models import lm_loss, make_params
        from repro.training import optimizer as opt_mod
        from repro.training.train import (TrainConfig, compressed_psum,
                                          make_compressed_train_step)
        mesh = sh.make_mesh((4, 1), ("data", "model"))
        cfg = dataclasses.replace(
            configs.reduced(configs.get_config("qwen1.5-0.5b")),
            dtype="float32")
        batch = batch_at(DataConfig(vocab=cfg.vocab, seq_len=32,
                                    global_batch=8), 0)
        params = make_params(cfg, jax.random.PRNGKey(0))

        def grads(params, batch):
            g = jax.grad(lambda p, b: lm_loss(cfg, p, b))(params, batch)
            scale = jax.tree.map(lambda x: jax.lax.pmax(
                jnp.maximum(jnp.max(jnp.abs(x)), 1e-12) / 127.0, "data"), g)
            return compressed_psum(g, ("data",)), scale

        with mesh:
            cg, scale = jax.jit(sh.shard_map(
                grads, mesh, in_specs=(P(), P("data")), out_specs=(P(), P()),
                manual_axes=("data",)))(params, batch)
            step = jax.jit(make_compressed_train_step(
                cfg, TrainConfig(compress_grads="int8", opt=opt_mod.OptConfig(
                    lr=1e-3, warmup_steps=1)), mesh))
            p1, s1, m = step(params, opt_mod.init_opt_state(params), batch)
        out = {{k: np.asarray(m[k]) for k in ("loss", "lr", "grad_norm")}}
        for name, tree in (("p0", params), ("g", cg), ("s", scale),
                           ("p1", p1), ("m", s1["m"]), ("v", s1["v"])):
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                key = "/".join(k.key for k in path)
                out[name + "/" + key] = np.asarray(leaf)
        out.update({{"b/" + k: np.asarray(v) for k, v in batch.items()}})
        np.savez({str(npz)!r}, **out)
    """, devices=4)
    rows = run_ranks(tmp_path, QWEN_F32, f"""
    import numpy as np
    from repro_torch.distributed import sharding as sh
    from repro_torch.models.modules import tree_leaves, tree_map
    from repro_torch.training import optimizer as topt, train as ttrain
    z = np.load({str(npz)!r})

    def nest(prefix):
        out = {{}}
        for key in z.files:
            if key.startswith(prefix + "/"):
                d = out
                parts = key[len(prefix) + 1:].split("/")
                for part in parts[:-1]:
                    d = d.setdefault(part, {{}})
                d[parts[-1]] = torch.from_numpy(np.asarray(z[key]))
        return out

    mesh = sh.make_mesh((4, 1), ("data", "model"), "cpu")
    batch = nest("b")
    params = models.from_numpy(cfg, nest("p0"), "cpu")
    want_g, scale = nest("g"), nest("s")
    rows = {{k: v[RANK * 2:(RANK + 1) * 2] for k, v in batch.items()}}
    for x in tree_leaves(params):
        x.requires_grad_(True)
    _, g = ttrain._value_and_grad(
        lambda p, b: models.lm_loss(cfg, p, b), params, rows)
    cg = ttrain.compressed_psum(tree_map(lambda x: x.to(torch.float32), g),
                                ttrain.dp_group(mesh))
    quanta = max(float(((a - w).abs() / s).max()) for a, w, s in zip(
        tree_leaves(cg), tree_leaves(want_g), tree_leaves(scale)))
    tc1 = ttrain.TrainConfig(compress_grads="int8", opt=topt.OptConfig(
        lr=1e-3, warmup_steps=1))
    step = ttrain.make_compressed_train_step(cfg, tc1, mesh)
    p1, st, m = step(params, topt.init_opt_state(params), batch)
    perr = max(float((a - w).abs().max())
               for a, w in zip(tree_leaves(p1), tree_leaves(nest("p1"))))
    # the grad each moment was made from, in quanta of the leaf's shared
    # scale times the clip factor (Adam's first step: m = (1 - b1) g,
    # v = (1 - b2) g^2)
    b1, b2 = tc1.opt.b1, tc1.opt.b2
    clip = min(1.0, tc1.opt.grad_clip / float(z["grad_norm"]))
    mq = max(float(((a - w).abs() / (1 - b1) / (clip * s)).max())
             for a, w, s in zip(tree_leaves(st["m"]), tree_leaves(nest("m")),
                                tree_leaves(scale)))
    vq = max(float((((a / (1 - b2)).sqrt() - (w / (1 - b2)).sqrt()).abs()
                    / (clip * s)).max())
             for a, w, s in zip(tree_leaves(st["v"]), tree_leaves(nest("v")),
                                tree_leaves(scale)))
    print(json.dumps(dict(quanta=quanta, perr=perr, mq=mq, vq=vq,
                          loss=float(m["loss"]), want=float(z["loss"]),
                          gnorm=float(m["grad_norm"]),
                          want_gnorm=float(z["grad_norm"]),
                          lr=float(z["lr"]), step=int(st["step"]))))
    """)
    for r in rows:
        assert r["quanta"] <= 1.0 + 1e-6, r
        assert abs(r["loss"] - r["want"]) <= 1e-5 * abs(r["want"]), r
        assert abs(r["gnorm"] - r["want_gnorm"]) <= 1e-5 * r["want_gnorm"], r
        assert r["step"] == 1 and abs(r["lr"] - 1e-3) <= 1e-9, r
        assert r["mq"] <= 1.0 + 1e-4, r
        assert r["vq"] <= 1.0 + 1e-4, r
        assert r["perr"] <= 2 * r["lr"] + 1e-5, r
        assert r == rows[0]                # the update is replicated


# ---------------------------------------------------------------------------
# elastic restore onto another mesh, and the mesh's own save
# ---------------------------------------------------------------------------
ELASTIC_SHAPES = [(4, 1), (2, 2)]


@pytest.mark.parametrize("shape", ELASTIC_SHAPES)
def test_elastic_checkpoint_restore_across_meshes(tmp_path_factory, shape):
    """A checkpoint the JAX package wrote and one the port wrote on one
    device restore onto a ``shape`` mesh with ``FSDP_RULES``, bitwise;
    saved again from the mesh, the files equal the one-device save byte
    for byte.  One spawn of the ranks restores onto both meshes
    (``shared_ranks``)."""
    rows, src = shared_ranks(tmp_path_factory, "elastic", elastic_code)
    key = "%dx%d" % shape
    rows = [r[key] for r in rows]
    assert all(r["jax"] and r["one"] for r in rows), rows
    assert rows[0]["sharded"] > 5
    one, mesh = src / "one" / "step_1", src / f"mesh{key}" / "step_1"
    names = sorted(f.name for f in one.iterdir())
    assert names == sorted(f.name for f in mesh.iterdir())
    for n in names:
        assert (one / n).read_bytes() == (mesh / n).read_bytes(), n


def elastic_code(src):
    """The checkpoints (the JAX package's and the port's one-device save
    of reduced Qwen1.5-0.5B) written to ``src``, and the ranks' code that
    restores them onto each mesh of ELASTIC_SHAPES and saves again."""
    import jax
    from repro import configs as jcfg
    from repro import models as jm
    from repro.checkpoint import ckpt as jck
    from repro_torch import configs, models
    from repro_torch.checkpoint import ckpt
    cfg = configs.reduced(configs.get_config("qwen1.5-0.5b"))
    jparams = jm.make_params(jcfg.reduced(jcfg.get_config("qwen1.5-0.5b")),
                             jax.random.PRNGKey(0))
    jck.save(src / "jax", 1, jparams)
    params = models.make_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ckpt.save(src / "one", 1, params)
    return (f"""
    from repro_torch import configs, models
    from repro_torch.checkpoint import ckpt
    from repro_torch.distributed import sharding as sh
    from repro_torch.models.modules import tree_leaves
    cfg = configs.reduced(configs.get_config("qwen1.5-0.5b"))
    specs = models.param_specs(cfg)
    example = models.make_abstract_params(cfg)
    src = {str(src)!r}
    res = {{}}
    for shape in {ELASTIC_SHAPES!r}:
        mesh = sh.make_mesh(shape, ("data", "model"), "cpu")
        p_sh = sh.param_shardings(specs, mesh, sh.FSDP_RULES)
        out = {{}}
        for name in ("jax", "one"):
            got = ckpt.restore(src + "/" + name, 1, example, shardings=p_sh)
            want = ckpt.restore(src + "/" + name, 1, example, device="cpu")
            out[name] = all(
                torch.equal(a.full_tensor().view(torch.uint8),
                            w.view(torch.uint8))
                and tuple(a.placements) == sh_.placements
                for a, w, sh_ in zip(tree_leaves(got), tree_leaves(want),
                                     tree_leaves(p_sh)))
            if name == "one":
                ckpt.save(src + "/mesh%dx%d" % shape, 1, got)
        out["sharded"] = sum(any(p.is_shard() for p in s.placements)
                             for s in tree_leaves(p_sh))
        res["%dx%d" % shape] = out
    print(json.dumps(res))
    """,)


# ---------------------------------------------------------------------------
# the launcher under torchrun
# ---------------------------------------------------------------------------
LAUNCH_ARGS = ["--arch", "qwen1.5-0.5b", "--reduced", "--steps", "3",
               "--global-batch", "4", "--seq-len", "32", "--log-every", "1",
               "--lr", "1e-3"]
F32_REDUCED = """
import dataclasses, sys
from repro_torch import configs
_reduced = configs.reduced
configs.reduced = lambda c: dataclasses.replace(_reduced(c), dtype="float32")
from repro_torch.launch import train
print("final", train.main(sys.argv[1:]))
"""


def losses(out):
    return [float(x) for x in re.findall(r"loss=([0-9.]+)", out)]


def test_launcher_under_torchrun_matches_one_device(tmp_path):
    """``torchrun --nproc-per-node 4 ... --data 2 --model 2 --device cpu``
    (reduced Qwen1.5-0.5B in f32) logs the one-device launcher's losses
    as printed (4 decimals; one unit in the last place allowed where a
    value straddles a rounding boundary), and every rank returns its
    final loss to rtol 1e-5; only rank 0 logs."""
    script = tmp_path / "launch_f32.py"
    script.write_text(F32_REDUCED)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    # the one-device launcher and torchrun side by side
    procs = [subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=tmp_path)
             for cmd in ([sys.executable, str(script)] + LAUNCH_ARGS
                         + ["--device", "cpu"],
                         [sys.executable, "-m", "torch.distributed.run",
                          "--standalone", "--nproc-per-node", "4",
                          str(script)] + LAUNCH_ARGS
                         + ["--data", "2", "--model", "2", "--device",
                            "cpu"])]
    try:
        (one, one_err), (mesh, mesh_err) = (p.communicate(timeout=300)
                                            for p in procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert procs[0].returncode == 0, one_err[-4000:]
    assert procs[1].returncode == 0, mesh[-2000:] + mesh_err[-4000:]
    want, got = losses(one), losses(mesh)
    assert len(want) == 3 and len(got) == 3, (one, mesh)
    assert np.abs(np.subtract(got, want)).max() <= 1e-4 + 1e-9, (got, want)
    finals = [float(x) for x in re.findall(r"final ([0-9.]+)", mesh)]
    want_final = float(re.findall(r"final ([0-9.]+)", one)[0])
    assert finals
    np.testing.assert_allclose(finals, want_final, rtol=1e-5)


def test_launcher_mesh_needs_its_devices(monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"needs 2 CUDA devices.*1 visible"):
        train.main(LAUNCH_ARGS + ["--data", "2", "--model", "1"])
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        train.main(LAUNCH_ARGS + ["--data", "2", "--model", "2",
                                  "--device", "cpu"])


def test_host_mesh_defaults_to_cuda(monkeypatch):
    from repro_torch.launch.mesh import make_host_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        make_host_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        make_host_mesh(device_type="cpu")


# ---------------------------------------------------------------------------
# the simulator's lane mesh
# ---------------------------------------------------------------------------
def lane_case():
    mc = tiny_machine()
    tr = random_trace(mc, seed=0, steps=48)
    pcs = [tc.PolicyConfig(autonuma=False),
           tc.PolicyConfig(data_policy=1, autonuma=False)]
    return mc, tr, pcs


def test_sharded_lanes_match_unsharded_multi_device():
    """A lane mesh of two CPU devices: each runs one engine over its lane,
    in lockstep, bitwise equal to the unsharded sweep."""
    mc, tr, pcs = lane_case()
    mesh = lane_mesh(2, ["cpu", "cpu", "cpu"])
    assert mesh.size == 2 and mesh.axis_names == ("lanes",)
    assert lane_mesh(3, ["cpu", "cpu"]).size == 1
    ccs = [tc.CostConfig()] * 2
    plain = tc.sweep_lanes(mc, ccs, pcs, [tr, tr], device="cpu")
    shard = tc.sweep_lanes(mc, ccs, pcs, [tr, tr], lane_sharding=mesh)
    per_step = tc.sweep_lanes(mc, ccs, pcs, [tr, tr], lane_sharding=mesh,
                              engine="per_step", debug=True)
    for a, b, c in zip(plain, shard, per_step):
        assert_bitwise(b, a, "lane mesh")
        assert_bitwise(c, a, "lane mesh, per-step")
    with pytest.raises(ValueError, match="not divisible"):
        tc.sweep_lanes(mc, ccs[:1] * 3, pcs + pcs[:1], [tr] * 3,
                       lane_sharding=mesh)


def test_lane_mesh_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        lane_mesh(4)


@pytest.mark.parametrize("sharding", ["auto", "two"])
def test_broker_results_bit_identical_to_sequential(sharding):
    """The reference's mixed burst through a broker with
    ``lane_sharding="auto"`` (on the CPU, the lane mesh of one device)
    and with a lane mesh of two CPU devices: each result == its
    sequential run on the canonical trace, bitwise."""
    mc = tiny_machine()
    sh = "auto" if sharding == "auto" else LaneMesh(
        (torch.device("cpu"),) * 2)
    b = broker(max_lanes=8, lane_sharding=sh)
    spec = tc.TraceSpec(workload="xsbench", footprint=64, run_steps=16)
    traces = [random_trace(mc, seed=4, free_at=30, name="f"),
              random_trace(mc, seed=5, name="g"), spec]
    queries = [SimQuery(trace=t, policy=pc, machine=mc,
                        cost=tc.CostConfig(nvmm_read=750 + 250 * i))
               for i, t in enumerate(traces) for pc in MIXED_POLICIES[:2]]
    for q, res in zip(queries, b.run(queries)):
        assert_bitwise(res, solo(q, b.canonical_trace(q)), q.policy.label())


@pytest.mark.parametrize("sharding", ["auto", "two"])
def test_burst_compiles_once_per_bucket_and_caches(sharding):
    """64 queries in one bucket through a lane-sharded broker: one compile
    of the reference's accounting, none for new traces in the bucket,
    the first burst again all from the cache."""
    mc = tiny_machine()
    sh = "auto" if sharding == "auto" else LaneMesh(
        (torch.device("cpu"),) * 2)
    policies = [tc.PolicyConfig(data_policy=d, pt_policy=p, autonuma=False)
                for d in (tc.FIRST_TOUCH, tc.INTERLEAVE)
                for p in (tc.PT_FOLLOW_DATA, tc.PT_BIND_HIGH)]
    traces = [random_trace(mc, seed=100 + i, name=f"t{i}", steps=24)
              for i in range(16)]
    queries = [SimQuery(trace=t, policy=pc, machine=mc)
               for t in traces for pc in policies]
    b = broker(max_lanes=64, lane_sharding=sh)
    before = tc.sweep_compile_count()
    futs = b.submit_many(queries)
    assert all(f.done() for f in futs)
    assert tc.sweep_compile_count() == before + 1
    assert b.stats.flushes == 1 and b.stats.lanes_run == 64
    b.run([SimQuery(trace=random_trace(mc, seed=200 + i, name=f"u{i}",
                                       steps=24), policy=pc, machine=mc)
           for i in range(16) for pc in policies])
    assert tc.sweep_compile_count() == before + 1
    futs3 = b.submit_many(queries)
    assert all(f.done() and f.from_cache for f in futs3)
    assert tc.sweep_compile_count() == before + 1
    for f0, f3 in zip(futs, futs3):
        assert f3.result() is f0.result()
