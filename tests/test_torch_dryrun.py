"""``repro_torch.launch.dryrun`` and ``analysis.parse_collectives`` against
the JAX package's: the collective parser on records equivalent to
tests/test_launch.py's HLO, each cell's counts and skip reasons, and the
dry run of reduced archs on a ``"fake"`` (2, 4) mesh with every
argument's local bytes as the reference's ``spec_for`` shards them."""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro import configs as jcfg
from repro import models as jm
from repro.distributed import sharding as jsh
from repro.launch import analysis as jan
from repro.training import optimizer as jopt
from repro_torch import configs
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.analysis import model_flops, parse_collectives

from test_launch import HLO
from test_torch_engine import fresh_jax_caches  # noqa: F401 (autouse)

jax.devices()          # lock the device count before the reference's dryrun
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdry                         # noqa: E402
if _flags is None:                  # importing it sets XLA_FLAGS: undo that
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

SRC = Path(__file__).resolve().parents[1] / "src"
# tests/test_launch.py's HLO as the recorder writes it: (op, result bytes,
# group size); the permute's group is what the reference assumes without
# replica groups, and the tuple-shaped reduce-scatter is one coalesced op
RECORDS = [("all_gather_into_tensor", 16 * 128 * 2, 4),
           ("all_reduce", 64 * 4, 2),
           ("collective-permute", 8 * 8 * 2, 2),
           ("reduce_scatter_tensor_coalesced", 2 * 32 * 4, 4)]


def test_parse_collectives():
    out = parse_collectives(RECORDS)
    assert out == jan.parse_collectives(HLO)
    assert out["all-gather"]["count"] == 1
    assert out["all-gather"]["bytes"] == 16 * 128 * 2
    assert abs(out["all-gather"]["traffic"] - 16 * 128 * 2 * 0.75) < 1e-6
    assert out["all-reduce"]["traffic"] == 2 * 64 * 4 * 0.5
    assert out["collective-permute"]["traffic"] == 8 * 8 * 2
    assert out["reduce-scatter"]["bytes"] == 2 * 32 * 4
    assert parse_collectives([("broadcast", 64, 4)]) == {}


def test_tables_are_the_references():
    assert dryrun.TRAIN_OVERRIDES == jdry.TRAIN_OVERRIDES
    assert dryrun.PERF_VARIANTS == jdry.PERF_VARIANTS


@pytest.mark.parametrize("shape_id", list(SHAPES))
def test_cell_counts_and_skips_equal_the_references(shape_id, tmp_path):
    """Every cell of the matrix: ``n_params``, ``n_active``,
    ``model_flops`` and the skip reason as the reference computes them;
    the skipped cells' records written as the reference writes them."""
    for arch in configs.ARCH_IDS:
        cfg, jc = configs.get_config(arch), jcfg.get_config(arch)
        shape, jshape = SHAPES[shape_id], jcfg.SHAPES[shape_id]
        assert cfg.n_params() == jc.n_params()
        assert cfg.n_active_params() == jc.n_active_params()
        assert model_flops(cfg, shape) == jan.model_flops(jc, jshape)
        ok, reason = configs.base.cell_is_valid(cfg, shape)
        assert (ok, reason) == jcfg.base.cell_is_valid(jc, jshape)
        if not ok:
            rec = dryrun.run_cell(arch, shape_id, "single", out_dir=tmp_path)
            assert rec == {"arch": arch, "shape": shape_id, "mesh": "single",
                           "n_params": jc.n_params(),
                           "n_active": jc.n_active_params(),
                           "model_flops": jan.model_flops(jc, jshape),
                           "status": "skipped", "reason": reason}


def shard_bytes(tree, shardings) -> int:
    """Bytes of one device's shards of a tree of ShapeDtypeStructs laid out
    by the reference's NamedShardings."""
    leaves = jax.tree.leaves(tree)
    shs = jax.tree.leaves(shardings,
                          is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(leaves) == len(shs)
    return sum(math.prod(sh.shard_shape(x.shape)) * np.dtype(x.dtype).itemsize
               for x, sh in zip(leaves, shs))


def reference_argument_bytes(jc, shape, mesh, rules) -> int:
    """What the reference's shardings give one device of the cell's
    arguments (params, optimizer state, batch or decode state) under the
    rule set ``rules``."""
    specs = jm.param_specs(jc)
    params = jm.make_abstract_params(jc)
    total = shard_bytes(params, jsh.param_shardings(specs, mesh, rules))
    batch = jm.model.input_specs(jc, shape.seq_len, shape.global_batch,
                                 shape.kind)
    if shape.kind == "train":
        opt = jopt.abstract_opt_state(params, False)
        total += shard_bytes(opt, jsh.opt_state_shardings(specs, mesh, rules))
    if shape.kind == "decode":
        state = jm.init_decode_state(jc, shape.global_batch, shape.seq_len,
                                     abstract=True)
        total += shard_bytes(state, jsh.kv_cache_sharding(mesh, state))
        batch = {"tokens": batch["tokens"]}
    return total + shard_bytes(batch, jsh.batch_specs(batch, mesh))


# one arch of each family: dense (and the 0.5B of the card), MoE, vision
# (M-RoPE), encoder-only (no decode), RWKV, Mamba (hybrid)
REDUCED = ["qwen1.5-0.5b", "llama4-scout-17b-16e", "qwen2-vl-2b",
           "hubert-xlarge", "rwkv6-3b", "jamba-v0.1-52b"]


@pytest.mark.parametrize("arch, mesh_shape, variant, overrides", [
    pytest.param(a, (2, 4), None, None, id=a) for a in REDUCED] + [
    # the multi-pod mesh's ("pod", "data") DP axes, its train cell in 4
    # microbatches of 2 rows, fewer than the 4 DP ranks, as the full
    # cells' 16 rows on 32 (attention's reshape failed on a batch sharded
    # unevenly)
    pytest.param("qwen1.5-0.5b", (2, 2, 2), None, dict(microbatches=4),
                 id="multipod"),
    # experts over "data", the dense weights over "model" only
    pytest.param("llama4-maverick-400b-a17b", (2, 4), "moe_ep_tp", None,
                 id="moe_ep_tp")])
def test_dry_run_of_reduced_cells_on_a_fake_mesh(arch, mesh_shape, variant,
                                                 overrides, tmp_path,
                                                 monkeypatch):
    """Train, prefill and decode of a reduced arch as rank 0 of a fake
    (2, 4) or (2, 2, 2) mesh (with the variant's rules for its train
    cell): each ``ok`` (or skipped for the reference's reason), with the
    reference's counts, the argument bytes its ``spec_for`` gives one
    device, FLOPs above the analytic count's per-rank share and
    collectives on both axes."""
    cfg = configs.reduced(configs.get_config(arch))
    jc = jcfg.reduced(jcfg.get_config(arch))
    names = ("data", "model") if len(mesh_shape) == 2 \
        else ("pod", "data", "model")
    mesh = AbstractMesh(mesh_shape, names)
    if variant:
        monkeypatch.setitem(dryrun.PERF_VARIANTS[variant],
                            (cfg.name, "train_s"), dict(rules=variant))
    if overrides:
        monkeypatch.setitem(dryrun.TRAIN_OVERRIDES, cfg.name, overrides)
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig(f"{kind}_s", 64, 8, kind)
        jshape = jcfg.base.ShapeConfig(f"{kind}_s", 64, 8, kind)
        rec = dryrun.run_cell(arch, shape.name, "fake", force=True,
                              cfg=cfg, shape=shape, mesh_shape=mesh_shape,
                              out_dir=tmp_path, variant=variant)
        assert rec["n_params"] == jc.n_params()
        assert rec["n_active"] == jc.n_active_params()
        assert rec["model_flops"] == jan.model_flops(jc, jshape)
        ok, reason = jcfg.base.cell_is_valid(jc, jshape)
        if not ok:
            assert rec["status"] == "skipped" and rec["reason"] == reason
            continue
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["n_chips"] == 8
        rules = jsh.FSDP_RULES if rec["rules_fsdp"] else jsh.DEFAULT_RULES
        if variant and kind == "train":
            rules = jsh.RULE_SETS[variant]
        assert rec["memory"]["argument_bytes"] == reference_argument_bytes(
            jc, jshape, mesh, rules), kind
        assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
        assert rec["cost"]["flops"] >= rec["model_flops"] / 8 * 0.5, kind
        assert rec["collectives"], kind


def test_moe_prefill_with_fsdp_experts_on_a_fake_mesh(monkeypatch, tmp_path):
    """Llama-4 Maverick's ``prefill_32k`` layout at a reduced size: its
    full cell shards d_model over "data" (``FSDP_RULES``) and its experts
    over "model", and its expert weights outweigh the activations, so
    DTensor gathers the batch for the up-projections.  Reduced Maverick
    with 8 experts (2 a rank), a moe d_ff of 4096 and S = 8192 (two MoE
    sequence chunks) ends ``ok``; the down-projection's ``einsum`` used
    to fail on the local shard's layout ("view size is not compatible")."""
    monkeypatch.setattr(dryrun.shard_mod, "choose_rules",
                        lambda *a, **k: dryrun.shard_mod.FSDP_RULES)
    cfg = configs.reduced(configs.get_config("llama4-maverick-400b-a17b"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=8, d_ff=4096))
    shape = ShapeConfig("prefill_s", 8192, 4, "prefill")
    rec = dryrun.run_cell(cfg.name, shape.name, "fake2x4", force=True,
                          cfg=cfg, shape=shape, mesh_shape=(2, 4),
                          out_dir=tmp_path)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["rules_fsdp"]


def test_moe_train_with_experts_over_data_on_a_fake_mesh(tmp_path):
    """Llama-4 Maverick's ``moe_ep_mb4`` train cell (its experts over
    "data", 4 microbatches of 64 rows) at its full widths, cut to 2
    layers (one MoE layer; the reduced widths do not reproduce it), on a
    fake (2, 4) mesh: it ends ``ok``.  The grad of the up-projections'
    product came back from the down-projection's backward pass
    batch-major under expert-major global strides, and the
    up-projections' backward failed to merge it ("view size is not
    compatible")."""
    cfg = dataclasses.replace(
        configs.get_config("llama4-maverick-400b-a17b"), n_layers=2)
    rec = dryrun.run_cell(cfg.name, "train_4k", "fake", force=True,
                          cfg=cfg, shape=SHAPES["train_4k"],
                          mesh_shape=(2, 4), out_dir=tmp_path,
                          variant="moe_ep_mb4")
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["strategy"]["microbatches"] == 4


def test_decode_of_one_row_on_a_fake_mesh(tmp_path):
    """Reduced Jamba's decode of one row (``long_500k``'s batch, which
    the DP axis does not divide) on a fake (2, 4) mesh ends ``ok``: the
    residual stream can reach its dense MLP as a pending sum, and the
    MLP's result is then laid out replicated, not as a sum."""
    cfg = configs.reduced(configs.get_config("jamba-v0.1-52b"))
    shape = ShapeConfig("long_s", 512, 1, "decode")
    rec = dryrun.run_cell(cfg.name, shape.name, "fake", force=True,
                          cfg=cfg, shape=shape, mesh_shape=(2, 4),
                          out_dir=tmp_path)
    assert rec["status"] == "ok", rec.get("traceback")


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "jamba-v0.1-52b"])
def test_decode_keeps_the_cache_sharded_on_a_fake_mesh(arch):
    """A decode step at S = 4096 on a fake (2, 4) mesh, with 4 KV heads so
    that "model" shards the heads as 16 do on Qwen1.5-0.5B's (16, 16):
    no all-gather reaches one layer's cache at its global size, and the
    peak stays within 4 times the arguments.  It read 5.1 and 11.7 times
    while the recorder counted the tensors of the global shapes that
    DTensor's sharding propagation makes on a miss of its cache (for
    the first ``select`` of the stacked cache: the whole cache)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import sharding as shard_mod
    cfg = configs.reduced(configs.get_config(arch))
    cfg = dataclasses.replace(cfg, n_heads=4, n_kv_heads=4)
    shape = ShapeConfig("decode_s", 4096, 8, "decode")
    with dryrun.fake_world(8):
        mesh = shard_mod.make_mesh((2, 4), ("data", "model"), "cpu")
        fn, args, _ = dryrun.build_cell(cfg, shape, mesh)
        rec = dryrun.StepRecorder([t.to_local() for t in dryrun._leaves(args)
                                   if isinstance(t, DTensor)])
        with rec:
            fn(*args)
        arg_bytes = dryrun._local_bytes(args)
    cache = shape.global_batch * shape.seq_len * cfg.n_kv_heads \
        * cfg.head_dim * torch.empty((), dtype=configs.base.torch_dtype(
            cfg.dtype)).element_size()
    gathers = [b for op, b, _ in rec.records if op.startswith("all_gather")]
    assert gathers and max(gathers) < cache
    assert rec.peak <= 4 * arg_bytes, rec.peak / arg_bytes


@pytest.mark.parametrize("arch", ["nemotron-4-340b", "jamba-v0.1-52b",
                                  "rwkv6-3b"])
def test_counted_microbatches_give_the_op_by_op_record(arch, monkeypatch,
                                                       tmp_path):
    """A train step of 4 microbatches under the arch's ``train_4k``
    strategy (nemotron: ``seq_shard``, the factored optimizer, bf16
    accumulation; jamba: ``seq_shard``, factored; rwkv: neither) that
    runs one and counts three records what running all four does: the
    same argument and peak bytes, FLOPs and collectives (counts, bytes
    and traffic, the same floats)."""
    cfg = configs.reduced(configs.get_config(arch))
    monkeypatch.setitem(dryrun.TRAIN_OVERRIDES, cfg.name, dict(
        dryrun.TRAIN_OVERRIDES[arch], microbatches=4))
    shape = ShapeConfig("train_s", 32, 16, "train")
    recs = [dryrun.run_cell(arch, shape.name, "fake2x4", force=True,
                            cfg=cfg, shape=shape, mesh_shape=(2, 4),
                            out_dir=tmp_path / str(op_by_op),
                            op_by_op=op_by_op)
            for op_by_op in (False, True)]
    assert [r["status"] for r in recs] == ["ok", "ok"], \
        [r.get("traceback") for r in recs]
    assert [r["microbatches_run"] for r in recs] == [1, 4]
    for key in ("memory", "cost", "collectives"):
        assert recs[0][key] == recs[1][key], key


def test_recorder_memo_records_what_the_meta_kernels_do():
    """The recorder's memo of fresh ops' meta layouts changes nothing it
    counts: a train, a prefill and a decode step of reduced rwkv6-3b (its
    step loop is most of the memo's work) on the fake (2, 4) mesh record
    the same collectives, FLOPs and peak with it as without it."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import sharding as shard_mod
    cfg = configs.reduced(configs.get_config("rwkv6-3b"))
    with dryrun.fake_world(8):
        mesh = shard_mod.make_mesh((2, 4), ("data", "model"), "cpu")
        for kind in ("train", "prefill", "decode"):
            got = []
            for memo in (False, True):
                fn, args, _ = dryrun.build_cell(
                    cfg, ShapeConfig("s", 64, 8, kind), mesh)
                rec = dryrun.StepRecorder(
                    [t.to_local() for t in dryrun._leaves(args)
                     if isinstance(t, DTensor)], memo=memo)
                with rec:
                    fn(*args)
                got.append((rec.records, rec.flops, rec.peak))
            assert got[0] == got[1], kind
            assert len(rec._memo) > 0


def test_peak_counts_storages_as_memtracker():
    """The recorder's peak == ``MemTracker``'s peak of the local (meta)
    device on a prefill, a train and a decode step of a warmed process
    (libm's tables are made on first use and kept)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import sharding as shard_mod
    cfg = configs.reduced(configs.get_config("qwen1.5-0.5b"))
    with dryrun.fake_world(8):
        mesh = shard_mod.make_mesh((2, 4), ("data", "model"), "cpu")
        for kind in ("prefill", "train", "decode"):
            peaks = []
            for which in ("warm-up", "recorder", "memtracker"):
                fn, args, _ = dryrun.build_cell(
                    cfg, ShapeConfig("s", 64, 8, kind), mesh)
                local = [t.to_local() for t in dryrun._leaves(args)
                         if isinstance(t, DTensor)]
                if which == "warm-up":       # the tables cached on first use
                    fn(*args)
                elif which == "recorder":
                    rec = dryrun.StepRecorder(local)
                    with rec:
                        fn(*args)
                    peaks.append(rec.peak)
                else:
                    mt = MemTracker()
                    mt.track_external(*local)
                    with mt:
                        fn(*args)
                    peaks.append(mt.get_tracker_snapshot("peak")[
                        torch.device("meta")]["Total"])
                del fn, args, local
            assert peaks[0] == peaks[1], (kind, peaks)


def test_import_leaves_no_process_state():
    code = ("import os\n"
            "before = dict(os.environ)\n"
            "import repro_torch.launch.dryrun\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\n"
            "assert dict(os.environ) == before\n"
            "import sys\n"
            "assert not any(m.split('.')[0] in ('jax', 'repro') "
            "for m in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=SRC,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


class _Inside(dryrun.StepRecorder):
    """A StepRecorder that also keeps the largest storage made while a
    wrapped function runs (:meth:`wrap`)."""

    def __init__(self, *a, **k):
        self.depth = self.largest = 0
        super().__init__(*a, **k)

    def _track(self, t):
        new = t.untyped_storage()._cdata not in self._refs
        super()._track(t)
        if new and self.depth:
            self.largest = max(self.largest, t.untyped_storage().nbytes())

    def wrap(self, fn):
        def inside(*a, **k):
            self.depth += 1
            try:
                return fn(*a, **k)
            finally:
                self.depth -= 1
        return inside


FAKE_2X4 = AbstractMesh((2, 4), ("data", "model"))


def _f32_shard(shape, spec) -> int:
    return math.prod(NamedSharding(FAKE_2X4, jax.sharding.PartitionSpec(
        *spec)).shard_shape(shape)) * 4


def _largest_param_f32_shard(cfg, shape) -> int:
    """The largest f32 shard of a param of reduced nemotron-4-340b, laid
    out as the reference's ``FSDP_RULES`` lay it out."""
    specs = jm.param_specs(jcfg.reduced(jcfg.get_config("nemotron-4-340b")))
    return max(_f32_shard(s.shape, jsh.spec_for(s, FAKE_2X4, jsh.FSDP_RULES))
               for s in jax.tree.leaves(
                   specs, is_leaf=lambda x: hasattr(x, "logical_axes")))


# F11's three causes: (arch, step, rules, where, the reference's shard)
F11 = {
    # the factored AdamW update under FSDP_RULES (nemotron's train_4k)
    "factored_update": ("nemotron-4-340b", "train", "FSDP_RULES",
                        ("training.optimizer", "_factored_update"),
                        _largest_param_f32_shard),
    # the loss chunk's f32 logits [B / dp, C, V / tp] (one microbatch)
    "loss_chunk": ("qwen1.5-0.5b", "train", "DEFAULT_RULES",
                   ("models.model", "_loss_chunk"),
                   lambda cfg, shape: _f32_shard(
                       (shape.global_batch, min(512, shape.seq_len),
                        cfg.vocab), ("data", None, "model"))),
    # the MLP's f32 hidden layer [B / dp, S, F / tp] in prefill
    "mlp": ("nemotron-4-340b", "prefill", "DEFAULT_RULES",
            ("models.layers", "mlp_apply"),
            lambda cfg, shape: _f32_shard(
                (shape.global_batch, shape.seq_len, cfg.d_ff),
                ("data", None, "model"))),
}


@pytest.mark.parametrize("where", list(F11))
def test_step_keeps_a_ranks_share_inside(where, monkeypatch):
    """F11: the largest storage a rank's step makes inside the factored
    update, the loss chunk and the MLP, on the fake (2, 4) mesh at
    reduced widths, is at most twice the local shard the reference's
    layout gives (its f32 temporaries hold one).  Before, DTensor gathered
    the params for the update's factored outer product, the loss chunk's
    vocab (and its gather's grad, the batch), and the MLP's hidden dim."""
    import importlib
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import sharding as shard_mod
    arch, kind, rules, (mod, name), shard = F11[where]
    cfg = configs.reduced(configs.get_config(arch))
    shape = ShapeConfig(f"{kind}_s", 64, 32, kind)
    monkeypatch.setattr(dryrun.shard_mod, "choose_rules",
                        lambda *a, **k: getattr(shard_mod, rules))
    monkeypatch.setitem(dryrun.TRAIN_OVERRIDES, cfg.name,
                        dryrun.TRAIN_OVERRIDES[arch])
    module = importlib.import_module(f"repro_torch.{mod}")
    with dryrun.fake_world(8):
        mesh = shard_mod.make_mesh((2, 4), ("data", "model"), "cpu")
        fn, args, _ = dryrun.build_cell(cfg, shape, mesh)
        rec = _Inside([t.to_local() for t in dryrun._leaves(args)
                       if isinstance(t, DTensor)])
        monkeypatch.setattr(module, name, rec.wrap(getattr(module, name)))
        with rec:
            fn(*args)
    want = shard(cfg, shape)
    assert 0 < rec.largest <= 2 * want, (rec.largest, want)


# (arch, rules, its dry-run strategy, the param held to): a separate
# embedding table with its vocab over "model", and under FSDP_RULES the
# largest param (a stacked FFN weight, which the factored update runs on)
WHOLE_PARAM_CASES = [("deepseek-coder-33b", "DEFAULT_RULES", False, "embed"),
                     ("nemotron-4-340b", "FSDP_RULES", True, None)]


@pytest.mark.parametrize("arch,rules,overrides,param", WHOLE_PARAM_CASES,
                         ids=[c[0] for c in WHOLE_PARAM_CASES])
def test_train_step_moves_no_whole_parameter(arch, rules, overrides, param,
                                             monkeypatch):
    """A train step of a reduced arch as rank 0 of a fake (2, 4) mesh
    issues no collective as large as a parameter at its global shape
    (reduced DeepSeek-Coder's embedding table; the largest of reduced
    nemotron-4-340b's under ``FSDP_RULES`` with its dry-run strategy, a
    stacked FFN weight).
    Each rank looks up the tokens of its vocab slice and the table's grad
    stays on the slice, and the factored update runs on each rank's shard.
    Before, DTensor's ``index`` gathered the whole table, the grad of the
    whole table was summed over all ranks, and the update gathered whole
    params for its factored outer product."""
    from torch.distributed.tensor import DTensor
    from repro_torch.configs.base import torch_dtype
    from repro_torch.distributed import sharding as shard_mod
    from repro_torch.models import model as model_mod
    from repro_torch.models.modules import tree_leaves
    cfg = configs.reduced(configs.get_config(arch))
    shape = ShapeConfig("train_s", 32, 32 if overrides else 4, "train")
    monkeypatch.setattr(dryrun.shard_mod, "choose_rules",
                        lambda *a, **k: getattr(shard_mod, rules))
    if overrides:
        monkeypatch.setitem(dryrun.TRAIN_OVERRIDES, cfg.name,
                            dryrun.TRAIN_OVERRIDES[arch])
    with dryrun.fake_world(8):
        mesh = shard_mod.make_mesh((2, 4), ("data", "model"), "cpu")
        fn, args, _ = dryrun.build_cell(cfg, shape, mesh)
        rec = dryrun.StepRecorder([t.to_local() for t in dryrun._leaves(args)
                                   if isinstance(t, DTensor)])
        with rec:
            fn(*args)
    specs = model_mod.param_specs(cfg)
    whole_bytes = max(math.prod(s.shape) * torch_dtype(s.dtype).itemsize
                      for s in tree_leaves(specs[param] if param else specs))
    assert rec.records
    assert max(b for _, b, _ in rec.records) < whole_bytes, sorted(
        r for r in rec.records if r[1] >= whole_bytes)


def test_train_step_moves_only_all_reduces_under_tensor_parallelism(
        monkeypatch):
    """F12: a train step of one layer of Qwen1.5-0.5B at its published
    widths under ``DEFAULT_RULES`` on a fake (2, 4) mesh (heads, hidden
    dim and vocab over "model", the batch over "data": Megatron's layout)
    moves only all-reduces: the partial sums of the row-parallel products,
    the vocab-parallel loss and lookup, and the grads' DP sums.  Before,
    the attention's output projection left its pending sum in the
    residual stream, the next norm scattered the rows over "model", and
    the backward pass gathered whole weights (the output projection's) to
    meet them, then all-reduced their whole grads over "data"."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import sharding as shard_mod
    cfg = dataclasses.replace(configs.get_config("qwen1.5-0.5b"), n_layers=1)
    shape = ShapeConfig("train_s", 1024, 4, "train")
    monkeypatch.setattr(dryrun.shard_mod, "choose_rules",
                        lambda *a, **k: shard_mod.DEFAULT_RULES)
    with dryrun.fake_world(8):
        mesh = shard_mod.make_mesh((2, 4), ("data", "model"), "cpu")
        fn, args, _ = dryrun.build_cell(cfg, shape, mesh)
        rec = dryrun.StepRecorder([t.to_local() for t in dryrun._leaves(args)
                                   if isinstance(t, DTensor)])
        with rec:
            fn(*args)
    assert rec.records
    assert {op for op, _, _ in rec.records} == {"all_reduce"}, sorted(
        r for r in rec.records if r[0] != "all_reduce")


def test_row_parallel_reduces_the_weight_grad_at_its_shard():
    """F12: attention's output projection where the heads are whole on
    each rank (kv heads that "model" does not divide, deepseek's and
    qwen2-vl's): x replicated over "model" times w sharded on its rows
    over "model".  ``modules.row_parallel`` cuts x to w's row shards
    first, so w's grad is computed at its shard and summed over "data" at
    its shard; ``x @ w`` made it whole on every rank and all-reduced it
    whole (98 MiB a layer at deepseek's `train_4k`)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.distributed import sharding as shard_mod
    from repro_torch.models.modules import row_parallel, settled
    meta = dict(dtype=torch.bfloat16, device="meta")
    with dryrun.fake_world(8):
        mesh = shard_mod.make_mesh((2, 4), ("data", "model"), "cpu")
        x = DTensor.from_local(torch.empty(4, 20, 96, **meta), mesh,
                               [Shard(0), Replicate()]).requires_grad_()
        w = DTensor.from_local(torch.empty(24, 56, **meta), mesh,
                               [Replicate(), Shard(0)]).requires_grad_()
        rec = dryrun.StepRecorder()
        with rec:
            y = settled(row_parallel(x, w))
            _, gw = torch.autograd.grad(y.sum(), (x, w))
            gw = gw.redistribute(mesh, w.placements)
    whole, shard = 96 * 56 * 2, 24 * 56 * 2
    over_data = [b for op, b, g in rec.records if g == 2]
    assert over_data == [shard], rec.records
    assert all(b != whole for _, b, _ in rec.records), rec.records
    assert tuple(gw.to_local().shape) == (24, 56)


def test_prefill_collects_the_caches_as_cache_shards():
    """F11's fourth cause: where "model" does not divide the kv heads
    (reduced nemotron-4-340b's 2 on the fake (2, 4) mesh, as its 8 on
    (16, 16)), attention runs with the heads whole on each rank, and each
    layer's k and v were kept so until the caches were stacked (36 GiB a
    rank over nemotron's 96 layers at ``prefill_32k``).  They are laid out
    as the decode cache's shards as they are collected (the
    ``kv_constraint`` that the dry run's prefill passes): each stacked
    cache a rank holds is [G, B / dp, S, KH, Dh / tp], the reference's
    ``kv_cache_sharding`` shard."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed import sharding as shard_mod
    from repro_torch.models import model as model_mod
    from repro_torch.training.train import batch_constraint
    cfg = configs.reduced(configs.get_config("nemotron-4-340b"))
    assert cfg.n_kv_heads % 4
    shape = ShapeConfig("prefill_s", 64, 8, "prefill")
    with dryrun.fake_world(8):
        mesh = shard_mod.make_mesh((2, 4), ("data", "model"), "cpu")
        _, (params, batch), _ = dryrun.build_cell(cfg, shape, mesh)
        with torch.no_grad(), implicit_replication():
            _, _, kvs = model_mod.forward(
                cfg, params, batch, collect_kv=True,
                act_constraint=batch_constraint(mesh),
                kv_constraint=shard_mod.kv_constraint(mesh))
    groups = cfg.n_layers // model_mod.period_of(cfg)
    for kv in kvs:
        for t in kv:
            assert tuple(t.to_local().shape) == (
                groups, shape.global_batch // 2, shape.seq_len,
                cfg.n_kv_heads, cfg.head_dim // 4)
