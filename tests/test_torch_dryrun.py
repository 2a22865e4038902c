"""``repro_torch.launch.dryrun`` and ``analysis.parse_collectives`` against
the JAX package's: the collective parser on records equivalent to
tests/test_launch.py's HLO, each cell's counts and skip reasons, and the
dry run of reduced archs on a ``"fake"`` (2, 4) mesh with every
argument's local bytes as the reference's ``spec_for`` shards them."""
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


def reference_argument_bytes(jc, shape, mesh, fsdp: bool) -> int:
    """What the reference's shardings give one device of the cell's
    arguments (params, optimizer state, batch or decode state)."""
    rules = jsh.FSDP_RULES if fsdp else jsh.DEFAULT_RULES
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


@pytest.mark.parametrize("arch", REDUCED)
def test_dry_run_of_reduced_cells_on_a_fake_mesh(arch, tmp_path):
    """Train, prefill and decode of a reduced arch as rank 0 of a fake
    (2, 4) mesh: each ``ok`` (or skipped for the reference's reason),
    with the reference's counts, the argument bytes its ``spec_for``
    gives one device, FLOPs above the analytic count's per-rank share
    and collectives on both axes."""
    cfg = configs.reduced(configs.get_config(arch))
    jc = jcfg.reduced(jcfg.get_config(arch))
    mesh = AbstractMesh((2, 4), ("data", "model"))
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig(f"{kind}_s", 64, 8, kind)
        jshape = jcfg.base.ShapeConfig(f"{kind}_s", 64, 8, kind)
        rec = dryrun.run_cell(arch, shape.name, "fake2x4", force=True,
                              cfg=cfg, shape=shape, mesh_shape=(2, 4),
                              out_dir=tmp_path)
        assert rec["n_params"] == jc.n_params()
        assert rec["n_active"] == jc.n_active_params()
        assert rec["model_flops"] == jan.model_flops(jc, jshape)
        ok, reason = jcfg.base.cell_is_valid(jc, jshape)
        if not ok:
            assert rec["status"] == "skipped" and rec["reason"] == reason
            continue
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["n_chips"] == 8
        assert rec["memory"]["argument_bytes"] == reference_argument_bytes(
            jc, jshape, mesh, rec["rules_fsdp"]), kind
        assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
        assert rec["cost"]["flops"] >= rec["model_flops"] / 8 * 0.5, kind
        assert rec["collectives"], kind


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
