"""Multi-pod dry run: one rank's step of every (arch x shape) cell on the
production meshes, with no device and no data, recording memory, FLOPs
and collective statistics (twin of the JAX package's ``launch/dryrun.py``,
the same CLI and tables).

The reference lowers and compiles each cell's SPMD program for 256 / 512
host devices.  Here each cell runs as rank 0 of a ``"fake"`` process
group of the mesh's size (its collectives complete at once and move
nothing), on ``meta`` tensors: every parameter, optimizer moment, batch
leaf and decode-state leaf is a DTensor whose local shard has its shape
and dtype but no storage.  What the rank runs is recorded:

  memory.argument_bytes   the local shards of the step's arguments;
  memory.peak_bytes       the most bytes of local storage alive at once
                          over the step, the arguments included, each
                          untyped storage once: ``MemTracker``'s peak of
                          the local device (tests/test_torch_dryrun.py
                          holds the two equal), at a quarter of its time
                          a op, which a 32k-token prefill's millions of
                          ops need;
  cost.flops              the rank's FLOPs (``torch.utils.flop_counter``'s
                          formulas over its local operations);
  collectives             :func:`..launch.analysis.parse_collectives` of
                          the functional collectives DTensor issued.

:class:`StepRecorder` is the ``TorchDispatchMode`` that counts all three.

Usage:

    PYTHONPATH=src python -m repro_torch.launch.dryrun                 # all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-14b \\
        --shape train_4k --mesh single                                 # one

Records land in artifacts/dryrun_torch/<mesh>/<arch>__<shape>.json and are
skipped if present (delete to re-run, or ``--force``).  Importing this
module changes no process state: the fake group lives only while a cell
runs.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.configs.base import SHAPES, cell_is_valid, torch_dtype
from repro_torch.distributed import sharding as shard_mod
from repro_torch.launch.analysis import (XLA_OP, model_flops,
                                         parse_collectives)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as model_mod
from repro_torch.models.modules import tree_leaves, tree_map
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.train import (TrainConfig, batch_constraint,
                                        make_train_step)

ART_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

# Per-cell resource strategy: (microbatches, seq_shard, factored_opt).
TRAIN_OVERRIDES = {
    "nemotron-4-340b": dict(microbatches=16, seq_shard=True, factored=True,
                            accum_dtype="bfloat16"),
    "deepseek-coder-33b": dict(microbatches=8, seq_shard=True,
                               factored=True),
    "qwen2.5-14b": dict(microbatches=8, seq_shard=True),
    "qwen1.5-0.5b": dict(microbatches=1),
    "llama4-maverick-400b-a17b": dict(microbatches=16, seq_shard=True,
                                      factored=True,
                                      accum_dtype="bfloat16"),
    "llama4-scout-17b-16e": dict(microbatches=16, seq_shard=True,
                                 factored=True),
    "qwen2-vl-2b": dict(microbatches=4),
    "hubert-xlarge": dict(microbatches=4),
    "jamba-v0.1-52b": dict(microbatches=16, seq_shard=True, factored=True),
    "rwkv6-3b": dict(microbatches=4),
}

# Per-cell strategy variants, run side by side with the baseline into
# artifacts/dryrun_torch/<mesh>-<variant>/.
PERF_VARIANTS = {
    "moe_ep": {
        ("llama4-maverick-400b-a17b", "train_4k"): dict(rules="moe_ep"),
        ("llama4-scout-17b-16e", "train_4k"): dict(rules="moe_ep"),
        ("jamba-v0.1-52b", "train_4k"): dict(rules="moe_ep"),
    },
    "moe_ep_mb4": {
        ("llama4-maverick-400b-a17b", "train_4k"): dict(rules="moe_ep",
                                                        microbatches=4),
        ("jamba-v0.1-52b", "train_4k"): dict(rules="moe_ep",
                                             microbatches=4),
    },
    "moe_ep_tp": {
        ("llama4-maverick-400b-a17b", "train_4k"): dict(rules="moe_ep_tp"),
        ("jamba-v0.1-52b", "train_4k"): dict(rules="moe_ep_tp"),
    },
    "kv_f8": {
        ("deepseek-coder-33b", "decode_32k"): dict(kv_dtype="float8_e4m3fn"),
        ("qwen2.5-14b", "decode_32k"): dict(kv_dtype="float8_e4m3fn"),
    },
}

MESH_SIZES = {"single": 256, "multipod": 512}


def _tensors(out):
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _tensors(o)]
    return [out] if isinstance(out, torch.Tensor) else []


class StepRecorder(TorchDispatchMode):
    """What one rank's step does, counted on its local tensors while the
    mode is active: every functional collective as ``(op, result_bytes,
    group_size)`` in :attr:`records` (what ``parse_collectives`` reads),
    the FLOPs of the local operations (``torch.utils.flop_counter``'s
    formulas) in :attr:`flops`, and the bytes of local storage alive
    (:attr:`live`, each untyped storage once, freed when its last tensor
    goes) and their most (:attr:`peak`).  DTensor ops are let through to
    DTensor, so what is counted is each rank's own work and traffic."""

    def __init__(self, tensors=()):
        super().__init__()
        self.records = []
        self.flops = 0
        self.live = self.peak = 0
        self._refs = {}
        for t in tensors:
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs:
            return
        n = st.nbytes()

        def freed(_, key=key, n=n):
            self._refs.pop(key, None)
            self.live -= n
        self._refs[key] = weakref.ref(st, freed)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if func.namespace == "_c10d_functional" \
                and packet.__name__ in XLA_OP:
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            group = _resolve_process_group(
                kwargs.get("group_name", args[-1])).size()
            self.records.append((packet.__name__, sum(
                t.numel() * t.element_size() for t in _tensors(out)), group))
        elif packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        for t in _tensors(out):
            self._track(t)
        return out


@contextlib.contextmanager
def fake_world(size: int):
    """A ``"fake"`` process group of ``size`` ranks, this process rank 0,
    destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world needs a process with no process "
                           "group initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)) \
            and not isinstance(tree, shard_mod.NamedSharding):
        return type(tree)(_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def _leaves(tree) -> list:
    out = []
    _map(out.append, tree)
    return out


def abstract(t: torch.Tensor, sh: shard_mod.NamedSharding) -> DTensor:
    """A DTensor of ``t``'s shape and dtype laid out as ``sh``, whose local
    shard is a ``meta`` tensor."""
    local = list(t.shape)
    for i, p in enumerate(sh.placements):
        if p.is_shard():
            local[p.dim] //= sh.mesh.size(i)
    shape = tuple(t.shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(
        torch.empty(local, dtype=t.dtype, device="meta"), sh.mesh,
        list(sh.placements), shape=torch.Size(shape), stride=stride)


_dp_axes = shard_mod.dp_axes


def auto_out_shardings(mesh, out_shapes, batch_div):
    """Output shardings by leaf rank: rank-5 [G,B,S,KH,Dh] KV collections
    shard batch over DP and head_dim over model; rank-2 [B,V] logits shard
    batch; everything else replicates."""
    dp = _dp_axes(mesh)
    dp_size = shard_mod.mesh_axis_size(mesh, dp)
    tp = shard_mod.mesh_axis_size(mesh, "model") \
        if "model" in mesh.mesh_dim_names else 1

    def one(s):
        if not hasattr(s, "shape"):
            return shard_mod.named(mesh, ())
        if len(s.shape) == 5 and s.shape[1] % dp_size == 0:
            last = "model" if s.shape[-1] % tp == 0 else None
            return shard_mod.named(mesh, (None, dp, None, None, last))
        if len(s.shape) >= 1 and s.shape and s.shape[0] % dp_size == 0 \
                and len(s.shape) <= 2 and s.shape[0] == batch_div:
            return shard_mod.named(mesh, (dp,))
        return shard_mod.named(mesh, ())
    return _map(one, out_shapes)


def _laid_out(out, shardings):
    """Each DTensor of ``out`` redistributed to its sharding (the
    reference's jit ``out_shardings``)."""
    return _map(lambda t, sh: t.redistribute(sh.mesh, list(sh.placements))
                if isinstance(t, DTensor) else t, out, shardings)


def build_cell(cfg, shape, mesh, variant=None):
    """Returns (fn, example_args, meta): ``fn(*example_args)`` runs one
    rank's step of the cell on abstract DTensors."""
    specs = model_mod.param_specs(cfg)
    pbytes = sum(math.prod(s.shape) * torch_dtype(s.dtype).itemsize
                 for s in tree_leaves(specs))
    rules = shard_mod.choose_rules(
        pbytes, mesh, mode="train" if shape.kind == "train" else "serve")
    overrides = PERF_VARIANTS.get(variant, {}).get((cfg.name, shape.name), {})
    if "rules" in overrides:
        rules = shard_mod.RULE_SETS[overrides["rules"]]
    p_sh = shard_mod.param_shardings(specs, mesh, rules)
    abs_params = tree_map(abstract, model_mod.make_abstract_params(cfg), p_sh)

    batch_specs = model_mod.input_specs(cfg, shape.seq_len,
                                        shape.global_batch, shape.kind)
    b_sh = shard_mod.batch_specs(batch_specs, mesh)
    abs_batch = tree_map(abstract, batch_specs, b_sh)
    fsdp = dict(rules_fsdp=rules is shard_mod.FSDP_RULES)

    if shape.kind == "train":
        ov = dict(TRAIN_OVERRIDES.get(cfg.name, {}))
        ov.update({k: v for k, v in overrides.items() if k != "rules"})
        factored = ov.pop("factored", False)
        tc = TrainConfig(opt=opt_mod.OptConfig(factored=factored), **ov)
        step = make_train_step(cfg, tc, mesh)
        o_sh = shard_mod.opt_state_shardings(specs, mesh, rules, factored)
        abs_opt = tree_map(abstract, opt_mod.abstract_opt_state(
            model_mod.make_abstract_params(cfg), factored), o_sh)
        return step, (abs_params, abs_opt, abs_batch), dict(
            strategy=ov, factored=factored, **fsdp)

    if shape.kind == "prefill":
        act = batch_constraint(mesh)

        @torch.no_grad()
        def fn(params, batch):
            with implicit_replication():
                out = model_mod.prefill(cfg, params, batch,
                                        act_constraint=act)
                return _laid_out(out, auto_out_shardings(
                    mesh, out, shape.global_batch))
        return fn, (abs_params, abs_batch), fsdp

    # decode
    state = model_mod.init_decode_state(
        cfg, shape.global_batch, shape.seq_len, abstract=True,
        kv_dtype=overrides.get("kv_dtype"))
    abs_state = tree_map(abstract, state,
                         shard_mod.kv_cache_sharding(mesh, state))
    dp = _dp_axes(mesh)
    logits_sh = shard_mod.named(
        mesh, (dp,) if shape.global_batch
        % shard_mod.mesh_axis_size(mesh, dp) == 0 else ())

    @torch.no_grad()
    def fn(params, state, tokens):
        with implicit_replication():
            state, logits = model_mod.decode_step(cfg, params, state, tokens,
                                                  shape.seq_len - 1)
            return state, _laid_out(logits, logits_sh)
    return fn, (abs_params, abs_state, abs_batch["tokens"]), fsdp


def _local_bytes(tree) -> int:
    return sum(t.to_local().untyped_storage().nbytes()
               if isinstance(t, DTensor) else t.untyped_storage().nbytes()
               for t in _leaves(tree) if isinstance(t, torch.Tensor))


def run_cell(arch_id: str, shape_id: str, mesh_name: str,
             force: bool = False, variant=None, cfg=None, shape=None,
             mesh_shape=None, out_dir=None) -> dict:
    """Dry-run one cell and write its record.  ``cfg`` / ``shape`` /
    ``mesh_shape`` (``(data, model)`` or ``(pod, data, model)``) /
    ``out_dir`` override the registry's config, the named shape, the
    production mesh and the artifact directory (for small runs)."""
    dir_name = mesh_name if not variant else f"{mesh_name}-{variant}"
    out_dir = Path(out_dir) if out_dir is not None else ART_DIR / dir_name
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{arch_id}__{shape_id}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cfg = cfg or configs.get_config(arch_id)
    shape = shape or SHAPES[shape_id]
    rec = {"arch": arch_id, "shape": shape_id, "mesh": mesh_name,
           "n_params": cfg.n_params(), "n_active": cfg.n_active_params(),
           "model_flops": model_flops(cfg, shape)}
    ok, reason = cell_is_valid(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=reason)
        out_path.write_text(json.dumps(rec, indent=1))
        return rec

    if mesh_shape is None:
        n_ranks = MESH_SIZES[mesh_name]
    else:
        n_ranks = math.prod(mesh_shape)
    rec["n_chips"] = n_ranks
    rec["variant"] = variant
    try:
        with fake_world(n_ranks):
            if mesh_shape is None:
                mesh = make_production_mesh(
                    multi_pod=(mesh_name == "multipod"), device_type="cpu")
            else:
                names = ("data", "model") if len(mesh_shape) == 2 \
                    else ("pod", "data", "model")
                mesh = shard_mod.make_mesh(mesh_shape, names, "cpu")
            t0 = time.time()
            fn, args, meta = build_cell(cfg, shape, mesh, variant)
            rec.update(meta)
            rec["build_s"] = round(time.time() - t0, 1)
            locals_ = [t.to_local() for t in _leaves(args)
                       if isinstance(t, DTensor)]
            recorder = StepRecorder(locals_)
            t0 = time.time()
            with recorder:
                fn(*args)
            rec["run_s"] = round(time.time() - t0, 1)
            rec["memory"] = {"argument_bytes": _local_bytes(args),
                             "peak_bytes": recorder.peak}
            rec["cost"] = {"flops": float(recorder.flops)}
            rec["collectives"] = parse_collectives(recorder.records)
            rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record the failure verbatim
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-3000:]
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multipod", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default=None,
                    help="PERF_VARIANTS key: run only its cells")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(configs.ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    if args.variant:
        cells = list(PERF_VARIANTS[args.variant])
        archs = sorted({a for a, _ in cells if args.arch in (None, a)})
        shapes = sorted({s for _, s in cells})
    meshes = {"single": ["single"], "multipod": ["multipod"],
              "both": ["single", "multipod"]}[args.mesh]

    for mesh_name in meshes:
        for arch_id in archs:
            for shape_id in shapes:
                t0 = time.time()
                rec = run_cell(arch_id, shape_id, mesh_name,
                               force=args.force, variant=args.variant)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    peak = rec["memory"]["peak_bytes"] / (1 << 30)
                    extra = (f"peak={peak:.1f}GiB "
                             f"flops/rank={rec['cost']['flops']:.3g} "
                             f"run={rec.get('run_s', 0)}s")
                elif status == "skipped":
                    extra = rec["reason"]
                else:
                    extra = rec["error"][:160]
                print(f"[{mesh_name}] {arch_id} x {shape_id}: {status} "
                      f"{extra} ({time.time() - t0:.0f}s)", flush=True)


if __name__ == "__main__":
    main()
