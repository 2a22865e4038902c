"""``repro_torch.distributed.sharding`` against the JAX package's
``distributed/sharding.py``, entry for entry: every PartitionSpec of the
ten archs at full size, on four mesh shapes.

The reference runs on ``jax.sharding.AbstractMesh`` (no devices, no
compile); the port on a real ``DeviceMesh`` over a ``"fake"`` process
group of the mesh's size (``launch.dryrun.fake_world``), made and torn
down inside each test.  ``choose_rules`` is compared at the reference's
``hbm_bytes=16 << 30``; the port's default is the H100's memory.
"""
import math
import os

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jcfg
from repro import models as jm
from repro.distributed import sharding as jsh
from repro_torch import configs, models
from repro_torch.configs.base import SHAPES, torch_dtype
from repro_torch.distributed import sharding as tsh
from repro_torch.launch.dryrun import auto_out_shardings, fake_world
from repro_torch.models.modules import tree_leaves
from torch.distributed.tensor import Replicate, Shard

from test_torch_engine import fresh_jax_caches  # noqa: F401 (autouse)

jax.devices()          # lock the device count before the reference's dryrun
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdry                         # noqa: E402
if _flags is None:                  # importing it sets XLA_FLAGS: undo that
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4x2": ((4, 2), ("data", "model"))}


def flat(tree, prefix=""):
    """{path: leaf} of nested dicts, lists and tuples (a NamedSharding of
    either package is a leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields") \
            and not isinstance(tree, jax.sharding.PartitionSpec):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def same_specs(port_tree, ref_tree, what):
    """Every port NamedSharding's spec == the reference's PartitionSpec,
    and its placements say the same."""
    p, r = flat(port_tree), flat(ref_tree)
    assert list(p) == list(r), what
    for k in p:
        want = tuple(r[k].spec)
        assert p[k].spec == want, (what, k, p[k].spec, want)
        mesh = p[k].mesh
        for name, pl in zip(mesh.mesh_dim_names, p[k].placements):
            dims = [d for d, e in enumerate(want)
                    if e == name or (isinstance(e, tuple) and name in e)]
            sharded = dims and tsh.mesh_axis_size(mesh, name) > 1
            assert pl == (Shard(dims[0]) if sharded else Replicate()), \
                (what, k)
    return len(p)


@pytest.fixture
def meshes(request):
    shape, names = MESHES[request.param]
    with fake_world(math.prod(shape)):
        yield tsh.make_mesh(shape, names, "cpu"), AbstractMesh(shape, names)


def archs():
    return [(configs.get_config(a), jcfg.get_config(a))
            for a in configs.ARCH_IDS]


@pytest.mark.parametrize("meshes", list(MESHES), indirect=True)
def test_spec_for_and_param_shardings(meshes):
    tmesh, jmesh = meshes
    assert tsh.axis_sizes(tmesh) == dict(jmesh.shape)
    n = 0
    for tcfg, jc in archs():
        for name in tsh.RULE_SETS:
            assert tsh.RULE_SETS[name] == jsh.RULE_SETS[name]
            n += same_specs(
                tsh.param_shardings(models.param_specs(tcfg), tmesh,
                                    tsh.RULE_SETS[name]),
                jsh.param_shardings(jm.param_specs(jc), jmesh,
                                    jsh.RULE_SETS[name]), (tcfg.name, name))
    assert n > 1000
    for axis in (None, "data", "model", ("data", "model")):
        assert tsh.mesh_axis_size(tmesh, axis) \
            == jsh.mesh_axis_size(jmesh, axis)


@pytest.mark.parametrize("meshes", list(MESHES), indirect=True)
def test_opt_state_shardings_plain_and_factored(meshes):
    tmesh, jmesh = meshes
    for tcfg, jc in archs():
        for rules in ("default", "fsdp"):
            for factored in (False, True):
                same_specs(
                    tsh.opt_state_shardings(models.param_specs(tcfg), tmesh,
                                            tsh.RULE_SETS[rules], factored),
                    jsh.opt_state_shardings(jm.param_specs(jc), jmesh,
                                            jsh.RULE_SETS[rules], factored),
                    (tcfg.name, rules, factored))


@pytest.mark.parametrize("meshes", list(MESHES), indirect=True)
def test_choose_rules(meshes):
    tmesh, jmesh = meshes
    chosen = set()
    for tcfg, jc in archs():
        pbytes = sum(math.prod(s.shape) * torch_dtype(s.dtype).itemsize
                     for s in tree_leaves(models.param_specs(tcfg)))
        for mode in ("train", "serve"):
            for scale in (1, 8, 64):
                want = jsh.choose_rules(pbytes // scale, jmesh, mode)
                got = tsh.choose_rules(pbytes // scale, tmesh, mode,
                                       hbm_bytes=16 << 30)
                assert (got is tsh.FSDP_RULES) == (want is jsh.FSDP_RULES)
                chosen.add(got is tsh.FSDP_RULES)
            # the port's default is the H100's memory, not a TPU's
            assert tsh.choose_rules(pbytes, tmesh, mode) is tsh.choose_rules(
                pbytes, tmesh, mode, hbm_bytes=tsh.H100_HBM_BYTES)
    assert chosen == {False, True}


@pytest.mark.parametrize("meshes", list(MESHES), indirect=True)
def test_batch_specs_and_data_sharding(meshes):
    tmesh, jmesh = meshes
    for tcfg, jc in archs():
        for shape in SHAPES.values():
            for batch in (shape.global_batch, 3):
                same_specs(
                    tsh.batch_specs(models.model.input_specs(
                        tcfg, 64, batch, shape.kind), tmesh),
                    jsh.batch_specs(jm.model.input_specs(
                        jc, 64, batch, shape.kind), jmesh),
                    (tcfg.name, shape.name, batch))
    assert tsh.data_sharding(tmesh).spec \
        == tuple(jsh.data_sharding(jmesh).spec)


@pytest.mark.parametrize("meshes", list(MESHES), indirect=True)
def test_kv_cache_sharding(meshes):
    tmesh, jmesh = meshes
    for tcfg, jc in archs():
        if not tcfg.has_decode:
            continue
        for batch in (128, 3):
            same_specs(
                tsh.kv_cache_sharding(tmesh, models.init_decode_state(
                    tcfg, batch, 256, abstract=True)),
                jsh.kv_cache_sharding(jmesh, jm.init_decode_state(
                    jc, batch, 256, abstract=True)), (tcfg.name, batch))


def out_shapes(cfg, batch, seq, meta):
    """A prefill's outputs as shapes: logits [B, V], one (k, v) pair
    [G, B, S, KH, Dh] per attention position, and a scalar."""
    period = models.model.period_of(cfg)
    kv = (cfg.n_layers // period, batch, seq, cfg.n_kv_heads, cfg.head_dim)
    n_attn = sum(m == "attn" for m, _ in models.model.layer_kinds(cfg))
    return (meta((batch, cfg.vocab)), tuple((meta(kv), meta(kv))
                                            for _ in range(n_attn)),
            meta(()))


@pytest.mark.parametrize("meshes", list(MESHES), indirect=True)
def test_auto_out_shardings(meshes):
    tmesh, jmesh = meshes

    def tmeta(shape):
        return torch.empty(shape, device="meta")

    def jmeta(shape):
        return jax.ShapeDtypeStruct(shape, jax.numpy.float32)

    for tcfg, _ in archs():
        if not tcfg.n_heads:
            continue
        for batch in (32, 3):
            same_specs(
                auto_out_shardings(tmesh, out_shapes(tcfg, batch, 64, tmeta),
                                   batch),
                jdry.auto_out_shardings(
                    jmesh, out_shapes(tcfg, batch, 64, jmeta), batch),
                (tcfg.name, batch))


def test_make_mesh_and_production_mesh():
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    for multi, shape in ((False, (16, 16)), (True, (2, 16, 16))):
        with fake_world(math.prod(shape)):
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            assert tuple(mesh.shape) == shape
            assert mesh.mesh_dim_names == (("pod",) if multi else ()) \
                + ("data", "model")
    with fake_world(8):
        assert tuple(make_host_mesh(2, 4, "cpu").shape) == (2, 4)
        assert tuple(make_host_mesh(16, 4, "cpu").shape) == (2, 4)
        assert tuple(make_host_mesh(8, 1, "cpu").shape) == (8, 1)
