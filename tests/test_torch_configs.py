"""The port's architecture registry (``repro_torch.configs``), parameter
specs and launch analysis held against the JAX package's, field for
field: the registry and ``reduced``, the parameter counts, the 40-cell
validity matrix, ``SHAPES``, every arch's parameter specs and input specs
at full size, the twins of tests/test_launch.py's ``model_flops`` tests
and of tests/test_service.py's ``policy_sweep_summary`` test."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import models as jm
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import analysis as janalysis
from repro_torch import configs
from repro_torch import models
from repro_torch.configs.base import SHAPES, cell_is_valid
from repro_torch.launch.analysis import model_flops
from repro_torch.models.modules import tree_leaves, tree_map

import test_torch_service as tsvc
from test_torch_engine import fresh_jax_caches  # noqa: F401 (autouse)


def test_registry_matches_the_reference_field_for_field():
    assert configs.ARCH_IDS == jcfg.ARCH_IDS
    for arch_id in configs.ARCH_IDS:
        got, want = configs.get_config(arch_id), jcfg.get_config(arch_id)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), arch_id
        assert type(got.moe).__name__ == type(want.moe).__name__
        assert type(got.mamba).__name__ == type(want.mamba).__name__
        for prop in ("head_dim", "attn_free", "sub_quadratic", "has_decode"):
            assert getattr(got, prop) == getattr(want, prop), (arch_id, prop)
        assert got.param_dtype() == torch.bfloat16
        assert str(want.param_dtype()) == "bfloat16"
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-2")


@pytest.mark.parametrize("arch_id", jcfg.ARCH_IDS)
def test_param_counts_and_reduced_match(arch_id):
    full, jfull = configs.get_config(arch_id), jcfg.get_config(arch_id)
    red, jred = configs.reduced(full), jcfg.reduced(jfull)
    assert dataclasses.asdict(red) == dataclasses.asdict(jred)
    for cfg, jc_ in ((full, jfull), (red, jred)):
        assert cfg.n_params() == jc_.n_params()
        assert cfg.n_active_params() == jc_.n_active_params()
        assert cfg.n_expert_params() == jc_.n_expert_params()


def test_shapes_and_cell_validity_matrix():
    """The 40-cell matrix: 31 valid, 9 skipped, with the reference's
    reasons (twin of tests/test_launch.py::test_cell_validity_matrix)."""
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    valid = skipped = 0
    for arch_id in configs.ARCH_IDS:
        for name, shape in SHAPES.items():
            got = cell_is_valid(configs.get_config(arch_id), shape)
            assert got == jcfg.cell_is_valid(jcfg.get_config(arch_id),
                                             JSHAPES[name])
            valid += got[0]
            skipped += not got[0]
            assert got[0] or got[1]
        assert SHAPES["decode_32k"].is_decode == JSHAPES["decode_32k"].is_decode
    assert valid == 31 and skipped == 9


def test_model_flops_scaling():
    """Twin of tests/test_launch.py::test_model_flops_scaling."""
    cfg = configs.get_config("qwen2.5-14b")
    train = model_flops(cfg, SHAPES["train_4k"])
    prefill = model_flops(cfg, SHAPES["prefill_32k"])
    decode = model_flops(cfg, SHAPES["decode_32k"])
    assert abs(train / prefill - 3.0) < 1e-6
    assert decode == pytest.approx(2.0 * cfg.n_active_params() * 128)


def test_moe_flops_use_active_params():
    """Twin of tests/test_launch.py::test_moe_flops_use_active_params."""
    mav = configs.get_config("llama4-maverick-400b-a17b")
    dense_equiv = model_flops(mav, SHAPES["train_4k"])
    assert dense_equiv < 6.0 * mav.n_params() * 4096 * 256 / 10


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_model_flops_equal_the_reference(shape):
    for arch_id in configs.ARCH_IDS:
        assert model_flops(configs.get_config(arch_id), SHAPES[shape]) == \
            janalysis.model_flops(jcfg.get_config(arch_id), JSHAPES[shape])


def _spec_tuple(s):
    return (tuple(s.shape), tuple(s.logical_axes), s.dtype, s.init, s.scale)


@pytest.mark.parametrize("arch_id", jcfg.ARCH_IDS)
def test_param_and_input_specs_match_at_full_size(arch_id):
    """Every arch's parameter tree at full size: the same keys, shapes,
    logical axes, dtypes and initializers as the reference's; the same
    count; the abstract params on the ``meta`` device; the same input
    specs for each kind."""
    cfg, jc_ = configs.get_config(arch_id), jcfg.get_config(arch_id)
    got = models.param_specs(cfg)
    want = jm.param_specs(jc_)
    assert tree_map(_spec_tuple, got) == tree_map(_spec_tuple, want)
    assert models.count_params(got) == jm.count_params(want)
    assert models.logical_axes_tree(got) == tree_map(
        tuple, jm.logical_axes_tree(want))
    abstract = models.make_abstract_params(cfg)
    jabs = jm.make_abstract_params(jc_)
    for a, s in zip(tree_leaves(abstract), tree_leaves(got)):
        assert a.device.type == "meta" and tuple(a.shape) == s.shape
        assert str(a.dtype) == f"torch.{s.dtype}"
    assert sum(a.numel() for a in tree_leaves(abstract)) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(jabs))
    assert models.period_of(cfg) == jm.period_of(jc_)
    assert models.layer_kinds(cfg) == jm.layer_kinds(jc_)
    for kind in ("train", "prefill", "decode"):
        spec = models.input_specs(cfg, 64, 2, kind)
        jspec = jm.input_specs(jc_, 64, 2, kind)
        assert spec.keys() == jspec.keys()
        for k in spec:
            assert tuple(spec[k].shape) == jspec[k].shape
            assert str(spec[k].dtype)[6:] == str(jspec[k].dtype)


def test_policy_sweep_summary_routes_through_broker():
    """Twin of tests/test_service.py::test_policy_sweep_summary_routes_
    through_broker on the port's broker (CPU), and the same summaries as
    the reference's (integers exact, floats to rtol 1e-5)."""
    from repro import service as jsvc
    from repro_torch.launch.analysis import policy_sweep_summary
    import test_service as ref
    mc = tsvc.tiny_machine()
    tr = tsvc.random_trace(mc, seed=33)
    broker = tsvc.broker(max_lanes=8)
    out = policy_sweep_summary(mc, tsvc.MIXED_POLICIES[:2], tr, broker=broker)
    assert broker.stats.lanes_run == 2
    labels = [pc.label() for pc in tsvc.MIXED_POLICIES[:2]]
    assert set(out) == set(labels)
    assert out[labels[0]]["improvement_pct"] == 0.0
    # regenerating the same grid is pure cache
    policy_sweep_summary(mc, tsvc.MIXED_POLICIES[:2], tr, broker=broker)
    assert broker.stats.lanes_run == 2 and broker.stats.cache_hits == 2

    jmc = ref.tiny_machine()
    want = janalysis.policy_sweep_summary(
        jmc, ref.MIXED_POLICIES[:2], ref.random_trace(jmc, seed=33),
        broker=jsvc.SimBroker(max_lanes=8))
    assert want.keys() == out.keys()
    for label in want:
        assert want[label].keys() == out[label].keys()
        for k, w in want[label].items():
            g = out[label][k]
            if isinstance(w, float):
                assert g == pytest.approx(w, rel=1e-5, abs=1e-9), (label, k)
            else:
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                              err_msg=f"{label}: {k}")
