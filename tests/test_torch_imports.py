"""The port stands alone: no JAX, nothing of the JAX package, and no
silent move to the CPU."""
import ast
import importlib
import pathlib
import re
import subprocess
import sys

import pytest
import torch

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


def submodules(pkg):
    return sorted(f"repro_torch.{pkg}.{f.stem}"
                  for f in (PORT / pkg).glob("*.py") if f.stem != "__init__")


CORE = submodules("core")
OBS = submodules("obs")
SERVICE = submodules("service")
CONFIGS = submodules("configs")
MODELS = submodules("models")
TRAINING = submodules("data") + submodules("training") \
    + submodules("checkpoint") + ["repro_torch.launch.train",
                                  "repro_torch.libm", "repro_torch.train_100m"]
DISTRIBUTED = submodules("distributed") + ["repro_torch.launch.mesh",
                                           "repro_torch.launch.dryrun"]
MODULES = ["repro_torch", "repro_torch.kernels.ops", "repro_torch.kernels.build",
           "repro_torch.kernels.paged_attention",
           "repro_torch.kernels.alloc_scan", "repro_torch.kernels.fast_window",
           "repro_torch.kernels.sass",
           "repro_torch.memsys.tiered_kv", "repro_torch.serving.engine",
           "repro_torch.serving.serve_tiered", "repro_torch.configs",
           "repro_torch.configs.qwen2_5_14b", "repro_torch.core",
           "repro_torch.quickstart", "repro_torch.multitenant_sim",
           "repro_torch.obs",
           "repro_torch.service", "repro_torch.models",
           "repro_torch.launch.analysis"] + CORE + OBS + SERVICE + CONFIGS \
    + MODELS + TRAINING + DISTRIBUTED
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|repro|ml_dtypes)(\.|\s|$)",
    re.MULTILINE)


def test_no_source_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [SRC.parent / "chip_smoke.py",
                                          SRC.parent / "chip_ab.py",
                                          SRC.parent / "chip_model_ab.py"]
    assert len(files) >= 10
    bad = [str(f) for f in files if FORBIDDEN.search(f.read_text())]
    assert bad == []


def test_simulator_modules_are_all_checked():
    assert CORE == ["repro_torch.core.alloc", "repro_torch.core.config",
                    "repro_torch.core.migrate", "repro_torch.core.ref",
                    "repro_torch.core.sim",
                    "repro_torch.core.state", "repro_torch.core.sweep",
                    "repro_torch.core.tlbs", "repro_torch.core.workloads"]


def test_service_and_obs_modules_are_all_checked():
    """Every module of the reference's ``obs`` and ``service`` has its
    twin, and the import check covers each."""
    ref = SRC / "repro"
    for pkg, mods in (("obs", OBS), ("service", SERVICE)):
        want = sorted(f"repro_torch.{pkg}.{f.stem}"
                      for f in (ref / pkg).glob("*.py") if f.stem != "__init__")
        assert mods == want
        assert set(mods) <= set(MODULES)
    assert OBS == ["repro_torch.obs.bench", "repro_torch.obs.inject",
                   "repro_torch.obs.metrics", "repro_torch.obs.report",
                   "repro_torch.obs.telemetry", "repro_torch.obs.tracing",
                   "repro_torch.obs.validate"]
    assert SERVICE == ["repro_torch.service.broker",
                       "repro_torch.service.cache",
                       "repro_torch.service.query",
                       "repro_torch.service.resilience",
                       "repro_torch.service.search"]


def test_configs_and_models_modules_are_all_checked():
    """Every module of the reference's ``configs`` and ``models`` has its
    twin, the import check covers each, and the packages export the
    reference's public names."""
    ref = SRC / "repro"
    for pkg, mods in (("configs", CONFIGS), ("models", MODELS)):
        want = sorted(f"repro_torch.{pkg}.{f.stem}"
                      for f in (ref / pkg).glob("*.py") if f.stem != "__init__")
        assert mods == want
        assert set(mods) <= set(MODULES)
    assert len(CONFIGS) == 11 and MODELS == [
        "repro_torch.models.layers", "repro_torch.models.mamba",
        "repro_torch.models.model", "repro_torch.models.modules",
        "repro_torch.models.moe", "repro_torch.models.rwkv"]
    for pkg in ("configs", "models"):
        tree = ast.parse((ref / pkg / "__init__.py").read_text())
        public = {a.asname or a.name for node in tree.body
                  if isinstance(node, ast.ImportFrom) and node.module
                  for a in node.names}
        public |= {e.value for node in tree.body if isinstance(node, ast.Assign)
                   and node.targets[0].id == "__all__" for e in node.value.elts}
        mod = importlib.import_module(f"repro_torch.{pkg}")
        missing = sorted(n for n in public if not hasattr(mod, n))
        assert public and not missing, (pkg, missing)


# the reference's ``shard_map`` is an API-drift wrapper around JAX's manual
# SPMD, with no counterpart: the port's compressed step is per-rank code
NO_COUNTERPART = {"shard_map"}
HLO_TEXT = {"COLLECTIVE_RE", "SHAPE_RE", "GROUP_RE", "DTYPE_BYTES",
            "_shape_bytes"}


def test_training_modules_are_all_checked():
    """Every module of the reference's ``data``, ``training``,
    ``checkpoint`` and ``distributed`` and its ``launch/train.py``,
    ``launch/mesh.py`` and ``launch/dryrun.py`` has its twin with the
    reference's top-level names, and the import check covers each."""
    ref = SRC / "repro"
    for pkg in ("data", "training", "checkpoint", "distributed"):
        want = sorted(f"repro_torch.{pkg}.{f.stem}"
                      for f in (ref / pkg).glob("*.py") if f.stem != "__init__")
        assert submodules(pkg) == want and set(want) <= set(MODULES)
    for rel in ("data/pipeline.py", "training/optimizer.py",
                "training/train.py", "checkpoint/ckpt.py", "launch/train.py",
                "distributed/sharding.py", "launch/mesh.py",
                "launch/dryrun.py", "launch/analysis.py"):
        tree = ast.parse((ref / rel).read_text())
        names = {n.name for n in tree.body
                 if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
        names |= {t.id for n in tree.body if isinstance(n, ast.Assign)
                  for t in n.targets if isinstance(t, ast.Name)
                  and t.id.isupper()}
        mod = importlib.import_module(
            "repro_torch." + rel[:-3].replace("/", "."))
        names -= NO_COUNTERPART
        if rel == "launch/analysis.py":   # XLA's HLO text, which the port
            names -= HLO_TEXT             # does not read
        missing = sorted(n for n in names if not hasattr(mod, n))
        assert names and not missing, (rel, missing)


def test_import_leaves_jax_out():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
              "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=SRC,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.serving import serve_tiered as st
    from repro_torch.serving.engine import TieredServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        TieredServingEngine(n_groups=1, kv_heads=1, head_dim=8)
    with pytest.raises(RuntimeError, match="is_available"):
        st.serve(st.PRESSURE)
    from repro_torch import core
    mc = core.MachineConfig(n_threads=2, va_pages=1 << 10)
    trace = core.workloads.kv_store(mc, 64, 4)
    with pytest.raises(RuntimeError, match="is_available"):
        core.TieredMemSimulator(mc=mc).run(trace)
    with pytest.raises(RuntimeError, match="is_available"):
        core.init_state(mc)
    from repro_torch.service import SimBroker
    with pytest.raises(RuntimeError, match="is_available"):
        SimBroker()
    with pytest.raises(RuntimeError, match="is_available"):
        SimBroker(device=None)
    from repro_torch import configs, models
    cfg = configs.reduced(configs.get_config("qwen1.5-0.5b"))
    with pytest.raises(RuntimeError, match="is_available"):
        models.make_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="is_available"):
        models.init_decode_state(cfg, 1, 8)
    from repro_torch.launch import analysis
    monkeypatch.setattr(analysis, "_BROKER", None)
    with pytest.raises(RuntimeError, match="is_available"):
        analysis.policy_sweep_summary(mc, [core.linux_default()], trace)
    # the CPU is there when asked for
    assert core.TieredMemSimulator(mc=mc, device="cpu").run(trace) \
        .summary()["faults"] > 0
    assert core.init_state(mc, device="cpu").data_node.device.type == "cpu"
    assert SimBroker(device="cpu").device.type == "cpu"
