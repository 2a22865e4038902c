"""The port stands alone: no JAX, nothing of the JAX package, and no
silent move to the CPU."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
CORE = sorted(f"repro_torch.core.{f.stem}" for f in (PORT / "core").glob("*.py")
              if f.stem != "__init__")
MODULES = ["repro_torch", "repro_torch.kernels.ops", "repro_torch.kernels.build",
           "repro_torch.kernels.paged_attention",
           "repro_torch.kernels.alloc_scan", "repro_torch.kernels.fast_window",
           "repro_torch.kernels.sass",
           "repro_torch.memsys.tiered_kv", "repro_torch.serving.engine",
           "repro_torch.serving.serve_tiered", "repro_torch.configs",
           "repro_torch.configs.qwen2_5_14b", "repro_torch.core",
           "repro_torch.quickstart"] + CORE
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                       re.MULTILINE)


def test_no_source_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [SRC.parent / "chip_smoke.py",
                                          SRC.parent / "chip_ab.py"]
    assert len(files) >= 10
    bad = [str(f) for f in files if FORBIDDEN.search(f.read_text())]
    assert bad == []


def test_simulator_modules_are_all_checked():
    assert CORE == ["repro_torch.core.alloc", "repro_torch.core.config",
                    "repro_torch.core.migrate", "repro_torch.core.sim",
                    "repro_torch.core.state", "repro_torch.core.sweep",
                    "repro_torch.core.tlbs", "repro_torch.core.workloads"]


def test_import_leaves_jax_out():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'repro'))\n"
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
    # the CPU is there when asked for
    assert core.TieredMemSimulator(mc=mc, device="cpu").run(trace) \
        .summary()["faults"] > 0
    assert core.init_state(mc, device="cpu").data_node.device.type == "cpu"
