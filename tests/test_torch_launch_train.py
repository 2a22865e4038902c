"""The port's training launcher (``repro_torch.launch.train``) and its
100M example: the twin of tests/test_launch.py's checkpoint/restart test
(``slow``, as the reference's), a resumed run equal to an uninterrupted
one bit for bit (tier 1), the launcher's loss and checkpoint against the
JAX package's launcher on the same params, and the example's settings
equal to ``examples/train_100m.py``'s."""
import dataclasses
import importlib.util
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import models as jm
from repro.launch import train as jlaunch
from repro_torch import configs, models
from repro_torch import train_100m
from repro_torch.checkpoint import ckpt
from repro_torch.launch import train as launch


ROOT = Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")
# the params after 3 launcher steps, port against the JAX launcher in f32
# (measured: 3.4e-6 at most), where the steps move them by up to about 1e-3
LAUNCH_PARAM_TOL = 1e-5
ARGS = ["--arch", "qwen1.5-0.5b", "--reduced", "--global-batch", "4",
        "--seq-len", "32", "--log-every", "2", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread_and_clear_jax_caches():
    """torch on one thread in this module (xdist runs a worker per core,
    and torch's OpenMP threads would contend across them), and this
    module's JAX programs, and those of the modules before it, dropped as
    it starts and at its end, so an xdist worker does not gather them."""
    jax.clear_caches()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.clear_caches()


def restored(d, step):
    """The checkpoint at ``step`` as flat {path: tensor} on the CPU."""
    cfg = configs.reduced(configs.get_config("qwen1.5-0.5b"))
    from repro_torch.training import optimizer as topt
    params = models.make_abstract_params(cfg)
    example = {"params": params, "opt": topt.abstract_opt_state(params)}
    return ckpt._flatten(ckpt.restore(str(d), step, example, device="cpu"))


def jp_leaf(tree, key):
    """The leaf of the reference's param tree at checkpoint key
    ``params/a/b``."""
    for part in key.split("/")[1:]:
        tree = tree[part]
    return tree


class Crash(Exception):
    pass


def test_resumed_training_equals_uninterrupted(tmp_path, monkeypatch):
    """A 12-step run that dies right after its step-8 checkpoint, then
    relaunched with ``--resume auto``, ends with the same params, moments
    and step as an uninterrupted 12-step run, bit for bit, and the same
    last loss."""
    straight = launch.main(ARGS + ["--steps", "12", "--ckpt-every", "4",
                                   "--ckpt-dir", str(tmp_path / "a")])
    save = ckpt.save

    def crash_after_8(d, step, tree, blocking=True):
        th = save(d, step, tree, blocking=blocking)
        if step == 8:
            th.join()
            raise Crash()
        return th
    monkeypatch.setattr(launch.ckpt, "save", crash_after_8)
    with pytest.raises(Crash):
        launch.main(ARGS + ["--steps", "12", "--ckpt-every", "4",
                            "--ckpt-dir", str(tmp_path / "b"),
                            "--resume", "auto"])
    monkeypatch.setattr(launch.ckpt, "save", save)
    assert ckpt.latest_step(str(tmp_path / "b")) == 8
    resumed = launch.main(ARGS + ["--steps", "12", "--ckpt-every", "4",
                                  "--ckpt-dir", str(tmp_path / "b"),
                                  "--resume", "auto"])
    assert resumed == straight
    a, b = restored(tmp_path / "a", 12), restored(tmp_path / "b", 12)
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert int(b["opt/step"]) == 12


def test_launcher_matches_the_jax_launcher(tmp_path, monkeypatch, capsys):
    """Both launchers, 3 steps of reduced Qwen1.5-0.5B in f32 on the same
    params (``jax.random`` draws carried across): the final losses to
    1e-5, the logged ones as printed (4 decimals); in the step-3
    checkpoints the params to LAUNCH_PARAM_TOL, well below the 1e-3 or so
    that 3 steps at lr 1.5e-4, 3e-4 and 4.5e-4 move them, the moments to
    1e-4 of each leaf's largest value, the step equal."""
    for mod in (jcfg, configs):
        small = mod.reduced
        monkeypatch.setattr(mod, "reduced", lambda c, small=small:
                            dataclasses.replace(small(c), dtype="float32"))
    jc = jcfg.reduced(jcfg.get_config("qwen1.5-0.5b"))
    jp = jax.tree.map(np.asarray, jm.make_params(jc, jax.random.PRNGKey(0)))
    assert {a.dtype for a in jax.tree.leaves(jp)} == {np.dtype(np.float32)}
    monkeypatch.setattr(launch, "make_params",
                        lambda cfg, gen, dev: models.from_numpy(cfg, jp, dev))
    common = ["--arch", "qwen1.5-0.5b", "--reduced", "--global-batch", "4",
              "--seq-len", "32", "--log-every", "1", "--steps", "3",
              "--ckpt-every", "3"]
    j_final = jlaunch.main(common + ["--ckpt-dir", str(tmp_path / "j")])
    jout = capsys.readouterr().out
    t_final = launch.main(common + ["--ckpt-dir", str(tmp_path / "t"),
                                    "--device", "cpu"])
    tout = capsys.readouterr().out

    def losses(out):
        return re.findall(r"loss=([0-9.]+)", out)
    assert len(losses(jout)) == 3 and losses(tout) == losses(jout)
    np.testing.assert_allclose(t_final, j_final, rtol=1e-5)
    want, got = restored(tmp_path / "j", 3), restored(tmp_path / "t", 3)
    assert list(want) == list(got)
    moved = 0.0
    for k in want:
        w, g = want[k].numpy(), got[k].numpy()
        if k.startswith("params/"):
            np.testing.assert_allclose(g, w, atol=LAUNCH_PARAM_TOL, rtol=0,
                                       err_msg=k)
            first = np.asarray(jp_leaf(jp, k))
            moved = max(moved, float(np.abs(w - first).max()))
        elif k != "opt/step":
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), k
    assert moved > 50 * LAUNCH_PARAM_TOL, moved
    assert int(got["opt/step"]) == int(want["opt/step"]) == 3


def test_mesh_flags_name_the_distributed_slice(monkeypatch, capsys):
    """``--data 1 --model 1`` is the one-device loop (the reference's (1,
    1) mesh replicates everything), and a mesh of more ranks outside
    ``torchrun`` raises, naming the command that starts it (the mesh
    itself: tests/test_torch_distributed.py)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    a = launch.main(ARGS + ["--steps", "2"])
    b = launch.main(ARGS + ["--steps", "2", "--data", "1", "--model", "1"])
    assert a == b
    out = capsys.readouterr().out
    assert out.count("step 2: loss") == 2
    for flag in (["--data", "2"], ["--model", "4"]):
        with pytest.raises(ValueError, match="torchrun --nproc-per-node"):
            launch.main(ARGS + ["--steps", "1"] + flag)


def test_launcher_runs_on_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        launch.main(["--arch", "qwen1.5-0.5b", "--reduced", "--steps", "1"])


def test_train_100m_has_the_examples_settings(monkeypatch, tmp_path):
    """``repro_torch.train_100m`` hands ``launch.train`` the arguments
    ``examples/train_100m.py`` hands the JAX launcher, for the same
    ~100M-parameter config."""
    seen = {}
    monkeypatch.setattr(jcfg, "REGISTRY", dict(jcfg.REGISTRY))
    monkeypatch.setattr(jlaunch, "main",
                        lambda argv: seen.setdefault("jax", argv) and 0.0)
    spec = importlib.util.spec_from_file_location(
        "example_train_100m", ROOT / "examples" / "train_100m.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    monkeypatch.setattr(sys, "argv", ["train_100m.py", "--steps", "300",
                                      "--ckpt-dir", str(tmp_path)])
    example.main()
    want_cfg = jcfg.REGISTRY["qwen-100m"]
    monkeypatch.setattr(configs, "REGISTRY", dict(configs.REGISTRY))
    monkeypatch.setattr(launch, "main",
                        lambda argv: seen.setdefault("torch", argv) and 0.0)
    train_100m.main(["--steps", "300", "--ckpt-dir", str(tmp_path)])
    assert seen["torch"] == seen["jax"] == train_100m.argv(300, str(tmp_path))
    got_cfg = configs.REGISTRY["qwen-100m"]
    for field in ("d_model", "n_heads", "n_kv_heads", "d_ff", "n_layers",
                  "vocab", "tie_embeddings", "qkv_bias", "dtype"):
        assert getattr(got_cfg, field) == getattr(want_cfg, field), field


@pytest.mark.slow
def test_checkpoint_restart_fault_tolerance(tmp_path):
    """Twin of tests/test_launch.py::test_checkpoint_restart_fault_tolerance:
    kill a training run mid-flight; the relaunch resumes from the last
    complete checkpoint and finishes with the same step count."""
    env = dict(os.environ, PYTHONPATH=SRC)
    args = [sys.executable, "-m", "repro_torch.launch.train",
            "--arch", "qwen1.5-0.5b", "--reduced", "--steps", "12",
            "--global-batch", "4", "--seq-len", "32",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "4",
            "--resume", "auto", "--log-every", "2", "--device", "cpu"]
    # run 1: killed after the first checkpoint lands
    p = subprocess.Popen(args, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    deadline = time.time() + 500
    while time.time() < deadline:
        if ckpt.latest_step(str(tmp_path)) is not None:
            break
        time.sleep(1)
        if p.poll() is not None:
            break
    p.kill()
    p.wait()
    first = ckpt.latest_step(str(tmp_path))
    assert first is not None and first >= 4

    # run 2: resumes and completes
    r = subprocess.run(args, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "resumed from step" in r.stdout
    assert ckpt.latest_step(str(tmp_path)) == 12
