"""End-to-end driver: train a ~100M-parameter qwen-family model (twin of
the JAX package's ``examples/train_100m.py``, the same settings).

    PYTHONPATH=src python -m repro_torch.train_100m [--steps 300]

Uses the whole training stack of the port on the CUDA device: config ->
params -> AdamW -> microbatched train step -> periodic checkpoints ->
resume.  The loss drops from about ln(vocab) as the model learns the
synthetic n-gram structure.
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch import configs
from repro_torch.launch import train as train_launch

# ~100M params: qwen1.5-0.5b topology, narrowed
CONFIG = dataclasses.replace(configs.get_config("qwen1.5-0.5b"),
                             name="qwen-100m", d_model=512, n_heads=8,
                             n_kv_heads=8, d_ff=1408, n_layers=12,
                             vocab=32768)


def argv(steps: int, ckpt_dir: str) -> list:
    """``launch.train``'s arguments at this example's settings."""
    return ["--arch", CONFIG.name, "--steps", str(steps),
            "--global-batch", "16", "--seq-len", "256", "--lr", "1e-3",
            "--microbatches", "2", "--ckpt-dir", ckpt_dir,
            "--ckpt-every", "100", "--resume", "auto", "--log-every", "20"]


def main(args=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_100m_ckpt"))
    args = ap.parse_args(args)
    configs.REGISTRY[CONFIG.name] = CONFIG
    loss = train_launch.main(argv(args.steps, args.ckpt_dir))
    print(f"final loss: {loss:.4f}")
    return loss


if __name__ == "__main__":
    main()
