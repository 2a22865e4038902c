"""Training launcher: config -> params -> train loop with checkpoint/restart
(twin of the JAX package's ``launch/train.py``: the same flags and log
lines, on one CUDA device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --reduced --steps 200 --ckpt-dir /tmp/ckpt --resume auto

Fault tolerance: checkpoints every ``--ckpt-every`` steps (atomic manifest,
async write), ``--resume auto`` restarts from the newest complete one, and
a per-step watchdog aborts cleanly if a step exceeds ``--step-timeout``
(on a real cluster the manager restarts the job, which then resumes).  The
data pipeline is stateless in (step, row), so a resumed run sees the
batches the uninterrupted one would have.

The loop reads nothing from the device but at a log step (the loss and
grad norm it prints) and at a checkpoint (the host copy of the state):
batches are made on the device and the step's metrics stay there.
``--device cpu`` runs the same loop on the CPU (for tests); the default
is the CUDA device, and without one the launcher raises.

``--data D --model M`` with ``D * M > 1`` trains on a (D, M) mesh of
``D * M`` ranks, one process each, started by ``torchrun`` (which sets
RANK, WORLD_SIZE and LOCAL_RANK):

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch \
        qwen1.5-0.5b --reduced --data 2 --model 2 --device cpu

Rank ``r`` uses CUDA device ``LOCAL_RANK`` over NCCL (``--device cpu``:
gloo), the params and the optimizer state are DTensors laid out by the
default rules, each DP rank draws its own rows of the batch
(``batch_at(..., host_rows=)``), rank 0 logs and writes the checkpoints.
``D * M == 1`` is the one-device loop (the reference's (1, 1) mesh
replicates everything).
"""
from __future__ import annotations

import argparse
import os
import signal
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import configs
from repro_torch.checkpoint import ckpt
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shard_mod
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import make_params, param_specs
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.train import TrainConfig, make_train_step


class StepWatchdog:
    """Aborts the process if a train step wedges (straggler/deadlock)."""

    def __init__(self, timeout_s: float):
        self.timeout = timeout_s

    def __enter__(self):
        if self.timeout > 0:
            signal.signal(signal.SIGALRM, self._fire)
            signal.alarm(int(self.timeout))
        return self

    def _fire(self, *_):
        raise TimeoutError(f"train step exceeded {self.timeout}s watchdog")

    def __exit__(self, *exc):
        if self.timeout > 0:
            signal.alarm(0)
        return False


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale variant (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="none", choices=["none", "auto"])
    ap.add_argument("--step-timeout", type=float, default=0.0)
    ap.add_argument("--data", type=int, default=1, help="mesh data axis")
    ap.add_argument("--model", type=int, default=1, help="mesh model axis")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    ranks = args.data * args.model
    dev = torch.device("cuda" if args.device is None else args.device)
    if ranks > 1 and dev.type == "cuda" \
            and torch.cuda.device_count() < ranks:
        raise ValueError(
            f"--data {args.data} --model {args.model} needs {ranks} CUDA "
            f"devices, one a rank; {torch.cuda.device_count()} visible")
    mesh = None
    if ranks > 1:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world != ranks:
            raise ValueError(
                f"--data {args.data} --model {args.model} needs {ranks} "
                f"ranks, started by torchrun --nproc-per-node {ranks}; "
                f"WORLD_SIZE is {world}")
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
        mesh = make_host_mesh(args.data, args.model, dev.type)
    dev = resolve_device(dev)
    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg)

    tc = TrainConfig(microbatches=args.microbatches,
                     opt=opt_mod.OptConfig(lr=args.lr, warmup_steps=20,
                                           total_steps=args.steps))
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                    global_batch=args.global_batch)

    params = make_params(cfg, torch.Generator().manual_seed(0), dev)
    opt_state = opt_mod.init_opt_state(params)
    shardings = None
    if mesh is not None:
        specs = param_specs(cfg)
        shardings = {"params": shard_mod.param_shardings(specs, mesh),
                     "opt": shard_mod.opt_state_shardings(specs, mesh)}
        tree = shard_mod.distribute({"params": params, "opt": opt_state},
                                    shardings)
        params, opt_state = tree["params"], tree["opt"]
    log = print if mesh is None or dist.get_rank() == 0 else _quiet
    start = 0
    if args.resume == "auto" and args.ckpt_dir:
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            tree = ckpt.restore(args.ckpt_dir, latest,
                                {"params": params, "opt": opt_state},
                                shardings, dev)
            params, opt_state = tree["params"], tree["opt"]
            start = latest
            log(f"resumed from step {latest}", flush=True)

    step_fn = make_train_step(cfg, tc, mesh, device=dev)
    t0 = time.time()
    pending = None
    for step in range(start, args.steps):
        batch = batch_at(dc, step, device=dev) if mesh is None \
            else _dp_rows(dc, step, mesh, dev)
        with StepWatchdog(args.step_timeout):
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (step + 1) % args.log_every == 0 or step == start:
            loss = float(metrics["loss"])
            tok_s = (dc.global_batch * dc.seq_len * args.log_every
                     / max(time.time() - t0, 1e-9))
            log(f"step {step + 1}: loss={loss:.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} "
                f"tok/s={tok_s:.0f}", flush=True)
            t0 = time.time()
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = ckpt.save(args.ckpt_dir, step + 1,
                                {"params": params, "opt": opt_state},
                                blocking=False)
    if pending is not None:
        pending.join()
    loss = float(metrics["loss"])
    if mesh is not None:
        dist.destroy_process_group()
    return loss


def _quiet(*_, **__):
    pass


def _dp_rows(dc: DataConfig, step: int, mesh, dev) -> dict:
    """Step ``step``'s batch as DTensors sharded over the mesh's DP axis:
    this rank draws only the rows of its DP index."""
    n_dp = mesh.size(mesh.mesh_dim_names.index("data"))
    per = dc.global_batch // n_dp
    r = mesh.get_local_rank("data")
    local = batch_at(dc, step, host_rows=(r * per, per), device=dev)
    pl = shard_mod.placements(("data", None), mesh)
    return {k: DTensor.from_local(v, mesh, pl, shape=(dc.global_batch,)
                                  + tuple(v.shape[1:]),
                                  stride=v.stride())
            for k, v in local.items()}


if __name__ == "__main__":
    main()
