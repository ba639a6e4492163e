"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \
        --steps 200 --batch 4 --seq 4096 --remat full --ckpt-dir ckpt

runs on the card and raises if there is none; add ``--smoke --device cpu``
for the reduced config on the CPU.  ``--mesh host`` builds the mesh over the
devices at hand (``{"data": n // model, "model": model}``); ``--mesh
single|multi`` names the production mesh, which needs its 256 or 512
devices.  Checkpointing/resume via ``--ckpt-dir``: a run started again with
the same directory resumes from its newest committed step.

Over N processes, one a device::

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --arch mamba2-1.3b --smoke --device cpu --steps 8

each process joins the group (``env://``; NCCL on cards, ``gloo`` on the
CPU), and ``--mesh host`` builds the JAX launcher's host mesh over it,
``{"data": N // model, "model": model}`` with ``model = 2`` from 4
processes on: the step is data-parallel over ``data``, each data process
training on its rows of the global ``--batch``, and tensor- and
expert-parallel over ``model`` (``repro_torch.train.step``).  Only rank 0
prints and writes checkpoints.

Counterpart of ``repro/launch/train.py``, with the same flags and
``--device``.  ``build_run`` turns the arguments into what ``main`` hands
``train``, so that a caller can drive exactly what the launcher drives.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import sync_policy_choices
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.launch.mesh import device_mesh, make_host_mesh, make_production_mesh, mesh_num_chips
from repro_torch.parallel.dist import is_distributed, join_if_launched
from repro_torch.train.data import SyntheticLM, make_batch_fn
from repro_torch.train.loop import TrainerConfig, train
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import TrainConfig

__all__ = ["build_run", "main"]


def build_run(argv: Optional[List[str]] = None):
    """The arguments as ``(cfg, tcfg, trainer, mesh, batch_fn, device)``.  In
    a process group (one is joined here when ``torchrun`` started the
    process) the mesh is a ``DeviceMesh``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--sync", default="scu", choices=list(sync_policy_choices()))
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--mesh", default="host", choices=["host", "single", "multi"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device, _ = join_if_launched(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if is_distributed():
        n = dist.get_world_size()
    else:
        n = torch.cuda.device_count() if device.type == "cuda" else 1
    if args.mesh == "host":
        model = 2 if n >= 4 else 1
        mesh = make_host_mesh(data=n // model, model=model, device=device)
        if is_distributed():
            mesh = device_mesh(mesh, device)
    else:
        mesh = make_production_mesh(multi_pod=(args.mesh == "multi"))
        if mesh_num_chips(mesh) > n:
            ap.error(f"--mesh {args.mesh} needs {mesh_num_chips(mesh)} devices, have {n}")

    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq, seed=0)
    tcfg = TrainConfig(
        opt=OptConfig(lr=args.lr, warmup_steps=10),
        sync_strategy=args.sync,
        remat_policy=args.remat,
        grad_accum=args.grad_accum,
    )
    trainer = TrainerConfig(
        steps=args.steps,
        ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir,
        log_every=10,
    )
    return cfg, tcfg, trainer, mesh, make_batch_fn(data, args.batch), device


def main(argv: Optional[List[str]] = None):
    """Train as the arguments say; returns ``train``'s (params, opt_state, history).
    A process group joined for the run is left before returning."""
    joined = not is_distributed()
    cfg, tcfg, trainer, mesh, batch_fn, device = build_run(argv)
    try:
        return train(cfg, tcfg, trainer, mesh, batch_fn, device=device)
    finally:
        if joined and is_distributed():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
