"""Training loop: init -> (restore?) -> step loop -> checkpoint/metrics.

Counterpart of ``repro/train/loop.py``, with its fault-tolerance contract:
  * checkpoint every ``ckpt_every`` steps (atomic, async, keep-last-k);
  * on start, resume from the latest committed step if one exists (step 0
    is one);
  * the data pipeline is a pure function of ``step`` -- restart reproduces
    the exact batch sequence;
  * a step that takes longer than ``step_timeout_s`` raises, so that the
    supervisor (the launch script) can re-carve the mesh (see
    ``repro_torch/train/elastic.py``) and restart from the last checkpoint.

The loop runs on one ``device`` (the card unless the caller asks for the
CPU).  A resumed run restores into the abstract tree (``meta`` tensors, no
storage), so the state is never held twice on the device.  Batches come from
``batch_fn`` as host numpy arrays and are moved to the device here, token
ids as int64.  The step updates the optimizer state in place; the
checkpoint manager snapshots a copy before the next step runs.

Over a ``DeviceMesh`` (one process a device, ``repro_torch.train.step``)
every process runs this loop: ``batch_fn(i)`` is the global batch, and each
process takes its rows ``[r b, (r + 1) b)`` of it by the batch's placement,
as the reference's batch sharding splits it; the state is initialised or
restored at the step's placements (each process's blocks over ``model``
and, for the optimizer state, over the data axes); a checkpoint gathers
every process's block onto rank 0, which writes one slot a rank; only rank
0 prints.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.compat import resolve_device, torch_dtype
from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import init_lm
from repro_torch.parallel.dist import is_distributed
from repro_torch.parallel.sharding import shard_local
from repro_torch.train.checkpoint import CheckpointManager, latest_step, restore_checkpoint
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.step import TrainConfig, make_train_step

__all__ = ["TrainerConfig", "train"]


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    seed: int = 0
    step_timeout_s: float = 3600.0


def _device_batch(batch: Dict[str, np.ndarray], device: torch.device, shardings=None) -> Dict[str, torch.Tensor]:
    """A host batch on ``device``: integer arrays (token ids, labels) as
    int64, the index type of the embedding lookup; others as they are.  With
    ``shardings`` (the step's ``batch_shardings``), this process's rows only."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    if shardings is not None:
        out = {k: shard_local(v, s) for (k, v), s in zip(out.items(), shardings(out).values())}
    return {k: t.to(device) if t.is_floating_point() else t.to(device, torch.int64) for k, t in out.items()}


def train(
    cfg: ModelConfig,
    tcfg: TrainConfig,
    trainer: TrainerConfig,
    mesh,
    batch_fn: Callable[[int], Dict[str, np.ndarray]],
    on_metrics: Optional[Callable[[int, Dict[str, float]], None]] = None,
    device: Union[str, torch.device] = "cuda",
):
    """Run the training loop; returns (params, opt_state, metrics history)."""
    device = resolve_device(device)
    step_fn, (in_sh, batch_sh), _, params_sds = make_train_step(cfg, tcfg, mesh)
    placed = not isinstance(mesh, Mapping)
    state_sh = {"params": in_sh[0], "opt": in_sh[1], "step": in_sh[2]}
    lead = not is_distributed() or dist.get_rank() == 0

    start = 0
    if trainer.ckpt_dir and (ls := latest_step(trainer.ckpt_dir)) is not None:
        if lead:
            print(f"[train] resuming from step {ls}")
        state_target = {
            "params": params_sds,
            "opt": init_opt_state(params_sds),
            "step": torch.zeros((), dtype=torch.int32, device="meta"),
        }
        restored = restore_checkpoint(trainer.ckpt_dir, ls, state_target, state_sh, device=device)
        params, opt_state = restored["params"], restored["opt"]
        start = int(restored["step"])
        # the restored params are replaced by the first step's: no other
        # reference may keep them on the device (2.5 GiB at mamba2's size)
        del restored
    else:
        gen = torch.Generator(device).manual_seed(trainer.seed)
        params = init_lm(gen, cfg, torch_dtype(tcfg.param_dtype), shardings=in_sh[0] if placed else None)
        opt_state = init_opt_state(params, in_sh) if placed else init_opt_state(params)

    ckpt = CheckpointManager(trainer.ckpt_dir) if trainer.ckpt_dir else None
    history = []
    step = torch.tensor(start, dtype=torch.int32, device=device)
    for i in range(start, trainer.steps):
        t0 = time.perf_counter()
        batch = _device_batch(batch_fn(i), device, batch_sh if placed else None)
        params, opt_state, step, metrics = step_fn(params, opt_state, step, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["step_time_s"] = time.perf_counter() - t0
        if metrics["step_time_s"] > trainer.step_timeout_s:
            raise TimeoutError(
                f"step {i} exceeded {trainer.step_timeout_s}s -- straggler; "
                "supervisor should re-carve (elastic.py) and restart"
            )
        history.append(metrics)
        if on_metrics:
            on_metrics(i, metrics)
        if lead and trainer.log_every and i % trainer.log_every == 0:
            print(
                f"[train] step {i:5d} loss {metrics['loss']:.4f} "
                f"gnorm {metrics['grad_norm']:.3f} "
                f"({metrics['step_time_s']*1e3:.0f} ms)"
            )
        if ckpt and (i + 1) % trainer.ckpt_every == 0:
            ckpt.save(i + 1, {"params": params, "opt": opt_state, "step": step}, state_sh if placed else None)
    if ckpt:
        ckpt.wait()
    return params, opt_state, history
