"""End to end with the PyTorch port: train a ~100M-parameter dense
model on the synthetic corpus with checkpoints, then resume once (the
restart drill).  The twin of ``examples/train_100m.py``.

    PYTHONPATH=src python examples/train_100m_torch.py [--steps 300] [--device cuda|cpu]

It runs on the mesh the run has: ``{"data": 1, "model": 1}`` on one card
(or on the CPU), or ``{"data": 2, "model": 2}`` when launched as four
processes (``python -m torch.distributed.run --standalone
--nproc-per-node 4 examples/train_100m_torch.py``); the JAX example runs on
four XLA host devices of one process instead.  The checkpoints go to
``--ckpt`` (default ``build/train_100m_ckpt`` in the checkout, git-ignored),
which a fresh run empties first.  ``--smoke`` trains a narrower model of
the same family, for the CPU tests.
"""

import argparse
import dataclasses
import shutil
from pathlib import Path

import torch.distributed as dist

from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import device_mesh, make_host_mesh
from repro_torch.parallel.dist import is_distributed, join_if_launched
from repro_torch.train.data import SyntheticLM, make_batch_fn
from repro_torch.train.loop import TrainerConfig, train
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import TrainConfig

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=str(ROOT / "build" / "train_100m_ckpt"))
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--smoke", action="store_true", help="a narrow model of the same family (the CPU tests)")
    args = ap.parse_args(argv)
    device, joined = join_if_launched(args.device)
    lead = not is_distributed() or dist.get_rank() == 0
    log = print if lead else (lambda *a, **k: None)
    try:
        # ~100M params: a narrow stablelm-family variant
        width = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512) if args.smoke else \
            dict(n_layers=6, d_model=640, n_heads=8, n_kv_heads=8, d_ff=1792, vocab_size=50304)
        cfg = dataclasses.replace(get_config("stablelm-3b"), name="stablelm-100m", **width)
        log(f"{cfg.name}: {cfg.n_params() / 1e6:.0f}M params on {device}")

        n = dist.get_world_size() if is_distributed() else 1
        model = 2 if n >= 4 else 1
        mesh = make_host_mesh(data=n // model, model=model, device=device)
        log("mesh:", mesh)
        if is_distributed():
            mesh = device_mesh(mesh, device)
        if lead:
            shutil.rmtree(args.ckpt, ignore_errors=True)
        if is_distributed():
            dist.barrier()
        data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=128, seed=0)
        tcfg = TrainConfig(opt=OptConfig(lr=3e-3, warmup_steps=20), remat_policy="none")
        batch_fn = make_batch_fn(data, 16)

        half = args.steps // 2
        log(f"== phase 1: steps 0..{half} (with checkpoints) ==")
        _, _, first = train(cfg, tcfg, TrainerConfig(steps=half, ckpt_every=max(1, min(50, half)), ckpt_dir=args.ckpt,
                                                     log_every=20), mesh, batch_fn, device=device)  # fmt: skip
        log(f"== phase 2: resume from checkpoint -> step {args.steps} ==")
        _, _, hist = train(cfg, tcfg, TrainerConfig(steps=args.steps, ckpt_every=100, ckpt_dir=args.ckpt,
                                                    log_every=20), mesh, batch_fn, device=device)  # fmt: skip
        log(f"final loss: {hist[-1]['loss']:.4f}")
        return {"first": [h["loss"] for h in first], "resumed": [h["loss"] for h in hist]}
    finally:
        if joined and is_distributed():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
