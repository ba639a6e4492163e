"""Quickstart of the PyTorch port: build a small model, run a forward pass,
train ten steps (``--steps``).  The twin of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu]

It runs on the mesh the run has: ``{"data": 1, "model": 1}`` on one card
(or on the CPU with ``--device cpu``), or ``{"data": 2, "model": 2}`` when
launched as four processes:

    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        examples/quickstart_torch.py --device cpu

The JAX quickstart runs on four XLA host devices of one process instead.
"""

import argparse

import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_smoke_config, list_archs
from repro_torch.launch.mesh import device_mesh, make_host_mesh
from repro_torch.models.lm import init_lm, lm_forward
from repro_torch.parallel.dist import is_distributed, join_if_launched
from repro_torch.train.data import SyntheticLM, make_batch_fn
from repro_torch.train.loop import TrainerConfig, train
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import TrainConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    device, joined = join_if_launched(args.device)
    lead = not is_distributed() or dist.get_rank() == 0
    log = print if lead else (lambda *a, **k: None)
    try:
        log("available architectures:", ", ".join(list_archs()))
        cfg = get_smoke_config("qwen3-moe-30b-a3b")  # MoE family, reduced size
        log(f"\nusing {cfg.name}: {cfg.n_layers}L d={cfg.d_model} experts={cfg.moe.n_experts} top-{cfg.moe.top_k}")

        params = init_lm(torch.Generator(device=device).manual_seed(0), cfg)
        tokens = torch.zeros((2, 32), dtype=torch.int32, device=device)
        with torch.no_grad():
            hidden = lm_forward(params, cfg, tokens=tokens)
        log("forward:", tuple(hidden.shape), hidden.dtype, "on", hidden.device)

        n = dist.get_world_size() if is_distributed() else 1
        model = 2 if n >= 4 else 1
        mesh = make_host_mesh(data=n // model, model=model, device=device)
        log("mesh:", mesh)
        if is_distributed():
            mesh = device_mesh(mesh, device)
        data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32, seed=0)
        tcfg = TrainConfig(opt=OptConfig(lr=1e-2, warmup_steps=5), remat_policy="none")
        _, _, hist = train(cfg, tcfg, TrainerConfig(steps=args.steps, log_every=2, ckpt_every=10**9), mesh,
                           make_batch_fn(data, 8), device=device)  # fmt: skip
        log(f"\nloss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} over {args.steps} steps")
        return {"hidden_shape": tuple(hidden.shape), "losses": [h["loss"] for h in hist]}
    finally:
        if joined and is_distributed():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
