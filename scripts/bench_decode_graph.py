#!/usr/bin/env python3
"""The decode graph's step of two source trees, timed in turns on one card.

    python3 scripts/bench_decode_graph.py --other PARENT/src [--arch mamba2-1.3b]
        [--layers N] [--batch 4] [--prompt-len 4096] [--steps 32] [--rounds 3]

Needs an NVIDIA GPU.  One worker process a tree (``src/`` beside this script,
and ``--other``), each with that tree first on its path: it draws the model
in bf16 from seed 0 (``--layers`` cuts the depth), prefills a batch of
random prompts, stages the cache and captures the decode step as one CUDA
graph (``capture_serve_step``), as ``chip_smoke.py``'s ``[graph]`` phase
does.  Both stay resident; the workers then time ``--steps`` replays in
turns, this tree, the other, the other, this tree, ``--rounds`` times,
each block on the host clock around the replays and a synchronise (ms a
step, as ``[graph]`` reports it), with the host's own share: the time until
the last replay is queued.  Prints the card's name and power limit, each
block's times and the medians.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent / "src"


def worker(arch: str, layers, batch: int, prompt_len: int, steps: int) -> None:
    """Draw, prefill and capture; then answer each line of stdin with one
    timed block of ``steps`` replays, as a JSON line."""
    import dataclasses
    import time

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import make_inputs, stage_prefill_cache
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.decode import CausalLM, capture_serve_step

    dev = torch.device("cuda")
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = CausalLM(cfg, init_lm(torch.Generator(device=dev).manual_seed(0), cfg, torch.bfloat16))
    inputs = make_inputs(cfg, batch, prompt_len, torch.Generator(device=dev).manual_seed(1))
    logits, small = model.prefill(inputs)
    first = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    cache = stage_prefill_cache(small, model.init_cache(batch, prompt_len + steps), prompt_len)
    del logits, small
    start = torch.full((batch,), prompt_len, dtype=torch.int32, device=dev)
    step = capture_serve_step(cfg, model.params, cache, batch)
    torch.cuda.synchronize()
    print(json.dumps({"ready": str(Path(sys.modules["repro_torch"].__file__).parent.parent)}), flush=True)
    for _ in sys.stdin:
        step.feed(first, start)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step.replay()
        queued = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(json.dumps({"ms": wall / steps * 1e3, "host_ms": queued / steps * 1e3}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, required=True, help="the other tree's src/ directory")
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--layers", type=int, default=None, help="serve only this many layers (default: all)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.arch, args.layers, args.batch, args.prompt_len, args.steps)
        return

    import torch

    sys.path.insert(0, str(HERE))
    from repro_torch.compat import card_name_and_power_limit

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(card_name_and_power_limit())
    trees = {"this": HERE, "other": args.other.resolve()}
    argv = [sys.executable, __file__, "--worker", "--other", str(args.other), "--arch", args.arch,
            "--batch", str(args.batch), "--prompt-len", str(args.prompt_len), "--steps", str(args.steps)]
    if args.layers is not None:
        argv += ["--layers", str(args.layers)]
    procs = {}
    try:
        for name, src in trees.items():  # one at a time: each builds its own kernels
            env = dict(os.environ, PYTHONPATH=str(src))
            procs[name] = subprocess.Popen(argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env, text=True)
            ready = json.loads(procs[name].stdout.readline())
            if Path(ready["ready"]).resolve() != src:
                raise SystemExit(f"the {name} worker imported repro_torch from {ready['ready']}, not {src}")
        times = {name: [] for name in trees}
        for _ in range(args.rounds):
            for name in ("this", "other", "other", "this"):
                procs[name].stdin.write("go\n")
                procs[name].stdin.flush()
                times[name].append(json.loads(procs[name].stdout.readline()))
        depth = f"{args.layers} layers" if args.layers is not None else "all layers"
        print(f"{args.arch} ({depth}), batch {args.batch}, prompt {args.prompt_len}, graph decode, ms a step over "
              f"{args.steps} replays (host clock), in turns this, other, other, this x{args.rounds}:")
        for name, src in trees.items():
            ms = [t["ms"] for t in times[name]]
            host = [t["host_ms"] for t in times[name]]
            print(f"  {name} ({src}): {[round(t, 3) for t in ms]}; median {statistics.median(ms):.3f} ms; host "
                  f"time to queue the replays, median {statistics.median(host):.3f} ms a step")
        a, b = (statistics.median(t["ms"] for t in times[name]) for name in trees)
        print(f"this / other: {a / b:.4f}")
    finally:
        for p in procs.values():
            try:
                p.stdin.close()
                p.wait(timeout=60)
            except (OSError, subprocess.TimeoutExpired):
                p.kill()


if __name__ == "__main__":
    main()
