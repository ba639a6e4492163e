#!/usr/bin/env python3
"""Where one prefill and a few decode steps of the PyTorch/CUDA port spend their time.

    PYTHONPATH=src python3 scripts/profile_serve_torch.py [--arch phi4-mini-3.8b]
        [--batch 4] [--prompt-len 4096] [--steps 8] [--layers N] [--out FILE]

Needs an NVIDIA GPU.  It draws random bf16 weights at the model's full width,
warms up, then traces one prefill and ``--steps`` decode steps with
``torch.profiler``, the decode steps both as the launcher runs them (replays
of the step captured as one CUDA graph, ``capture_serve_step``) and as the
eager step (``CausalLM.decode_step``), and prints, for each phase: the wall time (host clock
around a synchronised region), the device's busy time (the sum of kernel
times) and idle share, and the kernels by total device time.  Kernel names
are the device's own; ``flash_fwd_hopper`` is this repo's attention kernel
at head dims 64, 80 and 128 and at MLA's qk 192 / v 128 (``--arch
deepseek-v2-lite-16b``; ``flash_fwd_bf16`` at 16) and ``ssd_scan_bf16`` its
SSD-scan kernel (``--arch mamba2-1.3b``).  ``--layers`` cuts the depth, for a
model that does not fit the card whole (``--arch jamba-v0.1-52b --layers 8``:
one group of its 32 layers).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.compat import card_name_and_power_limit, resolve_device
from repro_torch.configs.registry import get_config
from repro_torch.launch.serve import make_inputs, stage_prefill_cache
from repro_torch.models.lm import init_lm
from repro_torch.serve.decode import CausalLM, capture_serve_step


def traced(name, fn, lines, top=14):
    """Run ``fn`` once under the profiler; report wall, device busy and the top kernels."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # rows of the device itself only: a host op's row repeats its kernels' time
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    lines.append(f"== {name}: wall {wall_ms:.2f} ms (with the profiler on), device busy {busy_ms:.2f} ms, "
                 f"idle share {max(0.0, 1 - busy_ms / wall_ms):.2f}")
    for e in kernels[:top]:
        lines.append(f"   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:110]}")
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--layers", type=int, default=None, help="serve only this many layers (default: all)")
    ap.add_argument("--out", type=Path, default=None, help="also write the report to this file")
    args = ap.parse_args()

    dev = resolve_device("cuda")
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = CausalLM(cfg, init_lm(torch.Generator(device=dev).manual_seed(0), cfg, torch.bfloat16))
    inputs = make_inputs(cfg, args.batch, args.prompt_len, torch.Generator(device=dev).manual_seed(1))
    max_seq = args.prompt_len + 2 * args.steps + 2
    lines = [card_name_and_power_limit(),
             f"{cfg.name} bf16, {cfg.n_layers} layers, batch {args.batch}, prompt {args.prompt_len}, "
             f"torch {torch.__version__}"]

    def decode(cache, tok, start, n):
        position = torch.full((args.batch,), start, dtype=torch.int32, device=dev)
        for i in range(n):
            tok, _logits, cache = model.decode_step(cache, tok[:, None], position + i)
        return tok

    def replay(step, tok, start, n):
        step.feed(tok[:, None], torch.full((args.batch,), start, dtype=torch.int32, device=dev))
        for _ in range(n):
            tok = step.replay()[0]
        return tok.clone()

    # warm up both phases (cuBLAS handles, kernel build), then time without the profiler
    logits, small = model.prefill(inputs)
    cache = stage_prefill_cache(small, model.init_cache(args.batch, max_seq), args.prompt_len)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    tok = decode(cache, tok, args.prompt_len, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(inputs)
    torch.cuda.synchronize()
    lines.append(f"prefill, profiler off: {(time.perf_counter() - t0) * 1e3:.2f} ms")
    t0 = time.perf_counter()
    tok = decode(cache, tok, args.prompt_len + 2, args.steps)
    torch.cuda.synchronize()
    lines.append(f"decode (eager), profiler off: {(time.perf_counter() - t0) * 1e3 / args.steps:.2f} ms/step")
    step = capture_serve_step(cfg, model.params, cache, args.batch)
    t0 = time.perf_counter()
    replay(step, tok, args.prompt_len + 2, args.steps)
    torch.cuda.synchronize()
    lines.append(f"decode (graph), profiler off: {(time.perf_counter() - t0) * 1e3 / args.steps:.2f} ms/step")

    traced("prefill", lambda: model.prefill(inputs), lines)
    start = args.prompt_len + 2 + args.steps
    traced(f"decode (graph) x{args.steps}", lambda: replay(step, tok, start, args.steps), lines)
    traced(f"decode (eager) x{args.steps}", lambda: decode(cache, tok, start, args.steps), lines)

    text = "\n".join(lines)
    print(text)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")


if __name__ == "__main__":
    main()
