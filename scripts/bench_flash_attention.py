#!/usr/bin/env python3
"""Times the port's flash-attention kernel on the card, beside one SDPA call and its bound.

    PYTHONPATH=src python3 scripts/bench_flash_attention.py [--batch 4] [--heads 24]
        [--kv-heads 8] [--seq 4096] [--head-dim 128] [--v-head-dim D]
        [--other path/to/other.cu] [--rounds 1] [--backward]

Needs an NVIDIA GPU and ``nvcc``.  Inputs are bf16, causal, in the models'
``(b, s, h, d)`` layout, as the serving path gives them to the kernel; q and
k rows are ``--head-dim`` wide, v rows ``--v-head-dim`` (default: the same).  With
``--other`` a second CUDA source with the same C interface (an earlier
version of the kernel, say) is built too, checked against the same plain
version, and timed in turns with the checkout's: other, this, this, other,
``--rounds`` times over (each build's median too where that is more than
once).  One SDPA call, the yardstick, takes its turns beside the builds
(SDPA's backward with ``--backward``).  Each build's error against the
plain version is printed as its largest absolute error and as the error's
norm over the plain version's (``rel``), an output at a time.  Each time is printed with its rate and its
share of the bound's rate.  To hold the kernel against an earlier commit's
source:

    git show <commit>:src/repro_torch/kernels/flash_attention/csrc/flash_attention_fwd.cu > build/k1_old.cu
    PYTHONPATH=src python3 scripts/bench_flash_attention.py --other build/k1_old.cu

At deepseek-v2-lite's MLA prefill (qk 192, v 128) and stablelm-3b's (d = 80):

    PYTHONPATH=src python3 scripts/bench_flash_attention.py --heads 16 --kv-heads 16 --head-dim 192 --v-head-dim 128 --other build/k1_old.cu
    PYTHONPATH=src python3 scripts/bench_flash_attention.py --heads 32 --kv-heads 32 --head-dim 80 --other build/k1_old.cu

``--backward`` does the same for the backward kernel (``flash_attention_bwd.cu``;
``--other`` then names a backward source): checked against its plain
version (``ops.attention_bwd``), timed in turns with SDPA's backward
beside its bound (the function's five products, 2.5x the forward's), with
the device time of each of its launches from the profiler.  phi4's training shape:

    PYTHONPATH=src python3 scripts/bench_flash_attention.py --backward --batch 1 --other build/k1b_old.cu
"""

from __future__ import annotations

import argparse
import statistics
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.compat import card_name_and_power_limit
from repro_torch.hardware import PEAK_FLOPS
from repro_torch.kernels.costs import attention_flops
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ops import attention_bwd
from repro_torch.kernels.flash_attention.ref import attention_ref

PEAK_BF16_FLOPS = PEAK_FLOPS["bfloat16"]  # NVIDIA H100 SXM data sheet, dense


def time_ms(fn, iters=30, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--heads", type=int, default=24)
    ap.add_argument("--kv-heads", type=int, default=8)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--v-head-dim", type=int, default=None, help="v's head dim (default: --head-dim)")
    ap.add_argument("--other", type=Path, default=None)
    ap.add_argument("--rounds", type=int, default=1, help="times the order of builds is run")
    ap.add_argument("--backward", action="store_true", help="time the backward kernel instead")
    args = ap.parse_args()

    b, h, kvh, s, d = args.batch, args.heads, args.kv_heads, args.seq, args.head_dim
    dv = d if args.v_head_dim is None else args.v_head_dim
    gen = torch.Generator(device="cuda").manual_seed(0)
    draw = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = draw(b, s, h, d), draw(b, s, kvh, d), draw(b, s, kvh, dv)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    flops = attention_flops(b, h, s, s, d, dv, True) * (2.5 if args.backward else 1)
    bound_ms = flops / PEAK_BF16_FLOPS * 1e3
    print(card_name_and_power_limit())
    dims = f"d={d}" if dv == d else f"dqk={d} dv={dv}"
    path = (flash_kernel.kernel_bwd_path if args.backward else flash_kernel.kernel_path)(torch.bfloat16, d, dv)
    print(f"b={b} h={h} kvh={kvh} s={s} {dims} bf16 causal, {'backward, ' if args.backward else ''}{path} "
          f"path; bound {bound_ms:.3f} ms by operations")

    if args.backward:
        out, lse = flash_kernel.flash_attention_fwd(qt, kt, vt, causal=True)
        dout = draw(b, s, h, dv)
        refs = [g.float() for g in attention_bwd(q, k, v, out.transpose(1, 2), lse, dout, causal=True)]

        def kernel():
            return [g.transpose(1, 2) for g in flash_kernel.flash_attention_bwd(qt, kt, vt, out, lse,
                                                                               dout.transpose(1, 2), causal=True)]
    else:
        # a sequence at a time: the float32 scores of all b at command-r's 96 heads would take 26 GB
        refs = [torch.cat([attention_ref(qt[i : i + 1], kt[i : i + 1], vt[i : i + 1], causal=True).float()
                           for i in range(b)])]  # fmt: skip

        def kernel():
            return [flash_kernel.flash_attention_fwd(qt, kt, vt, causal=True)[0]]

    attr = "build_bwd" if args.backward else "build"
    this_build = getattr(flash_kernel, attr)
    builds = {"this": this_build}
    if args.other is not None:
        other = args.other.resolve()  # once: no file system call a launch
        builds["other"] = lambda: this_build(other)

    def run(which):
        setattr(flash_kernel, attr, builds[which])  # the binding looks its build up at each call
        try:
            return kernel()
        finally:
            setattr(flash_kernel, attr, this_build)

    for which in builds:
        for got, ref in zip(run(which), refs):
            err = (got.float() - ref).abs().max().item()
            rel = ((got.float() - ref).norm() / ref.norm()).item()
            print(f"{which:5s}: max_abs_err {err:.3e} rel {rel:.3e} against the plain version")
            if err > 2e-2 * max(1.0, ref.abs().max().item()):
                raise SystemExit("the kernel disagrees with its plain version")

    timed = {which: (lambda which=which: run(which)) for which in builds}
    # SDPA (its backward with --backward), the yardstick, takes its turns beside the builds
    try:
        if args.backward:
            leaves = [x.detach().clone().requires_grad_(True) for x in (qt, kt, vt)]
            ref_out = F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)
            timed["sdpa"] = lambda: torch.autograd.grad(ref_out, leaves, dout.transpose(1, 2), retain_graph=True)
        else:
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
            timed["sdpa"] = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    except RuntimeError as refused:
        print(f"library: SDPA refuses this call: {str(refused).splitlines()[0]}")
    names = [n for n in timed if n != "this"]
    order = names + ["this", "this"] + names[::-1] if names else ["this", "this"]

    def report(name, ms):
        print(f"{name}: {ms:.3f} ms  {flops / ms / 1e9:.1f} TFLOP/s  {bound_ms / ms * 100:.1f} % of the bound's rate")

    times = {which: [] for which in timed}
    for _ in range(args.rounds):
        for which in order:
            times[which].append(time_ms(timed[which]))
            report(f"{which:5s}", times[which][-1])
    if args.rounds > 1:
        for which, got in times.items():
            report(f"{which:5s} median of {len(got)}", statistics.median(got))
    if args.backward:
        # the device time of each build's kernels, a launch (free of the host's share of a call)
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        for which in builds:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    run(which)
                torch.cuda.synchronize()
            for e in prof.key_averages():
                if e.device_type == DeviceType.CUDA:
                    print(f"  {which:5s} device {e.self_device_time_total / 1e3 / e.count:.3f} ms a launch, "
                          f"x{e.count}: {e.key[:100]}")


if __name__ == "__main__":
    main()
