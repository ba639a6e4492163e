#!/usr/bin/env python3
"""Times the port's SSD-scan kernel on the card, beside its plain version and its bound.

    PYTHONPATH=src python3 scripts/bench_ssd_scan.py [--batch 4] [--seq 4096]
        [--heads 64] [--head-dim 64] [--state 128] [--chunk 256] [--other path/to/other.cu]

Needs an NVIDIA GPU and ``nvcc``.  Inputs are the serving path's: x, B, C
bf16, dt f32, in the models' ``(b, s, h, p)`` layout.  With ``--other`` a
second CUDA source with the same C interface (an earlier version of the
kernel, say) is built too, checked against the same plain version, and timed
in turns with the checkout's: other, this, this, other.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.compat import card_name_and_power_limit
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import ssd_bound, ssd_flops, time_ms  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--heads", type=int, default=64)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--state", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--other", type=Path, default=None)
    args = ap.parse_args()

    b, s, h, p, n, chunk = args.batch, args.seq, args.heads, args.head_dim, args.state, args.chunk
    gen = torch.Generator(device="cuda").manual_seed(0)
    draw = lambda *shape, scale=1.0: torch.randn(shape, generator=gen, device="cuda") * scale
    x = draw(b, s, h, p, scale=0.5).to(torch.bfloat16)
    dt = F.softplus(draw(b, s, h))
    A = -torch.exp(draw(h, scale=0.3))
    B = draw(b, s, n, scale=0.3).to(torch.bfloat16)
    C = draw(b, s, n, scale=0.3).to(torch.bfloat16)
    ry, rst = ssd_scan_ref(x.float(), dt, A, B.float(), C.float(), chunk=chunk)
    bound_ms, bound_by = ssd_bound(b, s, h, p, n, chunk, "bfloat16")
    flops = ssd_flops(b, s, h, p, n, chunk)
    print(card_name_and_power_limit())
    print(f"b={b} s={s} h={h} p={p} n={n} chunk={chunk}, x B C bf16, dt f32: {flops / 1e9:.1f} GFLOP; "
          f"bound {bound_ms:.4f} ms by {bound_by}")

    this_build = ssd_kernel.build
    builds = {"this": this_build}
    if args.other is not None:
        builds["other"] = lambda: this_build(args.other.resolve())

    def run(which):
        ssd_kernel.build = builds[which]  # the binding looks `build` up at each call
        try:
            return ssd_kernel.ssd_scan_fwd(x, dt, A, B, C, chunk=chunk)
        finally:
            ssd_kernel.build = this_build

    for which in builds:
        y, st = run(which)
        err = (y.float() - ry).abs().max().item()
        st_err = (st - rst).abs().max().item()
        print(f"{which:5s}: max_abs_err y {err:.3e} (max |y| {ry.abs().max().item():.3f}), final_state {st_err:.3e}")
        if err > 3e-2 * max(1.0, ry.abs().max().item()) or st_err > 3e-4 * max(1.0, rst.abs().max().item()):
            raise SystemExit("the kernel disagrees with its plain version")

    order = ["other", "this", "this", "other"] if args.other is not None else ["this", "this"]
    for which in order:
        ms = time_ms(lambda: run(which), iters=30, warmup=3)
        print(f"{which:5s}: {ms:.3f} ms  {flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.3f} of the bound")
    plain_ms = time_ms(lambda: ssd_scan_ref(x, dt, A, B, C, chunk=chunk), iters=3, warmup=1)
    print(f"plain (ssd_chunked): {plain_ms:.3f} ms")


if __name__ == "__main__":
    main()
