#!/usr/bin/env python3
"""Times the port's SSD-scan kernel on the card, beside its plain version and its bound.

    PYTHONPATH=src python3 scripts/bench_ssd_scan.py [--batch 4] [--seq 4096]
        [--heads 64] [--head-dim 64] [--state 128] [--chunk 256] [--other path/to/other.cu]
        [--forms 1,2,4,8]

Needs an NVIDIA GPU and ``nvcc``.  Inputs are the serving path's: x, B, C
bf16, dt f32, in the models' ``(b, s, h, p)`` layout.  It prints the form
``scan_form`` picks (the CTAs a (batch, head)) and the kernel's time in it.
With ``--other`` a second CUDA source with the C interface of this one or of
the one-block-per-(batch, head) kernel before it is built too, checked
against the same plain version, and timed in turns with the checkout's:
other, this, this, other.  To hold the kernel against an earlier commit's:

    git show <commit>:src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_fwd.cu > build/k2_old.cu
    PYTHONPATH=src python3 scripts/bench_ssd_scan.py --other build/k2_old.cu

With ``--forms`` the checkout's kernel is also checked and timed at each of
those cluster sizes (cut to the tiles and the card's cluster limit), in
turns: each form once from the smallest, then once from the largest.

TFLOP/s count the products of the chunked form (``ssd_flops``) at the chunk
each kernel walks: the checkout's bf16 kernel its own tile of 64 whatever
chunk is named, the earlier one the chunk named.  The bound is the same for
both: the larger of the bytes and the products at the tile of 64.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.compat import card_name_and_power_limit
from repro_torch.kernels._build import load_library
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import ssd_bound, ssd_flops, time_ms  # noqa: E402

def bind_other(source: Path):
    """The entry point of another source, called as this checkout's is.  An
    earlier source without the ``cluster`` argument (one block per (batch,
    head)) is bound here, its call dropping that argument."""
    lib = load_library("ssd_scan_fwd", [source])
    if hasattr(lib, "ssd_scan_cluster_limit"):
        return ssd_kernel.build(source)
    fn = lib.ssd_scan_fwd
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr] * 8 + [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_longlong), ptr]
    fn.restype = ctypes.c_int
    return lambda *args: fn(*args[:15], *args[16:])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--heads", type=int, default=64)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--state", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--other", type=Path, default=None)
    ap.add_argument("--forms", type=str, default="")
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
    tile = ssd_kernel.TILE
    bound_ms, bound_by = ssd_bound(b, s, h, p, n, tile, "bfloat16")
    flops = {"this": ssd_flops(b, s, h, p, n, tile), "other": ssd_flops(b, s, h, p, n, chunk)}
    limit = ssd_kernel.cluster_limit(p, n, 0)
    form = ssd_kernel.scan_form(b, h, s, chunk, p, n, limit)
    print(card_name_and_power_limit())
    print(f"b={b} s={s} h={h} p={p} n={n} chunk={chunk}, x B C bf16, dt f32: {flops['this'] / 1e9:.1f} GFLOP "
          f"at the tile of {tile}, {flops['other'] / 1e9:.1f} at chunk {chunk}; bound {bound_ms:.4f} ms by "
          f"{bound_by}; cluster limit {limit}, form {form.name} ({form.cluster} CTAs a (batch, head), at most "
          f"{form.tiles} tiles of {tile} a CTA)")

    this_build = ssd_kernel.build
    builds = {"this": this_build}
    if args.other is not None:
        other = bind_other(args.other.resolve())
        builds["other"] = lambda: other

    def run(which, cluster=None):
        ssd_kernel.build = builds[which]  # the binding looks `build` up at each call
        try:
            return ssd_kernel._scan(x, dt, A, B, C, chunk, None, cluster)
        finally:
            ssd_kernel.build = this_build

    def check(label, y, st):
        torch.cuda.synchronize()
        err = (y.float() - ry).abs().max().item()
        st_err = (st - rst).abs().max().item()
        print(f"{label}: max_abs_err y {err:.3e} (max |y| {ry.abs().max().item():.3f}), final_state {st_err:.3e}")
        if err > 3e-2 * max(1.0, ry.abs().max().item()) or st_err > 3e-4 * max(1.0, rst.abs().max().item()):
            raise SystemExit("the kernel disagrees with its plain version")

    def timed(label, fn, work):
        ms = time_ms(fn, iters=30, warmup=3)
        print(f"{label}: {ms:.3f} ms  {work / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.3f} of the bound")

    for which in ("this", "other"):
        if which in builds:
            check(f"{which:5s}", *run(which))

    order = ["other", "this", "this", "other"] if args.other is not None else ["this", "this"]
    for which in order:
        timed(f"{which:5s}", lambda: run(which), flops[which])

    tiles = -(-s // ssd_kernel.TILE)
    forms = sorted({min(int(k), tiles, limit) for k in args.forms.split(",") if k})
    for k in forms:
        check(f"cluster {k:2d}", *run("this", k))
    for k in forms + forms[::-1]:
        timed(f"cluster {k:2d}", lambda: run("this", k), flops["this"])
    plain_ms = time_ms(lambda: ssd_scan_ref(x, dt, A, B, C, chunk=chunk), iters=3, warmup=1)
    print(f"plain (ssd_chunked): {plain_ms:.3f} ms")


if __name__ == "__main__":
    main()
