#!/usr/bin/env python3
"""Reads the port's flash-attention forward (K1's Hopper kernel) by phase on the card.

    PYTHONPATH=src python3 scripts/probe_flash_fwd.py [--source path/to/flash_attention_fwd.cu]
        [--heads 24/8,56/8,96/8] [--batch 4] [--seq 4096] [--head-dim 128] [--rounds 3]

Needs an NVIDIA GPU and ``nvcc``.  The source (by default the checkout's) is
built three ways under ``build/k1_probe/``:

- as it is;
- in its load-only form (``K1_LOAD_ONLY``): the same items on the same grid,
  the same TMA loads of Q, K and V through the same ring of stages, and
  consumers that wait for each tile and release it, with no products;
- with its phase marks defined (``K1_MARK``): the first thread of every
  role of every CTA adds the ``clock64`` cycles between two marks to a
  counter of the phase that the second mark closes.

For each ``h/kvh`` of ``--heads`` (bf16, causal, the models' ``(b, s, h, d)``
layout) the first two are timed in turns (as is, load-only, load-only, as
is; ``--rounds`` times) and the marked build is run once, then each role's
cycles are printed by phase as shares of that role's.  The producer's phases:
waiting for Q's stage to be free, issuing Q, waiting for a K or V stage to be
free, issuing K and V (and the rest of its loop).  The consumers' phases:
between items, an item's head (Q, S_0 and its softmax), waiting for a K or V
tile, the loop's products and softmax, the tail (the last P V), the
epilogue.  If the load-only sweep takes most of the kernel's time, the loads
set its pace; if the consumers spend their time outside the loop, the items'
heads and tails do.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
from pathlib import Path

import torch

from repro_torch.compat import card_name_and_power_limit
from repro_torch.hardware import PEAK_FLOPS
from repro_torch.kernels import _build
from repro_torch.kernels.costs import attention_flops
from repro_torch.kernels.flash_attention import kernel as flash_kernel

ROLES = ("producer", "consumer 0", "consumer 1")
PHASES = {
    "producer": ("wait for Q's stage", "issue Q", "wait for a K/V stage", "issue K/V, the rest"),
    "consumer": ("between items", "head: Q, S_0, softmax", "wait for a K/V tile", "loop: products, softmax",
                 "tail: last P V", "epilogue"),
}
MARKS = """\
__device__ unsigned long long k1_probe_cycles[3][8];
#define K1_MARKS_BEGIN const bool k1_me_ = (threadIdx.x & 127) == 0; unsigned k1_acc_[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}; unsigned k1_last_ = (unsigned)clock64();
#define K1_MARK(phase) do { if (k1_me_) { const unsigned now_ = (unsigned)clock64(); k1_acc_[phase] += now_ - k1_last_; k1_last_ = now_; } } while (0)
#define K1_MARKS_END(role) if (k1_me_) { for (int i_ = 0; i_ < 8; ++i_) atomicAdd(&k1_probe_cycles[role][i_], (unsigned long long)k1_acc_[i_]); }
"""
READOUT = """
extern "C" int k1_probe_read(unsigned long long* out) {
    return (int)cudaMemcpyFromSymbol(out, k1_probe_cycles, sizeof(k1_probe_cycles));
}
extern "C" int k1_probe_reset() {
    static const unsigned long long zero[3][8] = {};
    return (int)cudaMemcpyToSymbol(k1_probe_cycles, zero, sizeof(zero));
}
"""


def time_ms(fn, iters=20, warmup=3):
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


def variant(source: Path, name: str, prelude: str, tail: str = "") -> Path:
    """The source with ``prelude`` before it and ``tail`` after, written under build/k1_probe/."""
    out = _build.build_dir().parent / "k1_probe" / f"{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(prelude + source.read_text() + tail)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", type=Path, default=flash_kernel._SOURCE)
    ap.add_argument("--heads", default="24/8,56/8,96/8", help="h/kvh pairs, comma-separated")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    source = args.source.resolve()
    builds = {
        "as is": variant(source, "as_is", ""),
        "load-only": variant(source, "load_only", "#define K1_LOAD_ONLY true\n"),
        "marked": variant(source, "marked", MARKS, READOUT),
    }
    this_build = flash_kernel.build
    print(card_name_and_power_limit())
    print(f"source {source}")
    b, s, d = args.batch, args.seq, args.head_dim
    gen = torch.Generator(device="cuda").manual_seed(0)
    for pair in args.heads.split(","):
        h, kvh = (int(x) for x in pair.split("/"))
        q, k, v = (torch.randn((b, s, n, d), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)
                   for n in (h, kvh, kvh))  # fmt: skip
        flops = attention_flops(b, h, s, s, d, d, True)
        bound_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3

        def run(which):
            flash_kernel.build = lambda: this_build(builds[which])
            try:
                return flash_kernel.flash_attention_fwd(q, k, v, causal=True)
            finally:
                flash_kernel.build = this_build

        print(f"b={b} h={h} kvh={kvh} s={s} d={d} bf16 causal; bound {bound_ms:.3f} ms by operations")
        times = {"as is": [], "load-only": []}
        for _ in range(args.rounds):
            for which in ("as is", "load-only", "load-only", "as is"):
                times[which].append(time_ms(lambda: run(which)))
        for which, got in times.items():
            print(f"  {which:9s}: median {statistics.median(got):.3f} ms of {len(got)} "
                  f"({min(got):.3f}-{max(got):.3f})")
        share = statistics.median(times["load-only"]) / statistics.median(times["as is"])
        print(f"  the load-only sweep takes {share * 100:.1f} % of the kernel's time")

        marked_ms = time_ms(lambda: run("marked"))  # the marks' cost
        lib = _build.load_library("flash_attention_fwd", [builds["marked"]])
        lib.k1_probe_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
        torch.cuda.synchronize()
        assert lib.k1_probe_reset() == 0
        run("marked")
        torch.cuda.synchronize()
        counts = (ctypes.c_ulonglong * 24)()
        assert lib.k1_probe_read(counts) == 0
        print(f"  marked build: {marked_ms:.3f} ms a launch; one launch read")
        for r, role in enumerate(ROLES):
            names = PHASES[role.split()[0]]
            cycles = [counts[8 * r + i] for i in range(len(names))]
            total = sum(cycles) or 1
            parts = ", ".join(f"{name} {c / total * 100:.1f} %" for name, c in zip(names, cycles))
            print(f"  {role}: {total / 1e6:.1f} Mcycles over its CTAs; {parts}")


if __name__ == "__main__":
    main()
