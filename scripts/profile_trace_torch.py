#!/usr/bin/env python3
"""Where a simulated cycle of the port's trace executor goes on the card.

    PYTHONPATH=src python3 scripts/profile_trace_torch.py [--clusters 8192]
        [--sfr 32] [--iters 2] [--sweep 1,64,1024,8192]

Needs an NVIDIA GPU.  It builds ``--clusters`` eight-core clusters of the
``sw`` barrier microbenchmark (``--iters`` barriers a core after an SFR of
``--sfr`` cycles), each on its own 16 banks as in ``chip_smoke.py``'s trace
phase, and runs them in one ``run_traces_torch`` call (a block of cycles as
one captured CUDA graph) under ``torch.profiler``.  It prints the wall time
of the replays (host clock), the device's busy time (the sum of kernel
times, the copies of set-up apart) and idle share, the kernels a simulated
cycle, and the kernels by device time, in µs a cycle.  Then, without the profiler, µs a cycle at each
cluster count of ``--sweep``: flat if launches set the pace, growing with
the lanes if the bytes do.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import TRACE_BANKS, TRACE_CORES, relocate_cluster  # noqa: E402
from repro_torch.compat import card_name_and_power_limit  # noqa: E402
from repro_torch.core.scu.programs import trace_barrier_programs  # noqa: E402
from repro_torch.core.scu.trace_exec import run_traces_torch  # noqa: E402


def batch(n_clusters: int, sfr: int, iters: int) -> list:
    template = trace_barrier_programs("sw", TRACE_CORES, sfr=sfr, iters=iters)
    return [p for c in range(n_clusters) for p in relocate_cluster(template, c, n_clusters, TRACE_BANKS)]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clusters", type=int, default=8192)
    ap.add_argument("--sfr", type=int, default=32)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--sweep", default="1,64,1024,8192")
    args = ap.parse_args()
    card = card_name_and_power_limit()
    print(card)
    lanes = args.clusters * TRACE_CORES
    programs = batch(args.clusters, args.sfr, args.iters)
    run_traces_torch(batch(1, args.sfr, 1), n_banks=TRACE_BANKS)  # warm-up: CUDA context, allocator
    stats = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = run_traces_torch(programs, n_banks=TRACE_BANKS * args.clusters, stats=stats)
    cycles = got["cycles"]
    # rows of the device itself only: a host op's row repeats its kernels' time.  The copies
    # (the tables' upload, the results' download) are set-up, not the cycle's work
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    copies = [e for e in device if e.key.startswith("Memcpy") or e.key.startswith("Memset")]
    kernels = sorted((e for e in device if e not in copies), key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in kernels)
    copy_us = sum(e.self_device_time_total for e in copies)
    launches = sum(e.count for e in kernels)
    run_us = stats["run_s"] * 1e6
    print(f"[profile] {card}: {args.clusters} clusters ({lanes} lanes), sw barrier x {args.iters} after an SFR of "
          f"{args.sfr}: {cycles} cycles in {stats['replays']} replays of K = {stats['block_cycles']}; replays "
          f"{run_us / cycles:.1f} us a cycle (host clock, profiler on), kernels busy {busy_us / cycles:.1f} us a "
          f"cycle, idle share {max(0.0, 1 - busy_us / run_us):.2f}; {launches / cycles:.1f} kernels a cycle "
          f"(the capture's warm-up cycle included), {busy_us / launches:.2f} us a kernel; copies {copy_us:.0f} us "
          f"in all (set-up); capture {stats['capture_s']:.2f} s")
    for e in kernels[:16]:
        print(f"   {e.self_device_time_total / cycles:8.2f} us a cycle  {e.count / cycles:6.1f} a cycle  "
              f"{e.key[:100]}")
    for n_clusters in (int(x) for x in args.sweep.split(",")):
        stats = {}
        got = run_traces_torch(batch(n_clusters, args.sfr, args.iters), n_banks=TRACE_BANKS * n_clusters,
                               stats=stats)  # fmt: skip
        print(f"[sweep] {card}: {n_clusters:5d} clusters ({n_clusters * TRACE_CORES:6d} lanes): "
              f"{stats['run_s'] / got['cycles'] * 1e6:8.1f} us a cycle, {got['cycles']} cycles, "
              f"capture {stats['capture_s']:.2f} s")


if __name__ == "__main__":
    main()
