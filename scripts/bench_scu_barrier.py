#!/usr/bin/env python3
"""Times the port's SCU barrier kernel (K3) on the card beside its latency floor.

    PYTHONPATH=src python3 scripts/bench_scu_barrier.py [--parties 2 8 64 128 1024] [--repeats 3]
        [--sweep-parties 8]

Needs an NVIDIA GPU and ``nvcc``.  K3 moves a few words, so its floor is not
bytes but latency: ``ceil(log2 n)`` one-way flag hand-offs between two SMs
plus one kernel launch.  Both are measured here: the hand-off with a two-CTA
ping-pong that waits as K3 waits (``scu_pingpong``), the launch with an empty
cooperative kernel of ``n`` one-warp CTAs (``scu_empty``).  Each is repeated
to show its spread.  Then K3 at each ``n`` (and at the largest resident
group), beside its floor, its plain version and one PyTorch call for the
same function (a sum over the party axis, expanded).

The times above are back-to-back calls, timed with CUDA events: where a call
costs the host more than the card, they are host times.  So the script then
reads the card's own time of each kernel from ``torch.profiler`` (mean
device time of a launch) beside the host's time of a call; and it traces
one pass of the barrier sweep (``repro_torch.launch.barriers``) at regions 1
and 64 under every policy: the card's busy time, the wall time and the idle
share.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.compat import card_name_and_power_limit
from repro_torch.kernels.scu_barrier import kernel as scu
from repro_torch.kernels.scu_barrier.ref import barrier_ref
from repro_torch.launch import barriers
from repro_torch.sync import available_policies, get_policy

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import time_ms  # noqa: E402


def traced(fn, iters: int):
    """Runs ``fn`` ``iters`` times under the profiler; returns (wall s, {kernel name: (launches, device us)})."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {e.key: (e.count, e.self_device_time_total) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}  # fmt: skip
    return wall, kernels


def device_us_per_launch(fn, name: str, iters: int = 500) -> float:
    """Mean device time of one launch of the kernel whose name contains ``name``."""
    _, kernels = traced(fn, iters)
    hits = [(c, t) for key, (c, t) in kernels.items() if name in key]
    if not hits:
        raise SystemExit(f"the profiler saw no kernel named like {name!r}: {sorted(kernels)}")
    return sum(t for _, t in hits) / sum(c for c, _ in hits)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parties", type=int, nargs="+", default=[2, 8, 64, 128, 1024])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--sweep-parties", type=int, default=8)
    args = ap.parse_args()

    print(card_name_and_power_limit())
    scu.build()
    most = scu.max_parties(0)
    handoffs = [scu.handoff_ms() for _ in range(args.repeats)]
    print("one-way hand-off between two SMs (ping-pong of 20,000 round trips): "
          + ", ".join(f"{h * 1e3:.3f}" for h in handoffs) + " us")
    handoff = min(handoffs)
    for n in args.parties + [most]:
        launches = [scu.launch_ms(n) for _ in range(args.repeats)]
        rounds = (n - 1).bit_length()
        floor = rounds * handoff + min(launches)
        arrive = torch.randint(0, 50, (n,), device="cuda").float()
        if not torch.equal(scu.scu_barrier(arrive), barrier_ref(arrive)):
            raise SystemExit(f"scu_barrier disagrees with barrier_ref at n={n}")
        kernel = [time_ms(lambda: scu.scu_barrier(arrive), iters=2000, warmup=20) for _ in range(args.repeats)]
        plain = time_ms(lambda: barrier_ref(arrive), iters=2000, warmup=20)
        library = time_ms(lambda: arrive.sum(0, keepdim=True).expand_as(arrive), iters=2000, warmup=20)
        print(f"n={n:5d} ({rounds:2d} rounds): kernel " + ", ".join(f"{k * 1e3:.2f}" for k in kernel)
              + f" us; floor {floor * 1e3:.2f} us = {rounds} x {handoff * 1e3:.3f} + launch "
              + ", ".join(f"{x * 1e3:.2f}" for x in launches)
              + f" us; plain {plain * 1e3:.2f} us; library (sum + expand) {library * 1e3:.2f} us")
    device_times(args.sweep_parties)
    sweep_idle_share(args.sweep_parties)


def device_times(sweep_parties: int) -> None:
    n = sweep_parties
    cases = [
        ("scu_barrier", f"n={n}", "barrier_kernel", lambda: scu.scu_barrier(torch.ones(n, device="cuda"))),
        ("scu_barrier", "n=4224", "barrier_kernel", lambda: scu.scu_barrier(torch.ones(4224, device="cuda"))),
        ("scu_notifier", f"n={n}", "notifier_kernel", lambda: scu.scu_notifier(torch.ones(n, 1, device="cuda"), 0)),
        ("scu_self_signal", f"{n} floats", "self_signal_kernel",
         lambda: scu.scu_self_signal(torch.zeros(n, device="cuda"))),
        ("scu_self_signal", "2^20 floats", "self_signal_kernel",
         lambda: scu.scu_self_signal(torch.zeros(2**20, device="cuda"))),
    ]  # fmt: skip
    for name, shape, kernel, fn in cases:
        dev = device_us_per_launch(fn, kernel)
        host = time_ms(fn, iters=500, warmup=5) * 1e3
        print(f"{name} at {shape}: device {dev:.2f} us a launch (profiler); a call, input made in it, "
              f"back to back {host:.2f} us (CUDA events)")


def sweep_idle_share(parties: int) -> None:
    """One pass of the barrier sweep under the profiler, per policy and region."""
    x = torch.ones((parties, 8, barriers.DIM), device="cuda")
    a = torch.eye(barriers.DIM, device="cuda") * 0.99
    arrive = torch.ones(parties, device="cuda")
    for region in (1, 64):
        for name in available_policies():
            policy = get_policy(name)
            wall, kernels = traced(lambda: barriers.barrier_pass(x, a, region, barriers.N_BARRIERS, policy, arrive), 3)
            busy = sum(t for _, t in kernels.values()) / 1e6
            launches = sum(c for c, _ in kernels.values()) / 3
            print(f"sweep n={parties} region {region:2d} {name:8s}: wall {wall / 3 * 1e3:.3f} ms a pass, "
                  f"device busy {busy / 3 * 1e3:.3f} ms, idle share {1 - busy / wall:.3f}, "
                  f"{launches:.0f} kernels a pass")


if __name__ == "__main__":
    main()
