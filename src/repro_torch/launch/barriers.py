"""Chip-level barrier disciplines: wall clock of (compute region + barrier) loops.

    PYTHONPATH=src python -m repro_torch.launch.barriers [--parties 8] [--device cpu]

Counterpart of ``benchmarks/jax_barriers.py`` (the paper's Fig. 5 at chip
granularity), step for step: ``n`` parties, each with an ``(8, 128)`` f32
slab, sit on a stacked leading axis on one device (``x`` is ``(n, 8,
128)``); a compute region is ``region`` repeats of ``x = tanh(x @ a)`` with
``a = 0.99 I``, batched over the parties; after each region every party
meets ``get_policy(name).chip_barrier`` and the released count is folded
into ``x`` as ``x + cnt * 0``.  For every registered policy and region size
it reports the time per (region + barrier) and the overhead against the
compute-only time of the same region.  On the card the ``scu`` policy's
barrier is the SCU barrier kernel (K3), launched once a barrier, and the
times are CUDA events around the loop; on the CPU (``--device cpu``, for
the tests) they are the host clock.

Each policy's run also goes through the other two SCU kernels once, as the
SCU's event path does: every party's arrival word is its own event, raised
and consumed by the self-signal (K5: ``0 + 1``), and after the timed passes
every party reports the count it was released with to party 0 through the
notifier (K4), so party 0 holds the ``n - 1`` other counts.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.compat import resolve_device, synchronize
from repro_torch.kernels.scu_barrier import ops as scu_ops
from repro_torch.sync import available_policies, get_policy

__all__ = ["DIM", "N_BARRIERS", "REGION_SIZES", "barrier_pass", "run", "main"]

REGION_SIZES = [1, 2, 4, 8, 16, 32, 64]  # matmul repetitions between barriers
N_BARRIERS = 16
DIM = 128
AXIS = "x"


def barrier_pass(x, a, region: int, n_barriers: int, policy, arrive):
    """One timed pass: ``n_barriers`` x (region matmuls + barrier).  Returns
    the slabs and the last released count; ``policy=None`` is compute only."""
    cnt = None
    for _ in range(n_barriers):
        for _ in range(region):
            x = torch.tanh(x @ a)
        if policy is not None:
            cnt = policy.chip_barrier(arrive, AXIS)
            x = x + cnt.reshape(-1, 1, 1) * 0  # keep the barrier on the path
    return x, cnt


def _time(fn, device: torch.device, reps: int) -> float:
    """Seconds a call of ``fn`` takes, after one warm-up call."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    synchronize(device)
    return (time.perf_counter() - t0) / reps


def run(
    parties: int = 8,
    device: str = "cuda",
    regions: Sequence[int] = REGION_SIZES,
    n_barriers: int = N_BARRIERS,
    dim: int = DIM,
    reps: int = 5,
    verbose: bool = True,
) -> Dict:
    """The sweep.  Returns ``{"parties", "device", "passes", "curves", "counts",
    "notified"}``: ``curves[policy]`` is a list of ``(region, us per
    barrier, overhead)``; ``counts[policy]`` the count every party was
    released with in the last pass (each must be ``parties``);
    ``notified[policy]`` what the notifier delivered to party 0 (the sum of
    the other parties' counts); ``passes`` how many passes of every region
    ran under each policy (one warm-up and ``reps`` timed)."""
    dev = resolve_device(device)
    regions = list(regions)
    names = available_policies()
    x = torch.ones((parties, 8, dim), dtype=torch.float32, device=dev)
    a = torch.eye(dim, dtype=torch.float32, device=dev) * 0.99

    results: Dict = {"parties": parties, "device": str(dev), "passes": 1 + reps,
                     "curves": {}, "counts": {}, "notified": {}}  # fmt: skip
    # reference: compute-only time per region unit, at the largest region
    t_full = _time(lambda: barrier_pass(x, a, max(regions), n_barriers, None, None), dev, reps)
    unit = t_full / (n_barriers * max(regions))

    for name in names:
        policy = get_policy(name)
        # every party raises its own arrival event and consumes it (K5)
        arrive = scu_ops.self_signal(torch.zeros(parties, dtype=torch.float32, device=dev))
        last = {}
        curve: List = []
        for region in regions:

            def one_pass(region=region):
                last["cnt"] = barrier_pass(x, a, region, n_barriers, policy, arrive)[1]

            t = _time(one_pass, dev, reps)
            t_ideal = unit * n_barriers * region
            curve.append((region, t / n_barriers * 1e6, (t - t_ideal) / t_ideal))
        cnt = last["cnt"]
        # every party reports the count it was released with to party 0 (K4)
        notified = scu_ops.notifier(cnt.reshape(parties, 1), AXIS, 0)
        results["curves"][name] = curve
        results["counts"][name] = cnt.cpu().tolist()
        results["notified"][name] = notified[0, 0].item()

    if verbose:
        print(f"\n== Chip-level barrier disciplines ({parties} parties on {dev}) ==")
        print("region  " + "".join(f"{s:>10s}" for s in names))
        for i, region in enumerate(regions):
            row = [results["curves"][s][i][2] for s in names]
            print(f"{region:6d}  " + "".join(f"{o * 100:9.0f}%" for o in row))
        for s in names:
            print(f"  {s}: {results['curves'][s][0][1]:.2f} us per barrier at region={regions[0]}")
    return results


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parties", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    return run(parties=args.parties, device=args.device)


if __name__ == "__main__":
    main()
