"""Seedable arrival traces for the sweep service (deterministic, offline).

Own copy of ``repro/serve/arrivals.py`` (the port imports nothing of
``repro``), line for line: the same draws from the same seed.

Arrival times are **scheduler rounds** of the slot fleet, not wall-clock or
simulated cycles: one round is one call to ``SlotFleet.advance()``, the
machine-independent time axis every latency number in ``fleet_service`` and
``benchmarks/traffic.py`` is quoted on.  Traces are non-decreasing integer
sequences; two jobs may share a round (a burst lands at once).

Both generators are pure functions of their arguments -- same seed, same
trace, on any machine -- so benchmark artifacts and tests stay
reproducible without recording traces on disk.
"""

from __future__ import annotations

from typing import List

import numpy as np

__all__ = ["poisson_trace", "bursty_trace"]


def poisson_trace(rate: float, n_jobs: int, seed: int) -> List[int]:
    """Poisson arrivals: i.i.d. exponential gaps with mean ``1/rate`` rounds.

    ``rate`` is jobs per scheduler round (e.g. 0.02 = one job every 50
    rounds on average).  Gaps are floored, so high rates degenerate into
    same-round batches -- exactly the stress the service should absorb.
    """
    if rate <= 0:
        raise ValueError(f"poisson_trace: rate must be > 0, got {rate}")
    if n_jobs < 0:
        raise ValueError(f"poisson_trace: n_jobs must be >= 0, got {n_jobs}")
    rng = np.random.default_rng(seed)
    gaps = np.floor(rng.exponential(1.0 / rate, size=n_jobs)).astype(np.int64)
    return np.cumsum(gaps).tolist()


def bursty_trace(
    n_bursts: int,
    burst_size: int,
    gap_rounds: int,
    seed: int,
    jitter: int = 0,
) -> List[int]:
    """Bursty arrivals: ``n_bursts`` bursts of ``burst_size`` jobs, bursts
    ``gap_rounds`` apart, each job's arrival jittered by up to ``jitter``
    rounds (uniform, per job).

    This is the adversarial pattern for fixed-batch dispatch: a burst wider
    than the fleet forces queueing, and the long inter-burst gap is where a
    drain-the-fleet baseline leaves lanes idle while stragglers finish.
    """
    if n_bursts < 0 or burst_size < 0:
        raise ValueError("bursty_trace: n_bursts/burst_size must be >= 0")
    if gap_rounds < 0 or jitter < 0:
        raise ValueError("bursty_trace: gap_rounds/jitter must be >= 0")
    rng = np.random.default_rng(seed)
    times: List[int] = []
    for b in range(n_bursts):
        base = b * gap_rounds
        for _ in range(burst_size):
            j = int(rng.integers(0, jitter + 1)) if jitter else 0
            times.append(base + j)
    times.sort()
    return times
