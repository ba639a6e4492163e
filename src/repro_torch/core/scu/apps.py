"""Workload models of the paper's nine DSP applications (Table 2 / Fig. 6).

Own copy of ``repro/core/scu/apps.py`` (the port imports nothing of
``repro``), line for line; the policies come from ``repro_torch.sync``.
``tests/test_torch_sim_apps.py`` holds every ``AppResult`` field to the
reference's.

Each application is modelled as the parallel *synchronization skeleton* the
paper describes in Sec. 6.4: a sequence of parallel sections (SFRs) separated
by barriers, with per-core workload imbalance and sequential phases where
applicable.  The skeleton parameters (barrier count, mean SFR size, imbalance,
sequential fraction) are taken from Table 2 and the per-application
descriptions; the arithmetic inside an SFR is abstracted as ``Compute``
cycles (the synchronization behaviour -- the paper's subject -- is simulated
exactly, on the same engine and primitives as the microbenchmarks).

This lets us reproduce the paper's application-level claims: performance
improvements up to ~92% / 23% on average, energy up to ~98% / 39% on
average, with the largest gains for the small-SFR, high-imbalance apps
(Dijkstra, Livermore6, PCA) and the smallest for the large-SFR ones
(AES, FFT).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from .energy import DEFAULT_ENERGY, Activity, EnergyModel
from .engine import Cluster, Compute
from .primitives import DEFAULT_COSTS
from .scu_unit import SCU

__all__ = ["AppModel", "APPS", "PIPELINED_APPS", "run_app", "run_app_pipelined", "AppResult"]


@dataclasses.dataclass(frozen=True)
class AppModel:
    """Synchronization skeleton of one application (Table 2 row).

    ``barriers``     -- number of barriers over the whole run.
    ``sfr``          -- mean synchronization-free region size in cycles.
    ``imbalance``    -- per-core relative stddev of each section's work
                        (lognormal-ish jitter; Table 2 'active (stddev)').
    ``seq_fraction`` -- fraction of sections where only one core works
                        (sequential phases, e.g. PCA's diagonalization).
    """

    name: str
    domain: str
    barriers: int
    sfr: int
    imbalance: float
    seq_fraction: float = 0.0


# Parameters from Table 2 (barrier count, SFR size) and Sec. 6.4 app
# descriptions (imbalance from the active-cycle stddev / mean; sequential
# fractions from the narratives).
APPS: Dict[str, AppModel] = {
    "dwt": AppModel("dwt", "signal processing", 10, 1050, 0.03),
    "dijkstra": AppModel("dijkstra", "graph search", 238, 110, 0.12, 0.05),
    "aes": AppModel("aes", "cryptography", 4, 10200, 0.005),
    "livermore6": AppModel("livermore6", "linear recurrence", 127, 104, 0.55),
    "livermore2": AppModel("livermore2", "gradient descent", 12, 744, 0.015),
    "fft": AppModel("fft", "frequency analysis", 4, 1480, 0.015),
    "fann": AppModel("fann", "machine learning", 160, 545, 0.03),
    "mfcc": AppModel("mfcc", "audio processing", 693, 725, 0.05),
    "pca": AppModel("pca", "data analysis", 2305, 375, 0.65, 0.30),
}


@dataclasses.dataclass
class AppResult:
    app: str
    variant: str
    cycles: int
    active_cycles: float  # mean over cores
    active_stddev: float
    energy_uj: float
    power_mw: float
    sync_total: float  # mean per-core cycles inside sync primitives (incl. wait)
    sync_active: float  # mean per-core *active* cycles inside sync primitives
    breakdown: Dict[str, float]


def _section_lengths(app: AppModel, n_cores: int, seed: int) -> np.ndarray:
    """(barriers, n_cores) per-core compute lengths between barriers."""
    rng = np.random.default_rng(seed)
    base = rng.normal(app.sfr, app.imbalance * app.sfr, size=(app.barriers, n_cores))
    base = np.maximum(1, base).astype(np.int64)
    if app.seq_fraction > 0:
        seq_rows = rng.random(app.barriers) < app.seq_fraction
        # sequential phase: core 0 does the combined work, others idle-wait
        base[seq_rows, 0] = np.maximum(1, base[seq_rows].sum(axis=1) // 2)
        base[seq_rows, 1:] = 1
    return base


def run_app(
    app: AppModel,
    variant: str,
    n_cores: int = 8,
    seed: int = 0,
    energy_model: EnergyModel = DEFAULT_ENERGY,
    mode: str = "fastforward",
) -> AppResult:
    """Run one application skeleton under one synchronization variant
    (any registered ``repro_torch.sync`` policy).  ``mode`` selects the engine
    (event-driven fast path by default; ``"lockstep"`` for the reference)."""
    from repro_torch.sync import get_policy  # deferred: repro_torch.sync imports this pkg

    policy = get_policy(variant)
    sections = _section_lengths(app, n_cores, seed)
    scu = SCU(n_cores=n_cores)
    cl = Cluster(n_cores=n_cores, scu=scu, mode=mode)
    sync_state = policy.make_sim_state(n_cores)

    # Track per-core sync cycles by sampling core state inside primitives.
    sync_marks: List[List[Tuple[int, int]]] = [[] for _ in range(n_cores)]

    def program(cluster, cid):
        for b in range(app.barriers):
            yield Compute(int(sections[b, cid]))
            t0 = cluster.cycle
            a0 = cluster.cores[cid].stats.active_cycles if cluster.cores else 0
            yield from policy.sim_barrier(cluster, cid, sync_state, DEFAULT_COSTS)
            a1 = cluster.cores[cid].stats.active_cycles
            sync_marks[cid].append((cluster.cycle - t0, a1 - a0))

    cl.load([program] * n_cores)
    st = cl.run(max_cycles=200_000_000)

    actives = np.array([c.active_cycles for c in st.cores], dtype=np.float64)
    sync_total = float(np.mean([sum(t for t, _ in m) for m in sync_marks]))
    sync_active = float(np.mean([sum(a for _, a in m) for m in sync_marks]))
    return _make_app_result(
        app, variant, st, actives, sync_total, sync_active,
        float(sections.sum()), energy_model,
    )


def _make_app_result(
    app: AppModel, variant: str, st, actives, sync_total, sync_active,
    app_comp_cycles: float, energy_model: EnergyModel,
) -> AppResult:
    # The compute sections are DSP work (MAC/SIMD + memory traffic), not the
    # nop/spin mix the base coefficients describe -- charge the difference.
    act = Activity.from_stats(st)
    adj_pj = energy_model.app_energy_adjustment_pj(app_comp_cycles)
    energy_pj = energy_model.energy_pj(act) + adj_pj
    breakdown = energy_model.breakdown_pj(act)
    breakdown["cores_active"] += adj_pj
    return AppResult(
        app=app.name,
        variant=variant,
        cycles=st.cycles,
        active_cycles=float(actives.mean()),
        active_stddev=float(actives.std()),
        energy_uj=energy_pj / 1e6,
        power_mw=energy_pj / st.cycles * 1e-12 * 350e6 * 1e3 if st.cycles else 0.0,
        sync_total=sync_total,
        sync_active=sync_active,
        breakdown=breakdown,
    )


# Apps whose structure is a natural stage pipeline (streaming items through
# per-core processing stages) -- the shape the SCU's event FIFO targets.
# mfcc is the canonical one: audio frames stream through framing / FFT /
# mel-filterbank / DCT stages.
PIPELINED_APPS = ("mfcc",)


def run_app_pipelined(
    app: AppModel,
    variant: str,
    n_cores: int = 8,
    seed: int = 0,
    depth: int = 8,
    energy_model: EnergyModel = DEFAULT_ENERGY,
    mode: str = "fastforward",
) -> AppResult:
    """Pipelined variant of an application skeleton (one stage per core).

    The app's per-barrier-interval work matrix is reinterpreted as ``items x
    stages``: interval ``b``'s per-core workloads become the per-stage costs
    of item ``b`` flowing through the pipeline.  Policies with a native
    ``make_pipeline_programs`` hook (the ``fifo`` discipline) overlap the
    stages through credit-bounded event queues; every other policy runs the
    barrier-synchronous emulation, paying one global barrier per pipeline
    tick.  ``sync_total``/``sync_active`` report the per-core overhead over
    the pure per-stage work (everything that is not the item's compute).
    """
    from repro_torch.sync import get_policy  # deferred: repro_torch.sync imports this pkg

    from .programs import make_pipeline_programs

    policy = get_policy(variant)
    sections = _section_lengths(app, n_cores, seed)
    cl = Cluster(n_cores=n_cores, scu=SCU(n_cores=n_cores), mode=mode)
    state = policy.make_sim_state(n_cores)
    cl.load(make_pipeline_programs(
        policy, cl, n_cores, sections.tolist(), state, DEFAULT_COSTS, depth
    ))
    st = cl.run(max_cycles=200_000_000)

    actives = np.array([c.active_cycles for c in st.cores], dtype=np.float64)
    stage_work = sections.sum(axis=0).astype(np.float64)  # per-core item work
    sync_total = float(np.mean(st.cycles - stage_work))
    sync_active = float(np.mean(actives - stage_work))
    return _make_app_result(
        app, variant, st, actives, sync_total, sync_active,
        float(sections.sum()), energy_model,
    )
