"""Per-job idle-vs-spin energy split for the sweep service.

Own copy of ``repro/serve/energy.py`` (the port imports nothing of
``repro``), line for line.

The paper's central energy contrast is *how losers wait*: hardware-assisted
disciplines clock-gate the cores that lost the race (cheap ``gated``
cycles), software spin-locks keep them clocked and hammering the TCDM
(expensive ``wait`` cycles plus interconnect traffic).  This helper projects
one job's :class:`~repro_torch.core.scu.engine.ClusterStats` onto exactly that
axis so ``benchmarks/traffic.py`` can report **tail energy per
discipline** -- p99 spin energy of a ``tas`` mix vs an ``scu`` mix -- not
just averages.

The coefficients come from the calibrated cluster model
(:data:`repro_torch.core.scu.energy.DEFAULT_ENERGY`); this module only groups its
terms, it does not introduce new ones, so ``idle_pj + spin_pj + compute_pj
+ baseline_pj == EnergyModel.energy_pj`` exactly (asserted in tests).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.scu.energy import DEFAULT_ENERGY, Activity, EnergyModel
from repro_torch.core.scu.engine import ClusterStats

__all__ = ["JobEnergy", "job_energy"]


@dataclasses.dataclass(frozen=True)
class JobEnergy:
    """One job's energy, grouped by how its cycles were spent (pJ).

    idle_pj
        Clock-gated loser cycles (``e_gate * gated``) -- what waiting costs
        under the SCU disciplines.
    spin_pj
        Clocked-but-held cycles plus TCDM traffic (``e_wait * wait +
        e_mem * tcdm``) -- what waiting costs when losers poll shared
        memory.  TCDM accesses of the payload itself land here too; for
        the synchronization microbenchmarks the traffic is overwhelmingly
        spin polls, which is the contrast we report.
    compute_pj
        Actual work: ``e_comp * comp + e_scu * scu``.
    baseline_pj
        Cluster-wide static + clock-tree floor: ``e_static * cycles``.
    """

    idle_pj: float
    spin_pj: float
    compute_pj: float
    baseline_pj: float

    @property
    def total_pj(self) -> float:
        return self.idle_pj + self.spin_pj + self.compute_pj + self.baseline_pj

    @property
    def wait_pj(self) -> float:
        """Everything spent *not* making progress (idle + spin)."""
        return self.idle_pj + self.spin_pj


def job_energy(
    stats: ClusterStats, model: EnergyModel = DEFAULT_ENERGY
) -> JobEnergy:
    """Split one finished job's stats into the idle/spin/compute/static axes.

    The four components are a regrouping of ``model.energy_pj`` -- they sum
    to it exactly, so fleet-level totals can be compared across disciplines
    without double counting.
    """
    act = Activity.from_stats(stats)
    return JobEnergy(
        idle_pj=model.e_gate * act.gated,
        spin_pj=model.e_wait * act.wait + model.e_mem * act.tcdm,
        compute_pj=model.e_comp * act.comp + model.e_scu * act.scu,
        baseline_pj=model.e_static * act.cycles,
    )
