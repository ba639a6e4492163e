"""Health-aware multi-fleet routing over correlated fault domains.

Own copy of ``repro/serve/fleet_pool.py`` (the port imports nothing of
``repro``), line for line, over the port's ``FleetService``.

One level above :class:`repro_torch.serve.fleet_service.FleetService`: a
:class:`FleetPool` manages N :class:`~repro_torch.core.scu.engine.SlotFleet`\\ s
as independent **fault domains** -- the serving analogue of the voltage
islands / cluster groups that :mod:`repro_torch.core.scu.faults` models with its
domain-scoped events (correlated droop, SCU blackout, domain-wide bank
blackout).  A fault that takes out one domain takes out every slot in it at
once, so recovery must be *topological*: re-route the work somewhere else
and stop feeding the sick domain, instead of retrying into the blast
radius.

Router
------
New jobs are placed onto a domain at submit time by a pluggable policy
(``placement``):

``least-loaded``
    the admissible domain with the smallest load (queued + in-flight
    jobs), ties broken by higher health score then lower domain id.
``round-robin``
    cycles through the admissible domains in index order.

Admissible means *healthy* domains when any exist, else *probation*
domains, else every domain (all quarantined -- jobs queue and wait out the
cooldown; a job already queued on a domain that is quarantined later also
waits, by design: placement is FIFO per domain and never reshuffles).
Every queue is per-domain FIFO, so rerouted retries join the tail of their
new domain and never jump fresh submissions there.

Health + circuit breaker
------------------------
Each domain carries a :class:`DomainHealth` record: a rolling window of
attempt outcomes plus running totals of watchdog trips, terminal failures
and wasted cycles.  An optional :class:`BreakerPolicy` drives a
deterministic, round-counted state machine per domain::

      healthy --(>= probation_after failures in window)--> probation
    probation --(any failure)--> quarantined        [cooldown_rounds]
    probation --(probe_successes consecutive successes)--> healthy
  quarantined --(cooldown elapsed)--> probation     [probe admissions]

``probation`` is probe mode: at most one job in flight, so a still-sick
domain burns one probe per window instead of a full fleet of jobs.
``quarantined`` admits nothing until the cooldown expires.  All
transitions happen at round boundaries from round-counted state -- no
wall-clock anywhere -- so a pool run is bit-reproducible.

Watchdog escalation
-------------------
The chain is slot -> domain -> router: a cluster-level watchdog first
force-releases parked waiters (slot-level recovery, invisible up here);
a hard trip surfaces as the member's ``DeadlockError`` whose
``"watchdog tripped"`` message carries the :class:`WaitForGraph` dump.
The pool records the trip against the domain's health (``fault_log``
entries carry ``"domain"`` blame), and the breaker escalates the domain to
quarantine -- the domain-level trip the ROADMAP's multi-cluster item
calls for.

Reroute vs retry
----------------
With ``RetryPolicy(reroute=True)`` a failed attempt is resubmitted to a
*different healthy* domain when one exists (counted in
:attr:`FleetPool.reroutes`); otherwise -- and always with
``reroute=False`` -- it retries in place on the same domain.  Backoff,
degradation (``degrade_after`` + ``fallback_factory``) and terminal
failure semantics are identical to :class:`FleetService`; the reroute
decision is made when the backoff expires, against the health state of
that round.

Live migration (reroute + :class:`CheckpointPolicy`)
----------------------------------------------------
With ``checkpoint=CheckpointPolicy(interval_rounds=k)`` every running
member is snapshotted each ``k`` rounds of its attempt (round boundary;
bit-exact, see :mod:`repro_torch.core.scu.checkpoint`).  A failed attempt that
has a checkpoint **migrates** instead of restarting: the retry resumes
from the checkpoint -- on whatever domain the reroute logic picks -- with
the failed attempt's :class:`~repro_torch.core.scu.faults.FaultPlan` stripped,
so the sick domain's remaining fault schedule does not follow the job to
its new home.  Wasted cycles per failure drop from the whole attempt to
the checkpoint -> failure tail (at most one interval plus the detection
lag).  Checkpoint-resumed admissions bypass the ``inject`` hook (the
chaos harness arms *fresh* attempts; a restore continues an old one).  A
checkpoint that backed one failed resume is dropped as poisoned -- it
captured already-corrupted state -- and the next retry rebuilds from
scratch.  Members running generator-backed programs are silently
non-checkpointable and keep restart-reroute semantics.  Migrations are
counted in :attr:`FleetPool.migrations` (a subset of ``reroutes`` when
the target differs from the failing domain).

Fault injection is tied to domains through the optional ``inject`` hook:
``inject(domain, config) -> config`` runs at admission for every attempt,
letting a chaos harness (``benchmarks/fault_domains.py``) arm
:class:`~repro_torch.core.scu.faults.FaultPlan`\\ s on the configs a particular
domain executes -- which is exactly why rerouting escapes them.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.core.scu.checkpoint import NotCheckpointable
from repro_torch.core.scu.engine import FleetConfig, SlotFleet
from repro_torch.serve.fleet_service import (
    CheckpointPolicy,
    QueueFull,
    RetryPolicy,
    SweepJob,
    _fresh_traces,
)

__all__ = ["DomainHealth", "BreakerPolicy", "FleetPool"]

HEALTHY, PROBATION, QUARANTINED = "healthy", "probation", "quarantined"


class DomainHealth:
    """Rolling health record for one fault domain.

    ``outcomes`` is a bounded window of recent attempt results (True =
    success); the running totals survive window eviction and feed the
    pool-level metrics.  ``score`` is the window success fraction (1.0
    while empty -- a fresh domain is presumed healthy)."""

    def __init__(self, window: int = 16):
        if window < 1:
            raise ValueError(f"health window must be >= 1, got {window}")
        self.window = window
        self.outcomes: Deque[bool] = deque(maxlen=window)
        self.watchdog_trips = 0
        self.terminal_failures = 0
        self.wasted_cycles = 0
        self.completed = 0
        self.failed_attempts = 0

    def record_success(self) -> None:
        self.outcomes.append(True)
        self.completed += 1

    def record_failure(self, wasted_cycles: int, watchdog: bool) -> None:
        self.outcomes.append(False)
        self.failed_attempts += 1
        self.wasted_cycles += wasted_cycles
        if watchdog:
            self.watchdog_trips += 1

    @property
    def score(self) -> float:
        if not self.outcomes:
            return 1.0
        return sum(self.outcomes) / len(self.outcomes)

    @property
    def window_failures(self) -> int:
        return len(self.outcomes) - sum(self.outcomes)


@dataclasses.dataclass(frozen=True)
class BreakerPolicy:
    """Deterministic circuit-breaker knobs for :class:`FleetPool`.

    ``probation_after`` window failures drop a healthy domain to
    probation; any failure on probation quarantines it for
    ``cooldown_rounds`` scheduler rounds, after which it re-enters
    probation (probe mode: one job in flight); ``probe_successes``
    consecutive successes restore it to healthy."""

    probation_after: int = 2
    cooldown_rounds: int = 8
    probe_successes: int = 2

    def __post_init__(self):
        if self.probation_after < 1:
            raise ValueError(
                f"probation_after must be >= 1, got {self.probation_after}"
            )
        if self.cooldown_rounds < 1:
            raise ValueError(
                f"cooldown_rounds must be >= 1, got {self.cooldown_rounds}"
            )
        if self.probe_successes < 1:
            raise ValueError(
                f"probe_successes must be >= 1, got {self.probe_successes}"
            )


class FleetPool:
    """N slot fleets as fault domains behind one health-aware router.

    Parameters
    ----------
    n_domains:
        Number of fault domains (independent :class:`SlotFleet`\\ s).
    n_slots, slot_cores, banking_factor:
        Per-domain fleet geometry (uniform across domains).
    queue_limit:
        Global bound over the sum of the per-domain queues; a full pool
        **rejects** (:class:`QueueFull`) exactly like
        :class:`FleetService`.  Retry requeues bypass the bound -- a
        retried job already owns its place in the system.
    placement:
        ``"least-loaded"`` (default) or ``"round-robin"``; see the module
        docstring.
    retry:
        Optional :class:`RetryPolicy`; ``reroute=True`` makes failed
        attempts prefer a different healthy domain.
    breaker:
        Optional :class:`BreakerPolicy`; ``None`` disables quarantine
        (every domain stays ``healthy`` forever, health is still scored).
    health_window:
        Rolling-outcome window per :class:`DomainHealth`.
    inject:
        Optional ``inject(domain, config) -> config`` hook applied at
        admission to every attempt (chaos harness entry point;
        checkpoint-restored admissions skip it).
    checkpoint:
        Optional :class:`~repro_torch.serve.fleet_service.CheckpointPolicy`;
        enables periodic snapshots and live migration (see the module
        docstring).
    """

    PLACEMENTS = ("least-loaded", "round-robin")

    def __init__(
        self,
        n_domains: int,
        n_slots: int,
        slot_cores: int,
        banking_factor: int = 2,
        queue_limit: int = 64,
        placement: str = "least-loaded",
        retry: Optional[RetryPolicy] = None,
        breaker: Optional[BreakerPolicy] = None,
        health_window: int = 16,
        inject: Optional[Callable[[int, FleetConfig], FleetConfig]] = None,
        checkpoint: Optional[CheckpointPolicy] = None,
    ):
        if n_domains < 1:
            raise ValueError(f"n_domains must be >= 1, got {n_domains}")
        if placement not in self.PLACEMENTS:
            raise ValueError(
                f"placement must be one of {self.PLACEMENTS}, got {placement!r}"
            )
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        self.n_domains = n_domains
        self.fleets = [
            SlotFleet(n_slots, slot_cores, banking_factor)
            for _ in range(n_domains)
        ]
        self.queues: List[Deque[SweepJob]] = [deque() for _ in range(n_domains)]
        self.health = [DomainHealth(health_window) for _ in range(n_domains)]
        self.states = [HEALTHY] * n_domains
        self.queue_limit = queue_limit
        self.placement = placement
        self.retry = retry
        self.breaker = breaker
        self.inject = inject
        self.checkpoint = checkpoint
        self.round = 0
        self.finished: List[SweepJob] = []
        self.reroutes = 0
        self.quarantines = 0
        self.migrations = 0  # checkpoint-resumed reroutes to a new domain
        self._cooldown_until = [0] * n_domains
        self._probe_streak = [0] * n_domains
        self._by_slot: List[Dict[int, SweepJob]] = [
            {} for _ in range(n_domains)
        ]
        self._backoff: List[Tuple[int, SweepJob]] = []
        self._rr = 0
        self._next_id = 0
        self.lane_rounds = 0
        self.busy_lane_rounds = 0

    # ------------------------------------------------------------------ api
    def submit(
        self,
        config: Optional[FleetConfig] = None,
        *,
        factory: Optional[Callable[[int], FleetConfig]] = None,
        fallback_factory: Optional[Callable[[int], FleetConfig]] = None,
    ) -> SweepJob:
        """Enqueue a job onto a routed domain; raises :class:`QueueFull`
        when the global queue bound is hit and ``ValueError`` on a config
        no fleet could admit.  Same config/factory contract as
        :meth:`FleetService.submit`."""
        if (config is None) == (factory is None):
            raise ValueError("submit: pass exactly one of config or factory")
        if config is None:
            config = _fresh_traces(factory(1))
        self.fleets[0].validate(config)
        if sum(len(q) for q in self.queues) >= self.queue_limit:
            raise QueueFull(
                f"pool queue full ({self.queue_limit} jobs waiting); "
                "retry after a step() or raise queue_limit"
            )
        job = SweepJob(
            self._next_id, config, submitted_round=self.round,
            factory=factory, fallback_factory=fallback_factory,
        )
        self._next_id += 1
        self._enqueue(job, self._place())
        return job

    def try_submit(self, config: FleetConfig) -> Optional[SweepJob]:
        """Non-raising :meth:`submit`: ``None`` instead of
        :class:`QueueFull` (invalid configs still raise ``ValueError``)."""
        try:
            return self.submit(config)
        except QueueFull:
            return None

    def step(self) -> List[SweepJob]:
        """One pool round: expire quarantine cooldowns, re-queue
        backoff-expired retries (rerouting them if asked), admit per
        domain, advance every occupied fleet, collect completions and
        update domain health/breaker state.  Returns the jobs that went
        terminal this round."""
        if self.checkpoint is not None:
            self._checkpoint_pass()
        self._expire_cooldowns()
        self._requeue_backoff()
        for d in range(self.n_domains):
            self._admit(d)
        done: List[SweepJob] = []
        busy_lanes = 0
        for d in range(self.n_domains):
            fleet = self.fleets[d]
            finished_cores = 0
            if fleet.occupied:
                for m in fleet.advance():
                    finished_cores += m.cluster.n_cores
                    done.extend(self._collect(d, m))
            busy_lanes += sum(
                j.config.cluster.n_cores for j in self._by_slot[d].values()
            ) + finished_cores
        self.lane_rounds += sum(
            f.n_slots * f.slot_cores for f in self.fleets
        )
        self.busy_lane_rounds += busy_lanes
        self.round += 1
        return done

    def run_until_drained(self, max_rounds: int = 10_000_000) -> List[SweepJob]:
        """Step until every queue, the backoff list and every fleet are
        empty; quarantined domains drain too (their cooldowns are
        round-counted, so progress is guaranteed)."""
        out: List[SweepJob] = []
        rounds = 0
        while (
            any(self.queues) or self._backoff
            or any(f.occupied for f in self.fleets)
        ):
            out.extend(self.step())
            rounds += 1
            if rounds > max_rounds:
                raise RuntimeError(
                    f"run_until_drained: not drained after {max_rounds} rounds"
                )
        return out

    # ---------------------------------------------------------------- router
    def _admissible(self, exclude: Optional[int] = None) -> List[int]:
        """Domains the router may place onto, best tier first: healthy,
        else probation, else everything (all quarantined)."""
        for tier in (HEALTHY, PROBATION):
            ds = [
                d for d in range(self.n_domains)
                if self.states[d] == tier and d != exclude
            ]
            if ds:
                return ds
        return [d for d in range(self.n_domains) if d != exclude] or [exclude]

    def _place(self, exclude: Optional[int] = None) -> int:
        """Pick a target domain by the placement policy."""
        candidates = self._admissible(exclude)
        if self.placement == "round-robin":
            d = candidates[self._rr % len(candidates)]
            self._rr += 1
            return d
        # least-loaded: fewest queued+in-flight jobs, ties to the higher
        # health score, then the lower domain id -- fully deterministic
        return min(
            candidates,
            key=lambda d: (
                len(self.queues[d]) + len(self._by_slot[d]),
                -self.health[d].score,
                d,
            ),
        )

    def _enqueue(self, job: SweepJob, domain: int) -> None:
        job.domain = domain
        job.state = "queued"
        self.queues[domain].append(job)

    # ----------------------------------------------------------- checkpoints
    def _checkpoint_pass(self) -> None:
        """Periodic snapshots at the round boundary, per domain."""
        iv = self.checkpoint.interval_rounds
        for d in range(self.n_domains):
            fleet = self.fleets[d]
            for slot, job in sorted(self._by_slot[d].items()):
                if job.checkpoint_disabled:
                    continue
                age = self.round - job.attempt_admitted_round
                if age <= 0 or age % iv != 0:
                    continue
                m = fleet.members[slot]
                if m.cluster.cycle >= m.max_cycles:
                    continue  # burned to its cap: timeout imminent
                try:
                    job.checkpoint = fleet.snapshot(slot)
                except NotCheckpointable:
                    job.checkpoint_disabled = True
                else:
                    job.checkpoint_round = self.round

    def suspend_all(self) -> List[SweepJob]:
        """Checkpoint and evict every running member across all domains
        (pool restart) -- the per-domain analogue of
        :meth:`FleetService.suspend_all`.  Suspended jobs requeue on their
        own domain with ``faults="carry"`` and resume bit-exactly on
        subsequent :meth:`step` calls; non-checkpointable members restart
        via their factory or go terminal."""
        out: List[SweepJob] = []
        for d in range(self.n_domains):
            fleet = self.fleets[d]
            for slot in sorted(self._by_slot[d]):
                job = self._by_slot[d][slot]
                try:
                    job.checkpoint = fleet.suspend(slot)
                except NotCheckpointable:
                    job.checkpoint_disabled = True
                    m = fleet.members[slot]
                    job.wasted_cycles += m.cluster.cycle
                    self.health[d].wasted_cycles += m.cluster.cycle
                    m.done = True
                    fleet.free(slot)
                    job.restore_pending = False
                    factory = job.factory
                    if job.degraded and job.fallback_factory is not None:
                        factory = job.fallback_factory
                    if factory is None:
                        job.error = (
                            "suspended: generator-backed program is not "
                            "checkpointable and the job has no factory to "
                            "rebuild from"
                        )
                        job.state = "failed"
                        job.slot = None
                        job.finished_round = self.round
                        self.health[d].terminal_failures += 1
                        self.finished.append(job)
                        continue
                    job.config = _fresh_traces(factory(job.attempts + 1))
                else:
                    job.checkpoint_round = self.round
                    job.restore_pending = True
                    job.resume_faults = "carry"
                job.slot = None
                self._enqueue(job, d)
                out.append(job)
            self._by_slot[d].clear()
        return out

    # ------------------------------------------------------------- admission
    def _admit(self, d: int) -> None:
        if self.states[d] == QUARANTINED:
            return
        fleet, queue = self.fleets[d], self.queues[d]
        while queue and fleet.free_slots:
            if self.states[d] == PROBATION and self._by_slot[d]:
                return  # probe mode: one job in flight
            job = queue.popleft()
            if job.restore_pending and job.checkpoint is not None:
                # live migration / pool-restart resume: the checkpoint IS
                # the job state; the inject hook (fresh-attempt chaos)
                # does not apply
                slot = fleet.restore(job.checkpoint, faults=job.resume_faults)
                job.restore_pending = False
                if job.resume_faults is None:
                    job.resumed_attempt = True
            else:
                cfg = job.config
                if self.inject is not None:
                    cfg = self.inject(d, cfg)
                    job.config = cfg
                slot = fleet.admit(cfg)
                job.resumed_attempt = False
            job.slot = slot
            job.state = "running"
            job.admitted_round = self.round
            job.attempt_admitted_round = self.round
            self._by_slot[d][slot] = job

    # ------------------------------------------------------------ completion
    def _collect(self, d: int, m) -> List[SweepJob]:
        """Fold one finished fleet member into job + domain state."""
        job = self._by_slot[d].pop(m.index)
        job.attempts += 1
        self.fleets[d].free(m.index)
        if m.error is not None:
            watchdog = m.error.startswith("watchdog tripped")
            fail_cycle = m.cluster.cycle
            job.fault_log.append({
                "attempt": job.attempts,
                "round": self.round,
                "cycles": fail_cycle,
                "degraded": job.degraded,
                "domain": d,
                "watchdog": watchdog,
                "error": m.error.splitlines()[0],
            })
            retried = self._maybe_retry(job)
            # a checkpoint-resume redoes only the checkpoint -> failure
            # tail; a restart redoes the whole attempt
            resume_from = (
                job.checkpoint.cycle
                if retried and job.restore_pending else 0
            )
            waste = fail_cycle - resume_from
            job.wasted_cycles += waste
            self.health[d].record_failure(waste, watchdog)
            self._breaker_failure(d)
            if retried:
                return []
            job.error = m.error
            job.state = "failed"
            self.health[d].terminal_failures += 1
        else:
            job.state = "done"
            self.health[d].record_success()
            self._breaker_success(d)
        job.finished_round = self.round
        job.stats = m.cluster.stats
        self.finished.append(job)
        return [job]

    # --------------------------------------------------------------- breaker
    def _breaker_failure(self, d: int) -> None:
        b = self.breaker
        if b is None:
            return
        state = self.states[d]
        if state == PROBATION:
            self.states[d] = QUARANTINED
            self._cooldown_until[d] = self.round + 1 + b.cooldown_rounds
            self._probe_streak[d] = 0
            self.quarantines += 1
        elif (
            state == HEALTHY
            and self.health[d].window_failures >= b.probation_after
        ):
            self.states[d] = PROBATION
            self._probe_streak[d] = 0

    def _breaker_success(self, d: int) -> None:
        if self.breaker is None or self.states[d] != PROBATION:
            return
        self._probe_streak[d] += 1
        if self._probe_streak[d] >= self.breaker.probe_successes:
            self.states[d] = HEALTHY
            self._probe_streak[d] = 0

    def _expire_cooldowns(self) -> None:
        for d in range(self.n_domains):
            if (
                self.states[d] == QUARANTINED
                and self.round >= self._cooldown_until[d]
            ):
                self.states[d] = PROBATION
                self._probe_streak[d] = 0

    # --------------------------------------------------------------- recovery
    def _requeue_backoff(self) -> None:
        still: List[Tuple[int, SweepJob]] = []
        for eligible, job in self._backoff:
            if eligible > self.round:
                still.append((eligible, job))
                continue
            target = job.domain
            r = self.retry
            if r is not None and r.reroute:
                healthy_elsewhere = [
                    d for d in range(self.n_domains)
                    if self.states[d] == HEALTHY and d != job.domain
                ]
                if healthy_elsewhere:
                    target = self._place(exclude=job.domain)
                    if target != job.domain:
                        self.reroutes += 1
                        if job.restore_pending and job.checkpoint is not None:
                            # checkpoint rides along: live migration
                            self.migrations += 1
            self._enqueue(job, target)
        self._backoff = still

    def _maybe_retry(self, job: SweepJob) -> bool:
        """Identical backoff/degrade schedule to :class:`FleetService`;
        the reroute decision is deferred to requeue time.  Prefers
        resuming from the job's last checkpoint (faults stripped -- live
        migration when the reroute picks a new domain); a checkpoint that
        already backed one failed resume is poisoned and dropped."""
        r = self.retry
        if r is None or job.attempts >= r.max_attempts:
            return False
        if job.resumed_attempt:
            job.checkpoint = None
            job.checkpoint_round = None
        if job.checkpoint is not None:
            job.restore_pending = True
            job.resume_faults = None  # the sick domain's plan stays behind
        else:
            job.restore_pending = False
            cfg = self._next_config(job)
            if cfg is None:
                return False
            try:
                self.fleets[0].validate(cfg)
            except ValueError:
                return False
            job.config = cfg
        job.slot = None
        job.state = "backoff"
        delay = r.backoff_rounds * (r.backoff_factor ** (job.attempts - 1))
        self._backoff.append((self.round + 1 + delay, job))
        return True

    def _next_config(self, job: SweepJob) -> Optional[FleetConfig]:
        nxt = job.attempts + 1
        r = self.retry
        if (
            r.degrade_after is not None
            and job.attempts >= r.degrade_after
            and job.fallback_factory is not None
        ):
            job.degraded = True
            return _fresh_traces(job.fallback_factory(nxt))
        if job.factory is not None:
            return _fresh_traces(job.factory(nxt))
        return None

    # --------------------------------------------------------------- metrics
    @property
    def pending(self) -> int:
        return sum(len(q) for q in self.queues)

    @property
    def active(self) -> int:
        return sum(len(s) for s in self._by_slot)

    @property
    def idle_lane_fraction(self) -> float:
        if self.lane_rounds == 0:
            return 0.0
        return 1.0 - self.busy_lane_rounds / self.lane_rounds

    @property
    def watchdog_trips(self) -> int:
        return sum(h.watchdog_trips for h in self.health)

    @property
    def wasted_cycles(self) -> int:
        return sum(h.wasted_cycles for h in self.health)

    def domain_report(self) -> List[Dict]:
        """Deterministic per-domain health snapshot (benchmark surface)."""
        return [
            {
                "domain": d,
                "state": self.states[d],
                "score": self.health[d].score,
                "completed": self.health[d].completed,
                "failed_attempts": self.health[d].failed_attempts,
                "terminal_failures": self.health[d].terminal_failures,
                "watchdog_trips": self.health[d].watchdog_trips,
                "wasted_cycles": self.health[d].wasted_cycles,
            }
            for d in range(self.n_domains)
        ]
