"""Continuous-batching sweep service over the slot-recycling fleet engine.

Own copy of ``repro/serve/fleet_service.py`` (the port imports nothing of
``repro``), line for line, over the port's ``SlotFleet``.

The serving analogue of :class:`repro_torch.serve.batching.ContinuousBatcher`, one
level up: instead of token sequences in decode slots, the unit of work is a
whole cluster configuration (a :class:`~repro_torch.core.scu.engine.FleetConfig`)
and the step is one scheduling round of a
:class:`~repro_torch.core.scu.engine.SlotFleet` -- the batched array program over
every occupied slot.  Finished jobs free their lanes and queued jobs are
admitted at the next round, so the fleet stays warm across a stream of
heterogeneous sweep jobs instead of draining to idle between fixed batches.

Time axis and latency
---------------------
All latency accounting is in **scheduler rounds** (calls to :meth:`step`),
the machine-independent clock shared with :mod:`repro_torch.serve.arrivals`.  A
job's latency spans submit to finish inclusive; its queue wait is the
submit-to-admission span.  Wall-clock enters only in the benchmark layer,
as same-run throughput ratios.

Backpressure (documented choice: **reject**)
--------------------------------------------
The queue is bounded; :meth:`submit` on a full queue raises
:class:`QueueFull` deterministically -- the caller decides whether to
retry, drop, or throttle (``try_submit`` is the non-raising variant).
Rejecting keeps the service loop non-blocking and the behaviour identical
on every machine, which blocking-with-timeout would not.

Correctness
-----------
Admission timing is invisible to co-resident jobs (see
:class:`~repro_torch.core.scu.engine.SlotFleet`): every job's ``ClusterStats`` is
bit-exact against a sequential ``Cluster.run()`` of the same config, no
matter when it was admitted or what shared a step with it.  A job that
hits its ``max_cycles`` cap (or trips a watchdog) fails alone -- same
message ``Cluster.run`` would raise, carried on ``SweepJob.error`` -- and
its lanes are recycled.

Recovery (opt-in via :class:`RetryPolicy`)
------------------------------------------
Clusters are single-use, so a failed attempt cannot be re-run in place;
retryable jobs are submitted with a ``factory(attempt) -> FleetConfig``
callable that rebuilds a fresh config per attempt (attempt numbers start
at 1).  On failure the service logs the attempt in ``SweepJob.fault_log``
and re-queues the job after an exponential backoff in scheduler rounds
(``backoff_rounds * backoff_factor ** (attempts - 1)``); after
``degrade_after`` failed attempts it switches to ``fallback_factory`` when
provided (graceful degradation, e.g. the ``scu`` policy falling back to
``sw`` spin barriers -- marked on ``SweepJob.degraded``).  A job that
exhausts ``max_attempts`` (or has no way to rebuild a config) goes
**terminal**: ``state == "failed"``, ``error`` set, counted in
``finished`` -- so :meth:`run_until_drained` terminates instead of
spinning on permanently-failed work.

Checkpointing (opt-in via :class:`CheckpointPolicy`)
----------------------------------------------------
With ``checkpoint=CheckpointPolicy(interval_rounds=k)`` the service
snapshots every running member each ``k`` rounds of its attempt, at the
round boundary (a full-step boundary -- the only place the engine's
recovery contract allows).  The checkpoint is deterministic and bit-exact
(:mod:`repro_torch.core.scu.checkpoint`); a member running generator-backed
programs is silently non-checkpointable and keeps the restart-only
behaviour -- never a wrong resume.  A failed attempt that has a checkpoint
retries by **resuming** from it (with the attempt-scoped
:class:`~repro_torch.core.scu.faults.FaultPlan` stripped -- the transient-fault
model), so its wasted cycles shrink from the whole attempt to at most one
checkpoint interval.  If the resumed attempt fails again the checkpoint is
considered poisoned (it captured already-corrupted state, e.g. a core
whose wake was already lost) and dropped -- the next retry rebuilds from
scratch.  :meth:`suspend_all` checkpoints and evicts every running member
at once (service restart): the service object -- queue, backoff list and
checkpoints -- is the serialized in-flight state, and subsequent
:meth:`step` calls resume the whole sweep bit-exactly.

Priority admission + preemption (opt-in)
----------------------------------------
``admission_order="priority"`` replaces FIFO admission with a
deterministic priority pick: highest effective priority first, ties broken
by earlier submission then lower job id.  ``aging_rounds=k`` bumps a
waiting job's effective priority by one every ``k`` queued rounds, so
low-priority work cannot starve.  ``preempt=True`` (requires priority
mode and a checkpoint-capable job) lets a queued job with strictly higher
effective priority suspend the lowest-priority running member to a
checkpoint and take its lane; the victim re-enters the queue with its
checkpoint and resumes later (``faults="carry"`` -- preemption continues
the same attempt, losing zero cycles).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.core.scu.checkpoint import NotCheckpointable
from repro_torch.core.scu.engine import ClusterStats, FleetConfig, SlotFleet
from repro_torch.core.scu.trace import TraceProgram

__all__ = [
    "SweepJob",
    "QueueFull",
    "RetryPolicy",
    "CheckpointPolicy",
    "FleetService",
]


def _fresh_traces(config: FleetConfig) -> FleetConfig:
    """Clone any single-use :class:`TraceProgram`s in a config.

    Trace programs are consumed on first call (mirroring ``FaultPlan``), but
    a retry ``factory(attempt)`` commonly rebuilds only the cluster and
    reuses the lowered tables -- lowering is the expensive part.  Cloning at
    admission-config construction keeps that pattern valid: every attempt
    gets fresh cursors over the same immutable row tables.
    """
    if not any(isinstance(p, TraceProgram) for p in config.programs):
        return config
    return dataclasses.replace(
        config,
        programs=[
            p.clone() if isinstance(p, TraceProgram) else p
            for p in config.programs
        ],
    )


class QueueFull(RuntimeError):
    """Raised by :meth:`FleetService.submit` when the bounded queue is full."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Failure-recovery knobs for :class:`FleetService`.

    ``max_attempts`` caps total attempts per job (1 = no retry);
    ``backoff_rounds`` / ``backoff_factor`` shape the exponential backoff
    delay (in scheduler rounds) before attempt ``k+1``:
    ``backoff_rounds * backoff_factor ** (k - 1)``.  ``degrade_after``
    (optional) switches the job to its ``fallback_factory`` once that many
    attempts have failed -- graceful degradation to a more robust (slower)
    configuration instead of repeating the failing one forever.
    ``reroute`` asks for the retry to land on a *different healthy fault
    domain* when one exists (falling back to in-place retry otherwise);
    it only has meaning under :class:`repro_torch.serve.fleet_pool.FleetPool`
    (a single-fleet :class:`FleetService` has one domain and ignores it).
    """

    max_attempts: int = 3
    backoff_rounds: int = 1
    backoff_factor: int = 2
    degrade_after: Optional[int] = None
    reroute: bool = False

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.backoff_rounds < 0:
            raise ValueError(f"backoff_rounds must be >= 0, got {self.backoff_rounds}")
        if self.backoff_factor < 1:
            raise ValueError(f"backoff_factor must be >= 1, got {self.backoff_factor}")
        if self.degrade_after is not None and self.degrade_after < 1:
            raise ValueError(f"degrade_after must be >= 1, got {self.degrade_after}")


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    """Periodic-checkpoint knob for :class:`FleetService` /
    :class:`repro_torch.serve.fleet_pool.FleetPool`.

    Every running member is snapshotted each ``interval_rounds`` rounds of
    its current attempt (at the round boundary).  Smaller intervals bound
    the worst-case recovery loss tighter (a failed attempt resumes from
    its last checkpoint, so at most one interval of progress is redone) at
    the cost of more frequent captures."""

    interval_rounds: int = 8

    def __post_init__(self):
        if self.interval_rounds < 1:
            raise ValueError(
                f"interval_rounds must be >= 1, got {self.interval_rounds}"
            )


@dataclasses.dataclass
class SweepJob:
    """One sweep job's lifecycle record (filled in by the service).

    ``stats`` is a materialized snapshot -- safe to read after the job's
    slot has been recycled.  ``error`` is ``None`` on success, otherwise
    the timeout/deadlock message the sequential engine would have raised
    (terminal -- intermediate failures of retried attempts live in
    ``fault_log``).  ``state`` walks ``queued -> running`` and ends in
    ``done`` or ``failed``, with ``backoff -> queued -> running`` loops in
    between for retried attempts.  ``domain`` is the fault-domain (fleet)
    index the job last ran on -- always ``None`` under the single-fleet
    :class:`FleetService`, set by :class:`repro_torch.serve.fleet_pool.FleetPool`.
    """

    job_id: int
    config: FleetConfig
    submitted_round: int
    admitted_round: Optional[int] = None
    finished_round: Optional[int] = None
    slot: Optional[int] = None
    domain: Optional[int] = None
    stats: Optional[ClusterStats] = None
    error: Optional[str] = None
    state: str = "queued"
    attempts: int = 0
    degraded: bool = False
    wasted_cycles: int = 0  # simulated cycles burnt by failed attempts
    fault_log: List[Dict] = dataclasses.field(default_factory=list)
    factory: Optional[Callable[[int], FleetConfig]] = dataclasses.field(
        default=None, repr=False
    )
    fallback_factory: Optional[Callable[[int], FleetConfig]] = dataclasses.field(
        default=None, repr=False
    )
    # -- checkpoint / priority state (see the module docstring) ------------
    priority: int = 0
    checkpoint: Optional[object] = dataclasses.field(default=None, repr=False)
    checkpoint_round: Optional[int] = None
    checkpoint_disabled: bool = False  # member is not checkpointable
    restore_pending: bool = False  # next admission restores the checkpoint
    resume_faults: object = "carry"  # forwarded to SlotFleet.restore
    resumed_attempt: bool = False  # current attempt began as a failure-resume
    preemptions: int = 0  # times this job was suspended by a higher priority
    attempt_admitted_round: Optional[int] = None  # checkpoint cadence anchor

    @property
    def done(self) -> bool:
        return self.finished_round is not None

    @property
    def failed(self) -> bool:
        return self.error is not None

    @property
    def queue_rounds(self) -> Optional[int]:
        """Rounds spent waiting for a slot (0 = admitted immediately)."""
        if self.admitted_round is None:
            return None
        return self.admitted_round - self.submitted_round

    @property
    def latency_rounds(self) -> Optional[int]:
        """Submit-to-finish span, inclusive of the finishing round."""
        if self.finished_round is None:
            return None
        return self.finished_round - self.submitted_round + 1


class FleetService:
    """Bounded-queue sweep service over a warm :class:`SlotFleet`.

    Parameters
    ----------
    n_slots, slot_cores, banking_factor:
        Fleet geometry, passed through to :class:`SlotFleet` (jobs up to
        ``slot_cores`` cores fit; narrower jobs leave their slot's tail
        lanes idle, which the idle-lane accounting charges honestly).
    queue_limit:
        Bounded-queue depth; a full queue **rejects** (:class:`QueueFull`).
    admission:
        ``"continuous"`` (default) -- finished jobs free lanes mid-flight
        and queued jobs take them at the next round.  ``"drain"`` -- the
        fixed-batch baseline: new jobs are only admitted once *every* slot
        has drained, exactly the utilization loss continuous batching
        removes.  Both modes run the identical engine, so measured deltas
        are scheduling policy, not implementation.
    retry:
        Optional :class:`RetryPolicy`; ``None`` (default) keeps the legacy
        fail-fast behaviour (first failure is terminal).  See the module
        docstring's Recovery section.
    admission_order:
        ``"fifo"`` (default) or ``"priority"``; see the module docstring's
        priority section.
    aging_rounds:
        Optional starvation guard for priority mode: +1 effective priority
        per ``aging_rounds`` rounds spent queued.
    preempt:
        Priority mode only: let a strictly-higher-priority queued job
        suspend the lowest-priority running member to a checkpoint and
        take its lane.
    checkpoint:
        Optional :class:`CheckpointPolicy`; enables periodic snapshots and
        resume-from-checkpoint retries.
    """

    ADMISSION_MODES = ("continuous", "drain")
    ADMISSION_ORDERS = ("fifo", "priority")

    def __init__(
        self,
        n_slots: int,
        slot_cores: int,
        banking_factor: int = 2,
        queue_limit: int = 64,
        admission: str = "continuous",
        retry: Optional[RetryPolicy] = None,
        admission_order: str = "fifo",
        aging_rounds: Optional[int] = None,
        preempt: bool = False,
        checkpoint: Optional[CheckpointPolicy] = None,
    ):
        if admission not in self.ADMISSION_MODES:
            raise ValueError(
                f"admission must be one of {self.ADMISSION_MODES}, "
                f"got {admission!r}"
            )
        if admission_order not in self.ADMISSION_ORDERS:
            raise ValueError(
                f"admission_order must be one of {self.ADMISSION_ORDERS}, "
                f"got {admission_order!r}"
            )
        if preempt and admission_order != "priority":
            raise ValueError("preempt=True requires admission_order='priority'")
        if aging_rounds is not None and aging_rounds < 1:
            raise ValueError(f"aging_rounds must be >= 1, got {aging_rounds}")
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        self.fleet = SlotFleet(n_slots, slot_cores, banking_factor)
        self.queue_limit = queue_limit
        self.admission = admission
        self.admission_order = admission_order
        self.aging_rounds = aging_rounds
        self.preempt = preempt
        self.checkpoint = checkpoint
        self.retry = retry
        self.preemptions = 0  # member suspensions forced by priority
        self.round = 0  # completed step() calls == current round index
        self.queue: Deque[SweepJob] = deque()
        self.finished: List[SweepJob] = []
        self._by_slot: Dict[int, SweepJob] = {}
        # (eligible_round, job) pairs waiting out a retry backoff; re-queued
        # at the head of the round they become eligible (bypassing
        # queue_limit: a retry never competes with fresh submissions for
        # queue space, it already owns its place in the system)
        self._backoff: List[Tuple[int, SweepJob]] = []
        self._next_id = 0
        # lane-occupancy accounting (idle = not running a live job's core;
        # a narrow job's tail lanes count idle -- slot-width waste is real)
        self.lane_rounds = 0
        self.busy_lane_rounds = 0

    # ------------------------------------------------------------------ api
    def submit(
        self,
        config: Optional[FleetConfig] = None,
        *,
        factory: Optional[Callable[[int], FleetConfig]] = None,
        fallback_factory: Optional[Callable[[int], FleetConfig]] = None,
        priority: int = 0,
    ) -> SweepJob:
        """Enqueue a job; raises :class:`QueueFull` on a full queue and
        ``ValueError`` on a config the fleet could never admit (so the
        queue only ever holds admissible jobs).

        Pass exactly one of ``config`` (single-shot, non-rebuildable) or
        ``factory`` (``factory(attempt)`` builds a fresh config per
        attempt; attempt numbers start at 1).  ``fallback_factory`` is the
        degraded rebuild used after ``RetryPolicy.degrade_after`` failed
        attempts.  ``priority`` (higher = sooner) only matters under
        ``admission_order="priority"``."""
        if (config is None) == (factory is None):
            raise ValueError("submit: pass exactly one of config or factory")
        if config is None:
            config = _fresh_traces(factory(1))
        self.fleet.validate(config)
        if len(self.queue) >= self.queue_limit:
            raise QueueFull(
                f"queue full ({self.queue_limit} jobs waiting); "
                "retry after a step() or raise queue_limit"
            )
        job = SweepJob(
            self._next_id, config, submitted_round=self.round,
            factory=factory, fallback_factory=fallback_factory,
            priority=priority,
        )
        self._next_id += 1
        self.queue.append(job)
        return job

    def try_submit(self, config: FleetConfig) -> Optional[SweepJob]:
        """Non-raising :meth:`submit`: returns ``None`` instead of raising
        :class:`QueueFull` (invalid configs still raise ``ValueError``)."""
        try:
            return self.submit(config)
        except QueueFull:
            return None

    def step(self) -> List[SweepJob]:
        """One service round: re-queue backoff-expired retries, admit from
        the queue, advance the fleet one scheduling round, collect
        completions.  Returns the jobs that went terminal this round
        (stats materialized, failures marked); retried attempts are not
        returned -- they surface when they finally succeed or exhaust."""
        if self.checkpoint is not None:
            self._checkpoint_pass()
        if self._backoff:
            still: List[Tuple[int, SweepJob]] = []
            for eligible, job in self._backoff:
                if eligible <= self.round:
                    job.state = "queued"
                    self.queue.append(job)
                else:
                    still.append((eligible, job))
            self._backoff = still
        self._admit()
        done: List[SweepJob] = []
        finished_cores = 0
        if self.fleet.occupied:
            for m in self.fleet.advance():
                finished_cores += m.cluster.n_cores
                job = self._by_slot.pop(m.index)
                job.attempts += 1
                self.fleet.free(m.index)
                if m.error is not None:
                    fail_cycle = m.cluster.cycle
                    job.fault_log.append({
                        "attempt": job.attempts,
                        "round": self.round,
                        "cycles": fail_cycle,
                        "degraded": job.degraded,
                        "error": m.error.splitlines()[0],
                    })
                    if self._maybe_retry(job):
                        # a resume redoes only checkpoint -> failure; a
                        # restart redoes the whole attempt
                        resume_from = (
                            job.checkpoint.cycle if job.restore_pending
                            else 0
                        )
                        job.wasted_cycles += fail_cycle - resume_from
                        continue
                    job.wasted_cycles += fail_cycle
                    job.error = m.error
                    job.state = "failed"
                else:
                    job.state = "done"
                job.finished_round = self.round
                job.stats = m.cluster.stats
                self.finished.append(job)
                done.append(job)
        # occupancy snapshot of the round just executed (post-completion:
        # a lane freed this round was still busy during it, whether the
        # job went terminal or back to the retry queue)
        self.lane_rounds += self.fleet.n_slots * self.fleet.slot_cores
        self.busy_lane_rounds += sum(
            j.config.cluster.n_cores for j in self._by_slot.values()
        ) + finished_cores
        self.round += 1
        return done

    def run_until_drained(self, max_rounds: int = 10_000_000) -> List[SweepJob]:
        """Step until the queue, the backoff list and every slot are empty;
        returns all jobs finished along the way (terminally-failed jobs
        included -- they drain instead of spinning the loop).
        ``max_rounds`` guards against a caller submitting faster than the
        fleet can drain (raises RuntimeError)."""
        out: List[SweepJob] = []
        rounds = 0
        while self.queue or self._backoff or self.fleet.occupied:
            out.extend(self.step())
            rounds += 1
            if rounds > max_rounds:
                raise RuntimeError(
                    f"run_until_drained: not drained after {max_rounds} rounds"
                )
        return out

    # --------------------------------------------------------------- recovery
    def _maybe_retry(self, job: SweepJob) -> bool:
        """Schedule another attempt for a failed job if policy allows;
        returns False when the failure must go terminal.  Prefers resuming
        from the job's last checkpoint (faults stripped); a checkpoint
        that already backed one failed resume is poisoned and dropped."""
        r = self.retry
        if r is None or job.attempts >= r.max_attempts:
            return False
        if job.resumed_attempt:
            job.checkpoint = None
            job.checkpoint_round = None
        if job.checkpoint is not None:
            job.restore_pending = True
            job.resume_faults = None  # transient-fault model: strip the plan
        else:
            job.restore_pending = False
            cfg = self._next_config(job)
            if cfg is None:
                return False
            try:
                self.fleet.validate(cfg)
            except ValueError:
                return False  # a factory built an inadmissible config
            job.config = cfg
        job.slot = None
        job.state = "backoff"
        delay = r.backoff_rounds * (r.backoff_factor ** (job.attempts - 1))
        self._backoff.append((self.round + 1 + delay, job))
        return True

    def _next_config(self, job: SweepJob) -> Optional[FleetConfig]:
        """Build the config for the job's next attempt (clusters are
        single-use), or ``None`` when the job cannot be rebuilt."""
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

    # ----------------------------------------------------------- checkpoints
    def _checkpoint_pass(self) -> None:
        """Periodic snapshots at the round boundary (before this round's
        admissions and fleet advance -- a full-step boundary)."""
        iv = self.checkpoint.interval_rounds
        for slot, job in sorted(self._by_slot.items()):
            if job.checkpoint_disabled:
                continue
            age = self.round - job.attempt_admitted_round
            if age <= 0 or age % iv != 0:
                continue
            m = self.fleet.members[slot]
            if m.cluster.cycle >= m.max_cycles:
                continue  # burned to its cap: timeout imminent, state junk
            try:
                job.checkpoint = self.fleet.snapshot(slot)
            except NotCheckpointable:
                job.checkpoint_disabled = True  # restart-only from here on
            else:
                job.checkpoint_round = self.round

    def suspend_all(self) -> List[SweepJob]:
        """Checkpoint and evict every running member (service restart).

        After this call no member is in flight; each suspended job sits in
        the queue with its checkpoint and resumes (``faults="carry"`` --
        the same attempt continues bit-exactly) on subsequent
        :meth:`step` calls.  Non-checkpointable members fall back to a
        restart requeue via their factory, or go terminal when they cannot
        be rebuilt -- never a wrong resume.  Returns the suspended jobs."""
        out: List[SweepJob] = []
        for slot in sorted(self._by_slot):
            job = self._by_slot[slot]
            try:
                job.checkpoint = self.fleet.suspend(slot)
            except NotCheckpointable:
                job.checkpoint_disabled = True
                m = self.fleet.members[slot]
                job.wasted_cycles += m.cluster.cycle
                m.done = True
                self.fleet.free(slot)
                job.restore_pending = False
                cfg = self._rebuild_config(job)
                if cfg is None:
                    job.error = (
                        "suspended: generator-backed program is not "
                        "checkpointable and the job has no factory to "
                        "rebuild from"
                    )
                    job.state = "failed"
                    job.slot = None
                    job.finished_round = self.round
                    self.finished.append(job)
                    continue
                job.config = cfg
            else:
                job.checkpoint_round = self.round
                job.restore_pending = True
                job.resume_faults = "carry"
            job.slot = None
            job.state = "queued"
            self.queue.append(job)
            out.append(job)
        self._by_slot.clear()
        return out

    def _rebuild_config(self, job: SweepJob) -> Optional[FleetConfig]:
        """Restart rebuild for a suspended, non-checkpointable job."""
        factory = job.factory
        if job.degraded and job.fallback_factory is not None:
            factory = job.fallback_factory
        if factory is None:
            return None
        return _fresh_traces(factory(job.attempts + 1))

    # ------------------------------------------------------------- admission
    def _start(self, job: SweepJob) -> None:
        """Bind a queued job to a slot: fresh admit, or checkpoint restore."""
        if job.restore_pending and job.checkpoint is not None:
            slot = self.fleet.restore(job.checkpoint, faults=job.resume_faults)
            job.restore_pending = False
            # a failure-resume (stripped faults) marks the attempt so a
            # second failure poisons the checkpoint; a preemption resume
            # ("carry") continues the attempt unchanged
            if job.resume_faults is None:
                job.resumed_attempt = True
        else:
            slot = self.fleet.admit(job.config)
            job.resumed_attempt = False
        job.slot = slot
        job.state = "running"
        job.admitted_round = self.round
        job.attempt_admitted_round = self.round
        self._by_slot[slot] = job

    def _effective_priority(self, job: SweepJob) -> int:
        eff = job.priority
        if self.aging_rounds is not None:
            eff += (self.round - job.submitted_round) // self.aging_rounds
        return eff

    def _best_queued(self) -> int:
        """Queue index of the next job under priority order: highest
        effective priority, then earliest submission, then lowest id."""
        return min(
            range(len(self.queue)),
            key=lambda i: (
                -self._effective_priority(self.queue[i]),
                self.queue[i].submitted_round,
                self.queue[i].job_id,
            ),
        )

    def _preempt_victim(self, eff: int) -> Optional[SweepJob]:
        """Lowest-effective-priority running member strictly below ``eff``
        (ties to the youngest submission then highest id -- the inverse of
        admission order), skipping non-checkpointable members."""
        victims = sorted(
            (
                j for j in self._by_slot.values()
                if not j.checkpoint_disabled
                and self._effective_priority(j) < eff
            ),
            key=lambda j: (
                self._effective_priority(j),
                -j.submitted_round,
                -j.job_id,
            ),
        )
        for victim in victims:
            try:
                ckpt = self.fleet.suspend(victim.slot)
            except NotCheckpointable:
                victim.checkpoint_disabled = True
                continue
            victim.checkpoint = ckpt
            victim.checkpoint_round = self.round
            victim.restore_pending = True
            victim.resume_faults = "carry"  # same attempt, zero lost cycles
            self._by_slot.pop(victim.slot)
            victim.slot = None
            victim.state = "queued"
            victim.preemptions += 1
            self.preemptions += 1
            self.queue.append(victim)
            return victim
        return None

    def _admit(self) -> None:
        if self.admission == "drain" and self.fleet.occupied:
            return  # baseline: wait for the whole fleet to empty
        if self.admission_order == "priority":
            self._admit_priority()
            return
        while self.queue and self.fleet.free_slots:
            job = self.queue.popleft()
            self._start(job)

    def _admit_priority(self) -> None:
        while self.queue:
            idx = self._best_queued()
            job = self.queue[idx]
            if self.fleet.free_slots:
                del self.queue[idx]
                self._start(job)
                continue
            if not self.preempt:
                return
            victim = self._preempt_victim(self._effective_priority(job))
            if victim is None:
                return
            # the victim appended itself to the queue tail; the candidate's
            # index is unchanged
            del self.queue[idx]
            self._start(job)

    # --------------------------------------------------------------- metrics
    @property
    def pending(self) -> int:
        return len(self.queue)

    @property
    def active(self) -> int:
        return len(self._by_slot)

    @property
    def idle_lane_fraction(self) -> float:
        """Fraction of (lane, round) cells spent idle so far (0.0 before
        the first round).  The drain baseline's straggler tails and slot
        fragmentation both land here."""
        if self.lane_rounds == 0:
            return 0.0
        return 1.0 - self.busy_lane_rounds / self.lane_rounds
