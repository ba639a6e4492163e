"""Deterministic, bit-exact checkpoint/restore for in-flight cluster jobs.

Own copy of ``repro/core/scu/checkpoint.py`` (the port imports nothing of
``repro``), line for line.

A :class:`MemberCheckpoint` captures the complete semantic state of one
running cluster at a **full-step boundary** (between scheduler rounds --
never mid-step, mirroring the recovery-mechanism constraint every fault
hook already obeys):

* per-core scheduler state and stat counters (state code, countdowns,
  pending micro-op, resume value, the nine counters -- read uniformly
  through the ``_Core``/``_VecCore`` attribute layer, so one capture path
  covers the scalar, vectorized and fleet-attached engines),
* the SCU: base-unit registers, latched elw wait masks and pending set,
  the lost-wake drop filter, every extension instance's comparator state
  (armed sets are re-derived on restore via the ``_*_touched`` hooks) and
  the watchdog's progress clock,
* TCDM contents, per-bank round-robin pointers, the local clock and cap,
  cluster-level stats (bank conflicts, SCU events),
* the :class:`~repro_torch.core.scu.faults.FaultPlan` cursor -- a restored run
  resumes mid-plan and replays the remaining schedule bit-exactly,
* per-core trace-cursor program counters.

Checkpointability rides on the trace IR (``trace.py``): a core is captureable iff
its program is a compiled :class:`~repro_torch.core.scu.trace.TraceProgram`
cursor (table rows are plain ints; the cursor's mutable state is five
scalars and a loop-counter dict).  Generator-backed programs hold opaque
Python frames and are **explicitly non-checkpointable**:
:func:`capture_cluster` raises :class:`NotCheckpointable` and the caller
falls back to restart -- never a wrong resume.

The crown invariant (enforced by ``tests/test_checkpoint.py`` and the
``scripts/fault_fuzz.py --snapshot`` lane): a restored run produces
bit-identical :class:`~repro_torch.core.scu.engine.ClusterStats` to an
uninterrupted one, across lockstep, fastforward and fleet tiers, into any
slot of any fleet.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, Optional, Tuple

from .engine import (
    _COUNTERS,
    Cluster,
    Compute,
    CoreState,
    FleetConfig,
    Mem,
    Poll,
    Scu,
)
from .faults import FaultPlan, Watchdog
from .scu_unit import SCU
from .trace import TraceProgram, _TraceCursor

__all__ = [
    "CARRY_FAULTS",
    "NotCheckpointable",
    "CoreCheckpoint",
    "ScuCheckpoint",
    "MemberCheckpoint",
    "capture_cluster",
    "resume_config",
    "restore_cluster",
    "apply_cluster_state",
]

# ``faults=`` sentinel: replay the checkpointed plan cursor.  ``None``
# strips the plan (live migration to a healthy domain must not carry the
# sick domain's remaining fault schedule along); a FaultPlan overrides.
CARRY_FAULTS = "carry"


class NotCheckpointable(RuntimeError):
    """The cluster's state cannot be captured exactly (generator-backed
    program, already finished, or a tripped watchdog).  Callers fall back
    to restart-from-zero -- never a wrong resume."""


# ---------------------------------------------------------------------------
# Micro-op value serialization (engine code only type-checks and reads
# fields, so a rebuilt instance is operationally identical)
# ---------------------------------------------------------------------------


def _op_spec(op: Any) -> Tuple:
    t = type(op)
    if t is Compute:
        return ("compute", op.cycles)
    if t is Mem:
        return ("mem", op.kind, op.addr, op.data)
    if t is Poll:
        return ("poll", op.kind, op.addr, op.until, op.hit_cycles,
                op.miss_cycles, op.hit_instr, op.miss_instr)
    if t is Scu:
        return ("scu", op.kind, op.addr, op.data)
    raise NotCheckpointable(f"unknown pending micro-op {op!r}")


def _op_from_spec(spec: Tuple) -> Any:
    tag = spec[0]
    if tag == "compute":
        return Compute(spec[1])
    if tag == "mem":
        return Mem(spec[1], spec[2], spec[3])
    if tag == "poll":
        return Poll(*spec[1:])
    return Scu(spec[1], spec[2], spec[3])


# ---------------------------------------------------------------------------
# Checkpoint records
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CoreCheckpoint:
    """One core's scheduler + accounting + trace-cursor state."""

    state: int  # CoreState code
    busy: int
    wake_countdown: int
    sleep_entry: int
    started: bool
    resume_value: Any
    elw_issued: bool
    finished_at: Optional[int]
    counters: Tuple[int, ...]  # the nine _COUNTERS, in order
    pending: Optional[Tuple]  # _op_spec of the outstanding op
    prog: TraceProgram  # shared, immutable row table
    cursor: Tuple  # (pc, R, ctrs dict, crossed, _rep)


@dataclasses.dataclass
class ScuCheckpoint:
    """Complete SCU state: registers, extensions, drop filter, watchdog."""

    n_cores: int
    ev_buf: Tuple[int, ...]
    ev_mask: Tuple[int, ...]
    irq_mask: Tuple[int, ...]
    ntf_target: Tuple[int, ...]
    elw_wait: Tuple[int, ...]
    elw_pending: frozenset
    drop: Tuple[int, ...]
    dropped_events: int
    drop_armed: bool
    barriers: Tuple[Tuple[int, int, int], ...]  # worker/target/status
    mutexes: Tuple[Tuple, ...]  # (owner, message, pending queue)
    fifos: Tuple[Tuple, ...]  # (depth, fifo, poppers, pushers, msgs, ...)
    watchdog: Optional[Tuple]  # (timeout, mode, max_rel, progress, ...)


@dataclasses.dataclass
class MemberCheckpoint:
    """A whole in-flight job, captured at a full-step boundary.

    In-memory and slot-geometry free: restorable into the same slot, a
    different slot, a different :class:`~repro_torch.core.scu.engine.SlotFleet`,
    or a standalone :class:`~repro_torch.core.scu.engine.Cluster` in either
    engine mode.  The trace tables are shared by reference (immutable);
    everything mutable is copied at capture time, so one checkpoint backs
    arbitrarily many restores.
    """

    n_cores: int
    banking_factor: int
    cycle: int  # absolute local clock at the boundary
    max_cycles: int  # absolute cap of the interrupted run
    n_done: int
    tcdm: Dict[int, int]
    rr: Tuple[int, ...]  # per-bank round-robin pointers
    bank_conflicts: int
    scu_events: int
    cores: Tuple[CoreCheckpoint, ...]
    scu: Optional[ScuCheckpoint]
    faults: Optional[Tuple]  # (events, cursor index, applied log)

    @property
    def progress_cycles(self) -> int:
        """Cycles of work this checkpoint preserves on restore."""
        return self.cycle


# ---------------------------------------------------------------------------
# Capture
# ---------------------------------------------------------------------------


def _capture_scu(scu: SCU) -> ScuCheckpoint:
    wd = scu.watchdog
    wd_ck = None
    if wd is not None:
        if wd.tripped is not None:
            raise NotCheckpointable(
                "watchdog already tripped; the member is failed, not "
                "suspendable"
            )
        wd_ck = (wd.timeout, wd.mode, wd.max_releases, wd.last_progress,
                 wd.release_count, [dict(e) for e in wd.release_log])
    base = scu.base
    return ScuCheckpoint(
        n_cores=scu.n_cores,
        ev_buf=tuple(int(x) for x in base.ev_buf),
        ev_mask=tuple(int(x) for x in base.ev_mask),
        irq_mask=tuple(int(x) for x in base.irq_mask),
        ntf_target=tuple(int(x) for x in base.ntf_target),
        elw_wait=tuple(int(x) for x in scu.elw_wait),
        elw_pending=frozenset(scu._elw_pending),
        drop=tuple(int(x) for x in base.drop),
        dropped_events=int(base.dropped_events),
        drop_armed=bool(base._drop_armed),
        barriers=tuple(
            (b.worker_mask, b.target_mask, b.status) for b in scu.barriers
        ),
        mutexes=tuple(
            (m.owner, m.message, tuple(m.pending)) for m in scu.mutexes
        ),
        fifos=tuple(
            (f.depth, tuple(f.fifo), tuple(f.poppers), tuple(f.pushers),
             tuple(sorted(f.messages.items())), f.dropped, f.pushed)
            for f in scu.fifos
        ),
        watchdog=wd_ck,
    )


def capture_cluster(cluster: Cluster) -> MemberCheckpoint:
    """Checkpoint a running cluster at the current full-step boundary.

    Works on standalone clusters (either engine mode) and fleet-attached
    members (the ``_VecCore`` property layer reads the segment views).
    Raises :class:`NotCheckpointable` when any core runs a generator-backed
    program, the cluster already finished, or the watchdog tripped.
    """
    cores = cluster.cores
    if not cores:
        raise NotCheckpointable("cluster has no loaded program")
    for c in cores:
        if not getattr(c.gen, "_is_trace_cursor", False):
            raise NotCheckpointable(
                f"core {c.cid} runs a generator-backed program; only "
                "compiled TraceProgram cursors are checkpointable "
                "(lower with compiled=True) -- falling back to restart"
            )
    if cluster._n_done >= cluster.n_cores:
        raise NotCheckpointable("cluster already finished")
    scu_ck = _capture_scu(cluster.scu) if cluster.scu is not None else None
    plan = cluster.faults
    faults_ck = None
    if plan is not None:
        faults_ck = (tuple(plan.events), plan._next,
                     [dict(e) for e in plan.applied])
    core_cks = []
    for c in cores:
        cur = c.gen
        pending = c.pending
        core_cks.append(CoreCheckpoint(
            state=int(c.state.value),
            busy=int(c.busy),
            wake_countdown=int(c.wake_countdown),
            sleep_entry=int(c.sleep_entry),
            started=bool(c.started),
            resume_value=c.resume_value,
            elw_issued=bool(c.elw_issued),
            finished_at=c.finished_at,
            counters=tuple(int(getattr(c, n)) for n in _COUNTERS),
            pending=None if pending is None else _op_spec(pending),
            prog=cur.prog,
            cursor=(cur.pc, cur.R, dict(cur.ctrs), cur.crossed, cur._rep),
        ))
    return MemberCheckpoint(
        n_cores=cluster.n_cores,
        banking_factor=cluster.n_banks // cluster.n_cores,
        cycle=int(cluster.cycle),
        max_cycles=int(cluster.max_cycles),
        n_done=int(cluster._n_done),
        tcdm=dict(cluster.tcdm),
        rr=tuple(int(x) for x in cluster._rr),
        bank_conflicts=int(cluster.stats.bank_conflicts),
        scu_events=int(cluster.stats.scu_events),
        cores=tuple(core_cks),
        scu=scu_ck,
        faults=faults_ck,
    )


# ---------------------------------------------------------------------------
# Restore
# ---------------------------------------------------------------------------


def _restore_scu(ck: ScuCheckpoint) -> SCU:
    wd = None
    if ck.watchdog is not None:
        timeout, mode, max_rel, progress, rel_count, rel_log = ck.watchdog
        wd = Watchdog(timeout, mode=mode, max_releases=max_rel)
        wd.last_progress = progress
        wd.release_count = rel_count
        wd.release_log = [dict(e) for e in rel_log]
    scu = SCU(
        ck.n_cores,
        n_barriers=len(ck.barriers),
        n_mutexes=len(ck.mutexes),
        fifo_depth=ck.fifos[0][0] if ck.fifos else None,
        n_fifos=len(ck.fifos) if ck.fifos else None,
        watchdog=wd,
    )
    base = scu.base
    base.ev_buf[:] = ck.ev_buf
    base.ev_mask[:] = ck.ev_mask
    base.irq_mask[:] = ck.irq_mask
    base.ntf_target[:] = ck.ntf_target
    scu.elw_wait[:] = ck.elw_wait
    scu._elw_pending = set(ck.elw_pending)
    base.drop[:] = ck.drop
    base.dropped_events = ck.dropped_events
    base._drop_armed = ck.drop_armed
    for b, (wm, tm, status) in zip(scu.barriers, ck.barriers):
        b.worker_mask = wm
        b.target_mask = tm
        b.status = status
    for m, (owner, message, pending) in zip(scu.mutexes, ck.mutexes):
        m.owner = owner
        m.message = message
        m.pending = deque(pending)
    for f, (depth, fifo, poppers, pushers, msgs, dropped, pushed) in zip(
        scu.fifos, ck.fifos
    ):
        f.depth = depth
        f.fifo = deque(fifo)
        f.poppers = deque(poppers)
        f.pushers = deque(pushers)
        f.messages = dict(msgs)
        f.dropped = dropped
        f.pushed = pushed
    # armed sets are derivable state: re-derive from the restored
    # comparators so evaluate/next_event_bound see exactly the captured
    # firing conditions
    for i in range(len(scu.barriers)):
        scu._barrier_touched(i)
    for i in range(len(scu.mutexes)):
        scu._mutex_touched(i)
    for i in range(len(scu.fifos)):
        scu._fifo_touched(i)
    return scu


def _restore_plan(faults_ck: Tuple) -> FaultPlan:
    events, nxt, applied = faults_ck
    # the event tuple is already in plan order; FaultPlan's stable sort
    # rebuilds every derived cache (cycle index, blackout windows) from it
    plan = FaultPlan(list(events))
    plan._next = nxt
    plan.applied = [dict(e) for e in applied]
    return plan


def _resume_program(prog: TraceProgram, cursor_state: Tuple):
    """A ``Program`` resuming ``prog`` at a saved cursor position.

    Bypasses ``TraceProgram.__call__`` (and its single-use guard) on
    purpose: restores share the original -- possibly consumed -- program
    object, cursors only read its immutable tables.  The closure is
    idempotent, so one checkpoint backs many restores, and it is *not* a
    :class:`TraceProgram` instance, so the serve layer's trace-cloning
    admission hook passes it through untouched.
    """
    pc, R, ctrs, crossed, rep = cursor_state

    def make(cluster, cid):
        cur = _TraceCursor(prog, cluster, cid)
        cur.pc = pc
        cur.R = R
        cur.ctrs = dict(ctrs)
        cur.crossed = crossed
        cur._rep = rep
        return cur

    return make


def _plan_for(ckpt: MemberCheckpoint, faults) -> Optional[FaultPlan]:
    if faults == CARRY_FAULTS:
        return _restore_plan(ckpt.faults) if ckpt.faults is not None else None
    return faults


def resume_config(ckpt: MemberCheckpoint, faults=CARRY_FAULTS) -> FleetConfig:
    """A fresh :class:`FleetConfig` that resumes ``ckpt`` when admitted.

    The config passes every fleet admission check (fresh cluster, cycle 0);
    after attachment the caller must run :func:`apply_cluster_state` to
    overwrite the scheduler state -- :meth:`SlotFleet.restore` does both.
    ``faults=CARRY_FAULTS`` replays the checkpointed plan cursor; ``None``
    strips it (migration semantics); a :class:`FaultPlan` overrides.
    """
    scu = _restore_scu(ckpt.scu) if ckpt.scu is not None else None
    cl = Cluster(
        ckpt.n_cores,
        scu=scu,
        banking_factor=ckpt.banking_factor,
        mode="fastforward",
        faults=_plan_for(ckpt, faults),
    )
    programs = [_resume_program(c.prog, c.cursor) for c in ckpt.cores]
    return FleetConfig(cluster=cl, programs=programs,
                       max_cycles=ckpt.max_cycles)


def apply_cluster_state(cluster: Cluster, ckpt: MemberCheckpoint) -> None:
    """Overwrite a freshly loaded (or fleet-attached) cluster with the
    checkpointed scheduler state.  Must run at attachment time, before the
    next step/round; the clock and cap stay absolute, so timeout and
    watchdog semantics continue exactly where the interrupted run left
    off."""
    cluster.cycle = ckpt.cycle
    cluster.max_cycles = ckpt.max_cycles
    cluster._n_done = ckpt.n_done
    cluster.tcdm.clear()
    cluster.tcdm.update(ckpt.tcdm)
    cluster._rr[:] = ckpt.rr
    cluster.stats.bank_conflicts = ckpt.bank_conflicts
    cluster.stats.scu_events = ckpt.scu_events
    V = cluster._vec
    for core, ck in zip(cluster.cores, ckpt.cores):
        core.state = CoreState(ck.state)
        core.busy = ck.busy
        core.wake_countdown = ck.wake_countdown
        core.sleep_entry = ck.sleep_entry
        core.started = ck.started
        core.resume_value = ck.resume_value
        core.elw_issued = ck.elw_issued
        core.finished_at = ck.finished_at
        for name, value in zip(_COUNTERS, ck.counters):
            setattr(core, name, value)
        op = _op_from_spec(ck.pending) if ck.pending is not None else None
        core.pending = op
        if V is not None:
            # derived SoA lanes the property layer does not cover
            cid = core.cid
            if op is not None and (type(op) is Mem or type(op) is Poll):
                V.pend_bank[cid] = cluster._bank_of(op.addr)
                V.has_poll[cid] = type(op) is Poll
            else:
                V.pend_bank[cid] = -1
                V.has_poll[cid] = False


def restore_cluster(
    ckpt: MemberCheckpoint, mode: str = "fastforward", faults=CARRY_FAULTS
) -> Cluster:
    """A standalone cluster resuming ``ckpt``; continue with
    ``cluster.run(ckpt.max_cycles)`` (the clock is absolute, so the cap
    carries over).  ``mode`` picks the engine tier -- lockstep restores are
    the parity reference for the fleet restore paths."""
    scu = _restore_scu(ckpt.scu) if ckpt.scu is not None else None
    cl = Cluster(
        ckpt.n_cores,
        scu=scu,
        banking_factor=ckpt.banking_factor,
        mode=mode,
        faults=_plan_for(ckpt, faults),
    )
    cl.load([_resume_program(c.prog, c.cursor) for c in ckpt.cores])
    apply_cluster_state(cl, ckpt)
    return cl
