"""Deterministic fault injection + watchdog recovery for the cluster engine.

Own copy of ``repro/core/scu/faults.py`` (the port imports nothing of
``repro``), line for line; ``tests/test_torch_sim_engine.py`` holds it to
the reference on the same plans and seeds.

Near-threshold silicon sees transient upsets the paper's evaluation assumes
away: wake-up events that never reach a core, events that fire without a
cause, cores frozen for a handful of cycles by droop, and TCDM banks blacked
out by glitching arbitration.  This module makes those failure modes
first-class *deterministic* simulator inputs:

:class:`FaultPlan`
    A seed-derivable schedule of :class:`FaultEvent`\\ s applied at exact
    cycles.  The plan implements the same ``next_event_bound()`` contract as
    the SCU extensions (see :mod:`repro_torch.core.scu.extensions`): ``0`` at any
    cycle where a fault applies (or inside a bank-blackout window), a
    positive count until the next fault otherwise, ``None`` when the plan is
    exhausted.  The engine mins this bound into every fast-forward tier, so
    a full cluster step lands on *exactly* the fault cycles in both engine
    modes -- fault-injected runs stay bit-exact between ``lockstep`` and
    ``fastforward`` (enforced by ``tests/test_faults.py``).  A plan instance
    is **single-use** (it carries an application cursor); use
    :meth:`FaultPlan.clone` to run the same schedule on a second cluster.

:class:`Watchdog`
    An SCU extension that detects stuck comparators: when cores are parked
    on in-flight ``elw`` transactions and the SCU sees no progress (no
    access, no trigger, no grant, no comparator event) for ``timeout``
    cycles, it either force-releases every parked waiter
    (``mode="release"``) or trips with a structured wait-for graph
    (``mode="raise"`` -- surfaced by the engine as :class:`DeadlockError`).
    The watchdog implements ``next_event_bound()`` (a positive, possibly
    conservative bound is safe: firing only ever moves *later* when
    progress happens), so the fast-forward tiers jump straight to its
    deadline instead of burning to the ``max_cycles`` cap.

:class:`DeadlockError` / :class:`SimTimeout`
    Structured failures carrying a :class:`WaitForGraph`: the per-core
    blocked micro-op, the armed/stuck comparator instances, and the fault
    events applied so far (the blame list).  ``SimTimeout`` keeps the
    legacy ``"cluster did not finish within ..."`` message prefix so
    existing capture paths (``SlotFleet._on_timeout``) stay intact.

This module deliberately imports nothing from the engine (the engine
imports it); everything here operates on clusters by duck typing.
"""

from __future__ import annotations

import bisect
import dataclasses
import random as _random
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Tuple

__all__ = [
    "ALL_LINES",
    "FAULT_KINDS",
    "DOMAIN_KINDS",
    "FaultEvent",
    "FaultPlan",
    "Watchdog",
    "DeadlockError",
    "SimTimeout",
    "WaitForGraph",
    "build_wait_graph",
]

ALL_LINES = 0xFFFFFFFF  # every event line (32, Sec. 4.2)

# "droop"/"scu_blackout" are appended so the sort index of the original four
# kinds -- and therefore the event order of every pre-existing plan -- is
# unchanged.
FAULT_KINDS = (
    "lost_wake", "spurious_wake", "stall", "bank_blackout",
    "droop", "scu_blackout",
)

# Kinds that model *correlated* failure of a whole fault domain (a voltage
# island / cluster group) rather than an independent per-core upset.  A
# domain-wide bank blackout is an ordinary ``bank_blackout`` whose ``banks``
# enumerate the domain's banks.
DOMAIN_KINDS = ("droop", "scu_blackout", "bank_blackout")

# event lines a spurious upset plausibly lands on (notifiers 0/1 and the
# three extension lines -- see repro_torch.core.scu.scu_unit.EV)
_SPURIOUS_LINES = (0, 1, 8, 9, 10)


class DeadlockError(RuntimeError):
    """The cluster provably cannot make progress (watchdog trip / timeout).

    ``graph`` carries the :class:`WaitForGraph` snapshot taken when the
    deadlock was detected; the message embeds its rendered form.
    """

    def __init__(self, message: str, graph: Optional["WaitForGraph"] = None):
        super().__init__(message)
        self.graph = graph


class SimTimeout(DeadlockError):
    """A run hit its ``max_cycles`` cap.  Message keeps the legacy
    ``"cluster did not finish within ..."`` prefix and appends the per-core
    wait-for dump."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled upset.  Fields used per kind:

    ``lost_wake``      -- at ``cycle``, arm a one-shot drop filter on core
                          ``core``: the next SCU event delivery on any line
                          in ``lines`` to that core is silently suppressed.
    ``spurious_wake``  -- at ``cycle``, latch event ``line`` into core
                          ``core``'s event buffer with no cause.
    ``stall``          -- at ``cycle``, freeze core ``core`` for ``span``
                          extra cycles (models a local voltage droop): an
                          ACTIVE core's compute countdown and a WAKING
                          core's wake sequencing are extended; cores in any
                          other state are unaffected (logged as a no-op).
    ``bank_blackout``  -- during ``[cycle, cycle + span)``, the TCDM banks
                          in ``banks`` grant nothing; requests stay queued
                          (and are not charged as bank conflicts -- the
                          interconnect, not contention, is at fault).
    ``droop``          -- at ``cycle``, one correlated voltage droop freezes
                          *every* core in ``cores`` for ``span`` extra
                          cycles (same per-core semantics as ``stall``,
                          applied to the whole domain at the same cycle).
    ``scu_blackout``   -- during ``[cycle, cycle + span)``, the SCU's
                          comparators neither evaluate nor grant: triggers
                          still latch (armed state is preserved) and event
                          deliveries still buffer, but nothing fires or
                          wakes until the window ends, when the armed
                          comparators replay on the first ungated evaluate.

    ``domain`` is a free-form blame label ("" = not domain-scoped) carried
    into the :attr:`FaultPlan.applied` log and :class:`WaitForGraph`.
    """

    kind: str
    cycle: int
    core: int = -1
    lines: int = ALL_LINES  # lost_wake: drop mask over event lines
    line: int = 0  # spurious_wake: event line to set
    span: int = 0  # stall/droop: freeze cycles; *_blackout: window length
    banks: Tuple[int, ...] = ()  # bank_blackout: local bank ids
    cores: Tuple[int, ...] = ()  # droop: every core of the domain
    domain: str = ""  # blame label for domain-scoped events

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.cycle < 0:
            raise ValueError(f"fault cycle must be >= 0, got {self.cycle}")
        if self.kind in ("lost_wake", "spurious_wake", "stall") and self.core < 0:
            raise ValueError(f"{self.kind} needs a target core")
        if self.kind in ("stall", "bank_blackout", "droop", "scu_blackout") \
                and self.span < 1:
            raise ValueError(f"{self.kind} needs span >= 1, got {self.span}")
        if self.kind == "bank_blackout" and not self.banks:
            raise ValueError("bank_blackout needs at least one bank")
        if self.kind == "droop" and not self.cores:
            raise ValueError("droop needs at least one core in its domain")


class FaultPlan:
    """A deterministic, cycle-addressed schedule of :class:`FaultEvent`\\ s.

    Pass one instance per cluster (``Cluster(..., faults=plan)``).  The
    engine calls :meth:`apply` at the start of every full step and mins
    :meth:`next_event_bound` into every fast-forward tier; together these
    guarantee each event is applied at exactly its scheduled cycle in both
    engine modes.  :attr:`applied` is the blame log surfaced by
    :func:`build_wait_graph`.
    """

    def __init__(self, events: Sequence[FaultEvent] = ()):
        self.events: List[FaultEvent] = sorted(
            events,
            key=lambda e: (e.cycle, FAULT_KINDS.index(e.kind), e.core, e.line),
        )
        self._next = 0
        self.applied: List[Dict[str, Any]] = []
        self._cycles = sorted({e.cycle for e in self.events})
        self._windows: List[Tuple[int, int, FrozenSet[int]]] = sorted(
            (e.cycle, e.cycle + e.span, frozenset(e.banks))
            for e in self.events
            if e.kind == "bank_blackout"
        )
        self._blk_cache: Tuple[int, FrozenSet[int]] = (-1, frozenset())
        self._scu_windows: List[Tuple[int, int]] = sorted(
            (e.cycle, e.cycle + e.span)
            for e in self.events
            if e.kind == "scu_blackout"
        )
        self._scu_cache: Tuple[int, bool] = (-1, False)

    def __len__(self) -> int:
        return len(self.events)

    def __repr__(self) -> str:
        # eval-able (given FaultEvent/FaultPlan in scope): the minimal
        # reproducer printed by scripts/fault_fuzz.py on a parity mismatch
        return f"FaultPlan({self.events!r})"

    def clone(self) -> "FaultPlan":
        """A fresh plan with the same schedule and a reset cursor (for
        running the identical fault history on a second cluster, e.g. the
        lockstep parity reference)."""
        return FaultPlan(self.events)

    @classmethod
    def random(
        cls,
        seed: int,
        n_cores: int,
        n_banks: int,
        horizon: int,
        n_events: int = 4,
        kinds: Sequence[str] = FAULT_KINDS,
    ) -> "FaultPlan":
        """A seed-derived plan: ``n_events`` faults of the given kinds over
        cycles ``[0, horizon)``.  Same seed -> same schedule, always."""
        rng = _random.Random(seed)
        kinds = tuple(kinds)
        events: List[FaultEvent] = []
        for _ in range(n_events):
            kind = rng.choice(kinds)
            cycle = rng.randrange(max(1, horizon))
            core = rng.randrange(n_cores)
            if kind == "lost_wake":
                events.append(FaultEvent("lost_wake", cycle, core))
            elif kind == "spurious_wake":
                events.append(
                    FaultEvent(
                        "spurious_wake", cycle, core,
                        line=rng.choice(_SPURIOUS_LINES),
                    )
                )
            elif kind == "stall":
                events.append(
                    FaultEvent("stall", cycle, core, span=rng.randrange(1, 64))
                )
            else:
                k = rng.randrange(1, max(2, n_banks // 2 + 1))
                banks = tuple(sorted(rng.sample(range(n_banks), k)))
                events.append(
                    FaultEvent(
                        "bank_blackout", cycle,
                        span=rng.randrange(1, 32), banks=banks,
                    )
                )
        return cls(events)

    @classmethod
    def random_domain(
        cls,
        seed: int,
        n_cores: int,
        n_banks: int,
        horizon: int,
        n_events: int = 3,
        n_domains: int = 2,
        kinds: Sequence[str] = DOMAIN_KINDS,
    ) -> "FaultPlan":
        """A seed-derived plan of *domain-scoped* events: the cluster's
        cores/banks are split into ``n_domains`` contiguous groups and every
        event hits one whole group (correlated droop, SCU blackout, or a
        domain-wide bank blackout).  Same seed -> same schedule, always."""
        rng = _random.Random(seed)
        kinds = tuple(kinds)
        n_domains = max(1, min(n_domains, n_cores))
        events: List[FaultEvent] = []
        for _ in range(n_events):
            kind = rng.choice(kinds)
            d = rng.randrange(n_domains)
            name = f"dom{d}"
            cycle = rng.randrange(max(1, horizon))
            if kind == "droop":
                cores = tuple(
                    c for c in range(n_cores) if c * n_domains // n_cores == d
                )
                events.append(
                    FaultEvent(
                        "droop", cycle, cores=cores,
                        span=rng.randrange(1, 64), domain=name,
                    )
                )
            elif kind == "scu_blackout":
                events.append(
                    FaultEvent(
                        "scu_blackout", cycle,
                        span=rng.randrange(1, 32), domain=name,
                    )
                )
            else:
                banks = tuple(
                    b for b in range(n_banks) if b * n_domains // n_banks == d
                ) or (0,)
                events.append(
                    FaultEvent(
                        "bank_blackout", cycle,
                        span=rng.randrange(1, 32), banks=banks, domain=name,
                    )
                )
        return cls(events)

    # --------------------------------------------------------- engine hooks
    def next_event_bound(self, cycle: int) -> Optional[int]:
        """Fast-forward bound contract (same semantics as the SCU
        extensions): 0 when a fault applies at ``cycle`` or a blackout
        window is active, else cycles until the next scheduled fault,
        ``None`` when nothing is left."""
        nxt: Optional[int] = None
        i = bisect.bisect_left(self._cycles, cycle)
        if i < len(self._cycles):
            d = self._cycles[i] - cycle
            if d == 0:
                return 0
            nxt = d
        for start, end, _banks in self._windows:
            if start > cycle:
                break
            if cycle < end:
                return 0
        # an SCU blackout forces full steps through its whole window: gated
        # grants/evaluates are cycle-addressed state the fast paths must not
        # jump over (and the first post-window step replays the armed state)
        for start, end in self._scu_windows:
            if start > cycle:
                break
            if cycle < end:
                return 0
        return nxt

    def scu_blacked(self, cycle: int) -> bool:
        """True while an ``scu_blackout`` window covers ``cycle`` (the SCU
        gates comparator evaluation and elw grants on this)."""
        if not self._scu_windows:
            return False
        c, blacked = self._scu_cache
        if c == cycle:
            return blacked
        blacked = any(
            start <= cycle < end for start, end in self._scu_windows
        )
        self._scu_cache = (cycle, blacked)
        return blacked

    def blacked_banks(self, cycle: int) -> FrozenSet[int]:
        """Local bank ids blacked out at ``cycle`` (empty set = none)."""
        c, banks = self._blk_cache
        if c == cycle:
            return banks
        acc: set = set()
        for start, end, bs in self._windows:
            if start > cycle:
                break
            if cycle < end:
                acc |= bs
        banks = frozenset(acc)
        self._blk_cache = (cycle, banks)
        return banks

    def apply(self, cluster) -> None:
        """Apply every event scheduled for the cluster's current cycle.

        Called by the engine at the start of each full step; the bound
        contract guarantees a full step lands on every scheduled cycle, so
        events are never skipped (events scheduled before the run started
        are dropped as unreachable)."""
        evs = self.events
        i = self._next
        if i >= len(evs):
            return
        c = cluster.cycle
        while i < len(evs) and evs[i].cycle <= c:
            ev = evs[i]
            i += 1
            if ev.cycle == c:
                self._apply_one(ev, cluster)
        self._next = i

    @staticmethod
    def _stall_core(core, span: int) -> str:
        """Extend one core's countdown by ``span`` (stall/droop semantics);
        returns the per-core effect string."""
        state = core.state.name
        if state == "ACTIVE":
            core.busy = core.busy + span
        elif state == "WAKING":
            core.wake_countdown = core.wake_countdown + span
        else:
            return f"noop({state})"
        return "applied"

    def _apply_one(self, ev: FaultEvent, cluster) -> None:
        entry: Dict[str, Any] = {
            "cycle": ev.cycle, "kind": ev.kind, "core": ev.core,
            "effect": "applied",
        }
        if ev.domain:
            entry["domain"] = ev.domain
        if ev.kind == "lost_wake":
            scu = cluster.scu
            if scu is None:
                entry["effect"] = "noop(no scu)"
            else:
                scu.base.arm_drop(ev.core, ev.lines)
        elif ev.kind == "spurious_wake":
            scu = cluster.scu
            entry["line"] = ev.line
            if scu is None:
                entry["effect"] = "noop(no scu)"
            else:
                scu.base.ev_buf[ev.core] |= 1 << ev.line
        elif ev.kind == "stall":
            entry["span"] = ev.span
            entry["effect"] = self._stall_core(cluster.cores[ev.core], ev.span)
        elif ev.kind == "droop":
            # correlated droop: one stall applied to every core of the
            # domain at the same cycle
            entry["core"] = -1
            entry["span"] = ev.span
            entry["cores"] = list(ev.cores)
            effects = {
                cid: self._stall_core(cluster.cores[cid], ev.span)
                for cid in ev.cores
            }
            noops = sorted(c for c, e in effects.items() if e != "applied")
            if noops:
                entry["effect"] = f"partial(noop cores={noops})"
        elif ev.kind == "scu_blackout":
            # the window is enforced by scu_blacked() -- the SCU gates its
            # comparator evaluation and elw grant paths on it
            entry["core"] = -1
            entry["span"] = ev.span
            if cluster.scu is None:
                entry["effect"] = "noop(no scu)"
        else:  # bank_blackout: the window is enforced by blacked_banks()
            entry["core"] = -1
            entry["span"] = ev.span
            entry["banks"] = list(ev.banks)
        self.applied.append(entry)


# ---------------------------------------------------------------------------
# Watchdog: stuck-comparator detection + recovery
# ---------------------------------------------------------------------------


class Watchdog:
    """Stuck-comparator watchdog, owned by the SCU (``SCU(watchdog=...)``).

    *Engaged* whenever at least one core has an in-flight ``elw``
    transaction.  *Progress* is any SCU-visible activity: a register
    access, an ``elw`` trigger or grant, or a comparator generating events.
    When ``timeout`` cycles pass with waiters parked and zero progress:

    ``mode="release"``
        every parked waiter's latched wait mask is forced into its event
        buffer (bypassing any armed lost-wake drop), waking it as if the
        awaited comparator had fired.  After ``max_releases`` firings the
        watchdog escalates to a trip -- a comparator that stays stuck
        through repeated releases is a hard fault, not a lost edge.

    ``mode="raise"``
        the watchdog *trips*: it records a :class:`WaitForGraph` and stops.
        The engine surfaces the trip as a :class:`DeadlockError` right
        after the step (never mid-step -- a batched fleet step must finish
        for co-resident clusters).

    Timing is bit-exact across engine modes: the firing condition is a pure
    predicate over (cycle, last_progress), and :meth:`bound` feeds the SCU's
    ``next_event_bound`` so the fast-forward tiers step on exactly the
    firing cycle.
    """

    MODES = ("release", "raise")

    def __init__(self, timeout: int, mode: str = "release", max_releases: int = 8):
        if timeout < 1:
            raise ValueError(f"watchdog timeout must be >= 1, got {timeout}")
        if mode not in self.MODES:
            raise ValueError(f"watchdog mode must be one of {self.MODES}, got {mode!r}")
        if max_releases < 0:
            raise ValueError(f"max_releases must be >= 0, got {max_releases}")
        self.timeout = timeout
        self.mode = mode
        self.max_releases = max_releases
        self.last_progress = 0
        self.release_count = 0
        self.release_log: List[Dict[str, Any]] = []
        self.tripped: Optional[WaitForGraph] = None

    def due(self, cycle: int) -> bool:
        """True when the no-progress window has elapsed (and not tripped)."""
        return self.tripped is None and cycle - self.last_progress >= self.timeout

    def bound(self, cycle: int) -> Optional[int]:
        """Cycles until the watchdog could fire absent further progress
        (the fast-forward bound; safe because progress only delays it)."""
        if self.tripped is not None:
            return None
        return max(0, self.last_progress + self.timeout - cycle)

    def fire(self, scu, cycle: int) -> None:
        """Fire: force-release the parked waiters, or trip with a graph."""
        if self.mode == "release" and self.release_count < self.max_releases:
            released = sorted(scu._elw_pending)
            for cid in released:
                # straight into the buffer: a watchdog release must not be
                # eaten by an armed lost-wake drop filter
                scu.base.ev_buf[cid] |= scu.elw_wait[cid]
            self.release_count += 1
            self.release_log.append({"cycle": cycle, "cores": released})
            self.last_progress = cycle
            return
        self.tripped = build_wait_graph(scu.cluster)


# ---------------------------------------------------------------------------
# Wait-for graph: the structured deadlock diagnostic
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WaitForGraph:
    """Snapshot of who waits on what: per-core blocked micro-op, the
    armed/stuck comparator instances, and the fault events applied so far
    (the blame list).  Deterministic -- identical runs render identically,
    which the fleet/sequential error-message parity tests rely on."""

    cycle: int
    cores: List[Dict[str, Any]]
    comparators: List[str]
    faults: List[Dict[str, Any]]

    def describe(self) -> str:
        lines = [f"wait-for graph at cycle {self.cycle}:"]
        for c in self.cores:
            row = f"  core {c['core']}: {c['state']}"
            if c.get("op"):
                row += f" on {c['op']} {c['addr']}"
            lines.append(row)
        if self.comparators:
            lines.append("  armed/stuck comparators:")
            lines.extend(f"    {s}" for s in self.comparators)
        if self.faults:
            lines.append("  injected faults applied so far:")
            lines.extend(f"    {f}" for f in self.faults)
        return "\n".join(lines)


def build_wait_graph(cluster) -> WaitForGraph:
    """Build a :class:`WaitForGraph` from a cluster's current state (duck
    typed -- works on any Cluster regardless of engine mode or fleet
    membership, reading only bit-exact state)."""
    cores: List[Dict[str, Any]] = []
    for core in cluster.cores:
        entry: Dict[str, Any] = {"core": core.cid, "state": core.state.name}
        op = core.pending
        if op is not None:
            entry["op"] = type(op).__name__
            entry["addr"] = getattr(op, "addr", None)
        cores.append(entry)
    comparators: List[str] = []
    scu = getattr(cluster, "scu", None)
    if scu is not None:
        for b in scu.barriers:
            if b.status:
                comparators.append(
                    f"barrier[{b.index}] status={b.status:#x} "
                    f"workers={b.worker_mask:#x}"
                )
        for mx in scu.mutexes:
            if mx.owner is not None or mx.pending:
                comparators.append(
                    f"mutex[{mx.index}] owner={mx.owner} "
                    f"pending={list(mx.pending)}"
                )
        for fifo in scu.fifos:
            if fifo.fifo or fifo.poppers or fifo.pushers:
                comparators.append(
                    f"fifo[{fifo.index}] depth={len(fifo.fifo)} "
                    f"poppers={list(fifo.poppers)} pushers={list(fifo.pushers)}"
                )
        pend = sorted(getattr(scu, "_elw_pending", ()))
        if pend:
            comparators.append(f"elw pending cores={pend}")
    plan = getattr(cluster, "faults", None)
    faults = list(plan.applied) if plan is not None else []
    return WaitForGraph(
        cycle=cluster.cycle, cores=cores, comparators=comparators, faults=faults
    )
