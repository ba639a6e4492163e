"""SCU base units and top-level unit (paper Sec. 4.2-4.4).

Own copy of ``repro/core/scu/scu_unit.py`` (the port imports nothing of
``repro``), line for line.

One *base unit* per core provides:

  * 32 level-sensitive event lines latched into an *event buffer*,
  * an *event mask* (which buffered events allow elw to complete) and an
    *interrupt mask* (which trigger the irq FSM state; Sec. 5.1),
  * the active/sleep/interrupt FSM and the core clock-enable control --
    realized in :class:`repro_torch.core.scu.engine.Cluster` by the grant-withhold
    and wake sequencing driven from :meth:`SCU.elw_poll`.

The per-core registers are stored structure-of-arrays (numpy int64 vectors
indexed by core id) so the engine's vectorized kernels can scan event
buffers and wait masks for all cores at once; :class:`BaseUnit` is a
per-core view for the scalar paths and the extension API.

Extensions (notifier / barrier / mutex / event FIFO) are shared and generate
per-core events; see :mod:`repro_torch.core.scu.extensions`.  The SCU tracks which
extension instances are *armed* (comparator could fire without a new core
transaction) at the mutation points, so the per-cycle :meth:`SCU.evaluate`
and the fast-forward :meth:`SCU.next_event_bound` touch only armed instances
-- on a 256-core cluster with 128 barrier and 520 FIFO instances the engine
hot loop must not pay for idle comparators.

Addressing: the real SCU aliases a 1 Kibit address space per core over the
private links.  We model addresses symbolically as tuples, e.g.::

    ("barrier", 0, "wait_all")      elw: arrive + sleep until barrier fires
    ("mutex", 0, "lock")            elw: try-lock, sleep until elected
    ("mutex", 0, "unlock")          write: release, wake next waiter
    ("notifier", 3, "trigger")      write: send event 3 to mask in data
    ("notifier", 3, "wait")         elw: sleep until notifier event 3
    ("fifo", 2, "push")             write: push event (data) into FIFO 2
    ("fifo", 2, "push_wait")        elw: blocking push -- sleep until the
                                    queue accepts the event in data
    ("fifo", 2, "pop")              elw: sleep until an event is matched,
                                    response carries the popped value
    ("fifo", 2, "level")            read: current FIFO occupancy
    ("event", "wait_any")           elw: sleep until any masked event
    ("mask", "event")               write: set event mask
    ("buffer", "clear")             write: clear event buffer bits in data

Event line allocation (32 lines, Sec. 4.2):
  0..7    notifier events 0..7
  8       barrier event (per-core OR over all barrier instances, Sec. 4.3)
  9       mutex event (OR over all mutex instances)
  10      event-FIFO non-empty
  11..31  external / specialized-PE events (available to users)
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np

from .extensions import Barrier, EventFifo, Mutex, Notifier

__all__ = ["EV", "BaseUnit", "BaseUnits", "SCU"]


class EV:
    """Event line numbers."""

    NOTIFIER0 = 0  # .. NOTIFIER7 = 7
    BARRIER = 8
    MUTEX = 9
    FIFO = 10
    EXT0 = 11


class BaseUnit:
    """Per-core view of the structure-of-arrays base-unit registers."""

    __slots__ = ("cid", "_U")

    def __init__(self, cid: int, units: "BaseUnits"):
        self.cid = cid
        self._U = units

    # -- register access ----------------------------------------------------
    @property
    def event_buffer(self) -> int:
        return int(self._U.ev_buf[self.cid])

    @event_buffer.setter
    def event_buffer(self, value: int) -> None:
        self._U.ev_buf[self.cid] = value

    @property
    def event_mask(self) -> int:
        return int(self._U.ev_mask[self.cid])

    @event_mask.setter
    def event_mask(self, value: int) -> None:
        self._U.ev_mask[self.cid] = value

    @property
    def irq_mask(self) -> int:
        return int(self._U.irq_mask[self.cid])

    @irq_mask.setter
    def irq_mask(self, value: int) -> None:
        self._U.irq_mask[self.cid] = value

    @property
    def notifier_target_mask(self) -> int:
        return int(self._U.ntf_target[self.cid])

    @notifier_target_mask.setter
    def notifier_target_mask(self, value: int) -> None:
        self._U.ntf_target[self.cid] = value

    def buffer_set(self, line: int) -> None:
        U = self._U
        if U._drop_armed:
            bit = 1 << line
            if U.drop[self.cid] & bit:
                # armed lost-wake fault: this delivery is silently eaten
                U.drop[self.cid] &= ~bit
                U.dropped_events += 1
                if not U.drop.any():
                    U._drop_armed = False
                return
        U.ev_buf[self.cid] |= 1 << line

    def buffer_clear(self, bits: int) -> None:
        self._U.ev_buf[self.cid] &= ~bits

    def pending_masked(self) -> int:
        return self.event_buffer & self.event_mask

    def pending_irq(self) -> int:
        return self.event_buffer & self.irq_mask


class BaseUnits:
    """All per-core base-unit registers, structure-of-arrays (Sec. 4.2).

    Sequence of :class:`BaseUnit` views for the per-core API; the numpy
    vectors (``ev_buf``, ``ev_mask``, ...) are the storage and what the
    vectorized engine kernels and extension deliveries operate on.
    """

    __slots__ = (
        "n_cores", "ev_buf", "ev_mask", "irq_mask", "ntf_target", "_views",
        "drop", "dropped_events", "_drop_armed",
    )

    def __init__(self, n_cores: int):
        self.n_cores = n_cores
        self.ev_buf = np.zeros(n_cores, dtype=np.int64)
        self.ev_mask = np.zeros(n_cores, dtype=np.int64)
        self.irq_mask = np.zeros(n_cores, dtype=np.int64)
        self.ntf_target = np.zeros(n_cores, dtype=np.int64)
        self._views = [BaseUnit(i, self) for i in range(n_cores)]
        # lost-wake fault filter (repro_torch.core.scu.faults): per-core one-shot
        # drop masks -- the next delivery of a dropped line to that core is
        # suppressed and the armed bit consumed.  ``_drop_armed`` keeps the
        # fault-free delivery fast path branch-cheap.  Deliberately NOT part
        # of adopt_views: drops are per-tenant state and must never leak
        # across slot recycling.
        self.drop = np.zeros(n_cores, dtype=np.int64)
        self.dropped_events = 0
        self._drop_armed = False

    def arm_drop(self, cid: int, lines: int = 0xFFFFFFFF) -> None:
        """Arm a one-shot lost-wake filter: the next delivery of any line in
        ``lines`` to core ``cid`` is suppressed (one line consumed per hit)."""
        self.drop[cid] |= lines
        self._drop_armed = True

    def __len__(self) -> int:
        return self.n_cores

    def __getitem__(self, cid: int) -> BaseUnit:
        return self._views[cid]

    def __iter__(self):
        return iter(self._views)

    def target_bools(self, target_mask: int) -> np.ndarray:
        """Decode a core bitmask (arbitrary precision) into a bool vector."""
        n = self.n_cores
        raw = target_mask.to_bytes((n + 7) // 8, "little")
        return np.unpackbits(
            np.frombuffer(raw, dtype=np.uint8), bitorder="little"
        )[:n].astype(bool)

    def deliver(self, line: int, target_mask: int) -> int:
        """Set event ``line`` in every targeted core's buffer (vectorized);
        returns the number of events actually delivered (armed lost-wake
        drops suppress their target and are excluded from the count)."""
        full = (1 << self.n_cores) - 1
        target_mask &= full
        if self._drop_armed:
            return self._deliver_filtered(line, target_mask)
        if target_mask == full:
            self.ev_buf |= 1 << line
            return self.n_cores
        targets = self.target_bools(target_mask)
        self.ev_buf[targets] |= 1 << line
        return int(targets.sum())

    def _deliver_filtered(self, line: int, target_mask: int) -> int:
        """Delivery with the lost-wake drop filter armed (fault injection)."""
        bit = 1 << line
        targets = self.target_bools(target_mask)
        victims = targets & ((self.drop & bit) != 0)
        if victims.any():
            hit = targets & ~victims
            self.ev_buf[hit] |= bit
            self.drop[victims] &= ~bit
            self.dropped_events += int(victims.sum())
            if not self.drop.any():
                self._drop_armed = False
            return int(hit.sum())
        self.ev_buf[targets] |= bit
        return int(targets.sum())


class SCU:
    """Top-level synchronization and communication unit.

    Parameters mirror the paper's design-time knobs: ``n_barriers``
    (:math:`N_B`, paper default ``n_cores/2``) and ``n_mutexes``
    (:math:`N_{Mx}`, paper default 1).
    """

    def __init__(
        self,
        n_cores: int,
        n_barriers: Optional[int] = None,
        n_mutexes: int = 1,
        fifo_depth: Optional[int] = None,
        n_fifos: Optional[int] = None,
        watchdog=None,
    ):
        self.n_cores = n_cores
        n_barriers = max(1, n_cores // 2) if n_barriers is None else n_barriers
        # FIFO defaults scale with the cluster so the producer-consumer
        # discipline (per-core release queues + per-link chain queues, see
        # repro/sync/fifo.py) fits without per-benchmark tuning.
        if fifo_depth is None:
            fifo_depth = max(16, 2 * n_cores)
        if n_fifos is None:
            n_fifos = 2 * n_cores + 8
        self.base = BaseUnits(n_cores)
        self.barriers: List[Barrier] = [
            Barrier(index=i, n_cores=n_cores) for i in range(n_barriers)
        ]
        self.mutexes: List[Mutex] = [
            Mutex(index=i, n_cores=n_cores) for i in range(n_mutexes)
        ]
        self.notifier = Notifier(n_cores=n_cores)
        self.fifos: List[EventFifo] = [
            EventFifo(index=i, depth=fifo_depth) for i in range(n_fifos)
        ]
        # instance 0 doubles as the legacy cluster-external event queue
        self.fifo = self.fifos[0]
        # Armed-instance tracking: an extension instance is armed when its
        # comparator could fire without a new core transaction
        # (next_event_bound() == 0).  Maintained at the mutation points
        # (arrivals, lock/unlock, push/pop registration, delivery) so the
        # per-cycle evaluate and the fast-forward bound scan touch only
        # armed instances -- the engine hot loop must not pay for idle
        # extensions (see the extensions.py module docstring).
        self._armed_barriers: set = set()
        self._armed_mutexes: set = set()
        self._armed_fifos: set = set()
        self.cluster = None
        # Wait mask of each core's in-flight elw, latched at trigger time
        # (the mask cannot change while the core is stalled/asleep on the
        # elw): lets the engine scan all pending elws against the event
        # buffers in one vectorized pass.
        self.elw_wait = np.zeros(n_cores, dtype=np.int64)
        # Stuck-comparator watchdog (repro_torch.core.scu.faults.Watchdog) and the
        # cores with an in-flight elw it guards.  Progress = any SCU-visible
        # activity (access / trigger / grant / comparator event); the
        # watchdog's bound rides next_event_bound() so the fast-forward
        # tiers land exactly on the firing cycle.
        self.watchdog = watchdog
        self._elw_pending: set = set()

    # ----------------------------------------------------------------- wiring
    def attach(self, cluster) -> None:
        self.cluster = cluster

    def state_key(self):
        """Hashable snapshot of the complete SCU state.

        Used by the compiled-trace monitor (:mod:`repro_torch.core.scu.trace`) as
        part of its whole-cluster recurrence digest: two equal keys mean the
        unit will evolve identically from both points.  Covers the per-core
        register file, every extension instance's own ``state_key`` and the
        latched elw wait masks; the armed sets are derivable from extension
        state and the drop filter is fault-only (the monitor is disabled
        under fault plans), so neither is included."""
        base = self.base
        return (
            base.ev_buf.tobytes(), base.ev_mask.tobytes(),
            base.irq_mask.tobytes(), base.ntf_target.tobytes(),
            self.elw_wait.tobytes(), frozenset(self._elw_pending),
            tuple(b.state_key() for b in self.barriers),
            tuple(m.state_key() for m in self.mutexes),
            tuple(f.state_key() for f in self.fifos),
        )

    def adopt_views(
        self,
        ev_buf: np.ndarray,
        ev_mask: np.ndarray,
        irq_mask: np.ndarray,
        ntf_target: np.ndarray,
        elw_wait: np.ndarray,
    ) -> None:
        """Re-home the per-core register storage onto caller-provided views.

        Used by the fleet engine (:func:`repro_torch.core.scu.engine.simulate_fleet`)
        to partition the base-unit registers of many independent clusters as
        contiguous segments of flattened fleet-level arrays: this SCU keeps
        operating on its own cores only (the views span exactly its
        segment), while the fleet's batched kernels scan every config's
        event buffers and latched elw wait masks in one pass.  Current
        register contents are copied into the views before binding."""
        views = (ev_buf, ev_mask, irq_mask, ntf_target, elw_wait)
        currents = (
            self.base.ev_buf, self.base.ev_mask, self.base.irq_mask,
            self.base.ntf_target, self.elw_wait,
        )
        for view, cur in zip(views, currents):
            if view.shape != cur.shape:
                raise ValueError(
                    f"adopt_views: shape {view.shape} != {cur.shape}"
                )
            view[:] = cur
        self.base.ev_buf, self.base.ev_mask = ev_buf, ev_mask
        self.base.irq_mask, self.base.ntf_target = irq_mask, ntf_target
        self.elw_wait = elw_wait

    # ------------------------------------------------------------ plain access
    def _progress(self) -> None:
        """Record SCU-visible activity for the watchdog's progress clock."""
        wd = self.watchdog
        if wd is not None and self.cluster is not None:
            wd.last_progress = self.cluster.cycle

    def access(self, cid: int, kind: str, addr: Any, data: int = 0) -> Optional[int]:
        """Single-cycle read/write over the private link (non-elw)."""
        if self.watchdog is not None:
            self._progress()
        unit = self.base[cid]
        tag = addr[0]
        if kind == "write":
            if tag == "mask":
                if addr[1] == "event":
                    unit.event_mask = data
                else:
                    unit.irq_mask = data
            elif tag == "buffer":
                unit.buffer_clear(data)
            elif tag == "notifier":
                self.notifier.trigger(addr[1], data, self.base)
            elif tag == "mutex":
                if addr[2] == "unlock":
                    self.mutexes[addr[1]].unlock(cid, data, self.base)
                    self._mutex_touched(addr[1])
            elif tag == "barrier":
                b = self.barriers[addr[1]]
                if addr[2] == "workers":
                    b.worker_mask = data
                elif addr[2] == "targets":
                    b.target_mask = data
                elif addr[2] == "arrive_only":
                    # non-blocking arrival (producer that does not wait)
                    b.arrive(cid, self.base)
                self._barrier_touched(addr[1])
            elif tag == "fifo":
                if addr[2] == "push":
                    self.fifos[addr[1]].push(data)
                    self._fifo_touched(addr[1])
            elif tag == "target_reg":
                unit.notifier_target_mask = data
            return None
        else:  # read
            if tag == "buffer":
                return unit.event_buffer
            if tag == "barrier":
                return self.barriers[addr[1]].status
            if tag == "mutex":
                return 1 if self.mutexes[addr[1]].owner is not None else 0
            if tag == "fifo":
                return len(self.fifos[addr[1]].fifo)  # occupancy level
            return 0

    # ------------------------------------------------------------------ elw
    def elw_trigger(self, cid: int, addr: Any, data: int = 0) -> None:
        """Extension side-effect of an elw transaction (fires exactly once)."""
        tag = addr[0]
        if tag == "barrier":
            if addr[2] in ("wait_all", "arrive_wait"):
                self.barriers[addr[1]].arrive(cid, self.base)
                self._barrier_touched(addr[1])
            # addr[2] == "wait": pure target wait, no arrival
        elif tag == "mutex":
            self.mutexes[addr[1]].try_lock(cid, self.base)
            self._mutex_touched(addr[1])
        elif tag == "fifo":
            if addr[2] == "push_wait":
                # blocking push: queue as a pending pusher; the comparator
                # accepts the event once the queue has room, generating the
                # producer's wake event (backpressure without credits)
                self.fifos[addr[1]].register_pusher(cid, data)
            else:
                # blocking pop: queue as a popper; the FIFO comparator
                # matches queued events to poppers one per cycle
                self.fifos[addr[1]].register_popper(cid)
            self._fifo_touched(addr[1])
        elif tag == "notifier" and addr[2] == "trigger_wait":
            # read-triggered notify using the per-core target register
            self.notifier.trigger(addr[1], self.base[cid].notifier_target_mask, self.base)
        # ("event","wait_any") and ("notifier", n, "wait"): no trigger action
        self.elw_wait[cid] = self._wait_mask(cid, addr)
        self._elw_pending.add(cid)
        if self.watchdog is not None:
            self._progress()

    def _wait_mask(self, cid: int, addr: Any) -> int:
        tag = addr[0]
        if tag == "barrier":
            return 1 << EV.BARRIER
        if tag == "mutex":
            return 1 << EV.MUTEX
        if tag == "fifo":
            return 1 << EV.FIFO
        if tag == "notifier":
            return 1 << (EV.NOTIFIER0 + addr[1])
        if tag == "event":
            return self.base[cid].event_mask or 0xFFFFFFFF
        raise ValueError(addr)

    def scu_blacked(self, cycle: Optional[int] = None) -> bool:
        """True while an injected ``scu_blackout`` fault window covers the
        cluster's current cycle (see :class:`repro_torch.core.scu.faults.FaultEvent`):
        comparators neither evaluate nor grant.  Triggers still latch and
        deliveries still buffer -- the armed state replays on the first
        ungated evaluate after the window, and buffered grants release then.
        The fault plan pins its ``next_event_bound`` to 0 through the whole
        window, so every engine tier takes full steps across it and the
        gating stays bit-exact between lockstep and fastforward."""
        cl = self.cluster
        if cl is None:
            return False
        plan = getattr(cl, "faults", None)
        if plan is None:
            return False
        return plan.scu_blacked(cl.cycle if cycle is None else cycle)

    def elw_would_grant(self, cid: int, addr: Any) -> bool:
        """Side-effect-free preview of :meth:`elw_poll`'s grant decision.

        Used by the fast-forward scheduler: a sleeping core whose waited-on
        event is not buffered cannot wake during a quiescent span (events are
        only generated by core transactions or armed comparators, both of
        which force a full step)."""
        if self.scu_blacked():
            return False
        return bool(self.base.ev_buf[cid] & self._wait_mask(cid, addr))

    def elw_any_grantable(self, cids: np.ndarray) -> bool:
        """Vectorized :meth:`elw_would_grant` over cores with in-flight elws."""
        if self.scu_blacked():
            return False
        return bool(np.any(self.base.ev_buf[cids] & self.elw_wait[cids]))

    def elw_grantable_mask(self, cids: np.ndarray) -> np.ndarray:
        """Bool mask over ``cids``: whose waited-on event is buffered now."""
        if self.scu_blacked():
            return np.zeros(len(cids), dtype=bool)
        return (self.base.ev_buf[cids] & self.elw_wait[cids]) != 0

    def elw_poll(self, cid: int, addr: Any) -> Tuple[bool, int]:
        """Grant decision for a pending elw; returns (granted, response)."""
        if self.scu_blacked():
            return False, 0
        unit = self.base[cid]
        wait_mask = self._wait_mask(cid, addr)
        hit = unit.event_buffer & wait_mask
        if not hit:
            return False, 0
        # Response channel data (Sec. 5): mutex passes the 32-bit message of
        # the unlocking core, a FIFO pop/push_wait returns the matched event
        # value; otherwise the event buffer content is returned.
        if addr[0] == "mutex":
            value = self.mutexes[addr[1]].message
        elif addr[0] == "fifo":
            value = self.fifos[addr[1]].take_message(cid)
        else:
            value = unit.event_buffer
        # Auto-clear (address-controlled in hardware; we always auto-clear the
        # lines belonging to the waited-on extension, the common case).
        unit.buffer_clear(wait_mask)
        self._elw_pending.discard(cid)
        if self.watchdog is not None:
            self._progress()
        return True, value

    # ------------------------------------------------------------- evaluate
    def evaluate(self, cycle: int) -> int:
        """Per-cycle extension evaluation -> event generation (phase 0).

        Only armed instances are visited; the armed sets are maintained at
        the mutation points (see the class docstring), and re-derived after
        each evaluation because firing usually disarms the comparator.
        During an injected ``scu_blackout`` window the comparator visits are
        gated (armed state persists and replays at window end); the watchdog
        branch still runs -- a blackout reads as zero progress, which is
        exactly the escalation signal the service layer quarantines on."""
        n = 0
        if self.scu_blacked(cycle):
            wd = self.watchdog
            if wd is not None and self._elw_pending and wd.due(cycle):
                wd.fire(self, cycle)
            return 0
        if self._armed_barriers:
            for idx in sorted(self._armed_barriers):
                n += self.barriers[idx].evaluate(self.base)
                self._barrier_touched(idx)
        if self._armed_mutexes:
            for idx in sorted(self._armed_mutexes):
                n += self.mutexes[idx].evaluate(self.base)
                self._mutex_touched(idx)
        if self._armed_fifos:
            for idx in sorted(self._armed_fifos):
                n += self.fifos[idx].evaluate(self.base)
                self._fifo_touched(idx)
        wd = self.watchdog
        if wd is not None:
            if n:
                wd.last_progress = cycle
            elif self._elw_pending and wd.due(cycle):
                wd.fire(self, cycle)
        return n

    def watchdog_due(self, cycle: int) -> bool:
        """True when the watchdog deadline has elapsed with waiters parked
        (the fleet step's phase-0 gate: evaluate must run so the watchdog
        can fire even with every comparator disarmed)."""
        wd = self.watchdog
        return wd is not None and bool(self._elw_pending) and wd.due(cycle)

    def next_event_bound(self) -> Optional[int]:
        """Min over the armed extensions' ``next_event_bound`` hooks (see
        :mod:`repro_torch.core.scu.extensions` for the contract): cycles until any
        comparator could generate an event absent new core transactions.
        0 forces the engine to take a full step; ``None`` means every
        comparator is disarmed until a core acts.  All builtin extensions
        have 0/None bounds, so armed-set membership is the whole answer --
        plus, when a watchdog guards parked elw waiters, its (timed)
        deadline: progress only ever pushes the firing later, so the bound
        never over-estimates."""
        if self._armed_barriers or self._armed_mutexes or self._armed_fifos:
            return 0
        wd = self.watchdog
        if wd is not None and self._elw_pending and self.cluster is not None:
            return wd.bound(self.cluster.cycle)
        return None

    def _barrier_touched(self, idx: int) -> None:
        """Re-derive barrier ``idx``'s armed state after a mutation."""
        if self.barriers[idx].next_event_bound() == 0:
            self._armed_barriers.add(idx)
        else:
            self._armed_barriers.discard(idx)

    def _mutex_touched(self, idx: int) -> None:
        """Re-derive mutex ``idx``'s armed state after a mutation."""
        if self.mutexes[idx].next_event_bound() == 0:
            self._armed_mutexes.add(idx)
        else:
            self._armed_mutexes.discard(idx)

    def _fifo_touched(self, idx: int) -> None:
        """Re-derive FIFO ``idx``'s armed state after a mutation."""
        if self.fifos[idx].next_event_bound() == 0:
            self._armed_fifos.add(idx)
        else:
            self._armed_fifos.discard(idx)

    # ------------------------------------------------------------- external
    def push_external_event(self, event_id: int) -> None:
        self.fifo.push(event_id)
        self._fifo_touched(0)
