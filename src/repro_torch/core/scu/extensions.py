"""SCU extensions: notifier, barrier, mutex, event FIFO (paper Sec. 4.3).

Own copy of ``repro/core/scu/extensions.py`` (the port imports nothing of
``repro``), line for line.

Extensions are shared blocks that generate *per-core* events; the per-core
events of all instances of one extension type are OR-combined onto a single
event line per type (Sec. 4.3, last paragraph) -- lines ``EV.BARRIER`` /
``EV.MUTEX`` / ``EV.FIFO`` / ``EV.NOTIFIER0..7``.

Fast-forward contract
---------------------
Every extension with an ``evaluate`` comparator also implements
``next_event_bound() -> Optional[int]`` -- the number of cycles until
``evaluate`` could generate an event *assuming no new core transaction
arrives*.  ``0`` means "could fire this cycle" (the engine must run a full
step), a positive ``k`` means "fires in exactly k cycles regardless of core
activity" (for timed comparators), and ``None`` means "cannot fire until
some core transaction re-arms it".  The bound must exactly mirror the
``evaluate`` firing condition, otherwise the event-driven engine would skip
over a comparator edge; ``tests/test_scu_simulator.py`` cross-checks the two
engine modes cycle-for-cycle.

Keeping an extension vectorization-safe
---------------------------------------
The structure-of-arrays engine core and the spin-phase batch resolver rely
on two additional properties beyond the bound contract:

1. **Armed-set maintenance.** The per-cycle ``SCU.evaluate`` only visits
   *armed* instances (those whose ``next_event_bound()`` is 0) -- the hot
   loop must not pay for idle comparators on a 256-core cluster with 128
   barrier instances.  Every mutation that can change an instance's firing
   condition must be followed by the matching ``SCU._*_touched`` re-derive
   (see :meth:`repro_torch.core.scu.scu_unit.SCU.access` / ``elw_trigger``): a
   comparator that arms itself silently will never be evaluated, and one
   that stays in the armed set while disarmed only wastes cycles.
2. **No hidden time dependence.** The spin-phase batch resolver jumps whole
   periods of pure TCDM polling whenever ``SCU.next_event_bound()`` is
   ``None``.  An extension whose ``evaluate`` depends on the cycle number
   (a timed comparator) must therefore return its positive bound from
   ``next_event_bound()`` -- returning ``None`` while counting cycles
   internally would let both fast paths jump over the firing edge.

Event delivery writes the per-core event buffers through the
``base_units`` handle, which is numpy-array backed
(:class:`repro_torch.core.scu.scu_unit.BaseUnits`): deliver to a *set* of cores
with ``base_units.deliver(line, mask)`` (vectorized) rather than a Python
loop when the target set scales with the cluster.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, Optional, Tuple

__all__ = ["Notifier", "Barrier", "Mutex", "EventFifo"]

_EV_BARRIER = 8
_EV_MUTEX = 9
_EV_FIFO = 10


@dataclasses.dataclass
class Notifier:
    """Any-to-any matrix-style core-to-core signaling (8 notifier events)."""

    n_cores: int

    def trigger(self, event: int, target_mask: int, base_units) -> None:
        assert 0 <= event < 8
        if target_mask == 0:  # all-zero -> broadcast (Sec. 4.3)
            target_mask = (1 << self.n_cores) - 1
        base_units.deliver(event, target_mask)


@dataclasses.dataclass
class Barrier:
    """Hardware barrier: worker/target masks + arrival status register.

    A *worker* subset must arrive; once ``status == worker_mask`` an event is
    generated for every core in the *target* subset and the status register
    clears (ready for immediate reuse -- barriers are commonly back-to-back).
    """

    index: int
    n_cores: int
    worker_mask: int = 0
    target_mask: int = 0
    status: int = 0

    def __post_init__(self):
        full = (1 << self.n_cores) - 1
        if self.worker_mask == 0:
            self.worker_mask = full
        if self.target_mask == 0:
            self.target_mask = full

    def arrive(self, cid: int, base_units) -> None:
        self.status |= 1 << cid

    def next_event_bound(self) -> Optional[int]:
        """0 while the arrival pattern is complete (fires now), else None:
        only a new arrival (a core transaction) can complete it."""
        if self.worker_mask and (self.status & self.worker_mask) == self.worker_mask:
            return 0
        return None

    def evaluate(self, base_units) -> int:
        if self.worker_mask and (self.status & self.worker_mask) == self.worker_mask:
            n = base_units.deliver(_EV_BARRIER, self.target_mask)
            self.status = 0
            return n
        return 0

    def state_key(self):
        """Hashable snapshot of every field ``evaluate`` reads or writes
        (the compiled-trace monitor's recurrence digest)."""
        return (self.worker_mask, self.target_mask, self.status)


@dataclasses.dataclass
class Mutex:
    """Hardware mutex: pending-request queue + election + message passing.

    ``try_lock`` registers a request; ``evaluate`` elects exactly one pending
    core when the mutex is free and sends it the mutex event.  ``unlock``
    releases and carries a 32-bit message delivered to the next elected core
    over the elw response channel (Sec. 5).
    """

    index: int
    n_cores: int
    owner: Optional[int] = None
    message: int = 0
    pending: Deque[int] = dataclasses.field(default_factory=deque)

    def try_lock(self, cid: int, base_units) -> None:
        if cid not in self.pending and self.owner != cid:
            self.pending.append(cid)

    def unlock(self, cid: int, message: int, base_units) -> None:
        if self.owner == cid:
            self.owner = None
            self.message = message

    def next_event_bound(self) -> Optional[int]:
        """0 while an election is possible (free + contenders), else None:
        progress needs an unlock or a new try_lock transaction."""
        return 0 if self.owner is None and self.pending else None

    def evaluate(self, base_units) -> int:
        if self.owner is None and self.pending:
            elected = self.pending.popleft()
            self.owner = elected
            base_units[elected].buffer_set(_EV_MUTEX)
            return 1
        return 0

    def state_key(self):
        """Hashable snapshot for the compiled-trace recurrence digest."""
        return (self.owner, self.message, tuple(self.pending))


@dataclasses.dataclass
class EventFifo:
    """Event queue over the async 8-bit event bus (paper Sec. 4.3).

    The paper's FIFO extension queues up to 256 cluster-external events; we
    generalize it to the core-facing producer-consumer discipline the FIFO
    exists to enable (Sec. 4.3 names fine-grain producer-consumer chains as
    the use case barriers serve poorly):

      * *producers* push an 8-bit event over a plain SCU write
        (``("fifo", i, "push")``) or :meth:`SCU.push_external_event`; a push
        to a full FIFO is dropped and counted (the hardware NACKs),
      * *blocking producers* issue an elw push (``("fifo", i, "push_wait")``
        with the event as data), which registers them as a pending pusher;
        the grant is withheld -- clock-gating the producer -- until the
        queue has room and accepts the event: native backpressure without a
        software credit queue,
      * *consumers* issue an elw pop (``("fifo", i, "pop")``) which registers
        them as a pending popper; the grant is withheld -- clock-gating the
        consumer -- until an event is matched to them,
      * :meth:`evaluate` moves one event through each port per cycle (the
        event-bus rate): it delivers the oldest queued event to the oldest
        pending popper (the value is latched into :attr:`messages` and
        returned over the elw response channel), then accepts the oldest
        pending pusher's event if the queue has room -- a pop and a push can
        complete in the same cycle, so a full queue with a waiting consumer
        still makes one item of progress per cycle.

    The non-blocking push keeps the NACK-and-count semantics; the sync
    policy built on top keeps occupancy bounded by construction (credit
    flow), so a nonzero :attr:`dropped` indicates a program bug.
    """

    index: int = 0
    depth: int = 16
    fifo: Deque[int] = dataclasses.field(default_factory=deque)
    poppers: Deque[int] = dataclasses.field(default_factory=deque)
    pushers: Deque[Tuple[int, int]] = dataclasses.field(default_factory=deque)
    messages: Dict[int, int] = dataclasses.field(default_factory=dict)
    dropped: int = 0
    pushed: int = 0

    def push(self, event_id: int) -> None:
        assert 0 <= event_id < 256
        if len(self.fifo) >= self.depth:
            self.dropped += 1
            return
        self.fifo.append(event_id)
        self.pushed += 1

    def pop(self) -> Optional[int]:
        """Direct (non-elw) drain, e.g. an external agent emptying the queue."""
        return self.fifo.popleft() if self.fifo else None

    def register_popper(self, cid: int) -> None:
        """elw-trigger hook: queue ``cid`` for the next available event."""
        if cid not in self.poppers and cid not in self.messages:
            self.poppers.append(cid)

    def register_pusher(self, cid: int, event_id: int) -> None:
        """elw-trigger hook (``push_wait``): queue ``cid``'s blocked push."""
        assert 0 <= event_id < 256
        if cid not in self.messages and all(c != cid for c, _ in self.pushers):
            self.pushers.append((cid, event_id))

    def take_message(self, cid: int) -> int:
        """elw-grant hook: consume the value latched for ``cid`` (the popped
        event for a consumer, the accepted event echoed back for a blocked
        producer).  A grant with no latched value returns 0: a spurious
        (injected) FIFO event or a watchdog force-release can wake a waiter
        the comparator never matched."""
        return self.messages.pop(cid, 0)

    def next_event_bound(self) -> Optional[int]:
        """0 while the comparator can move an event through either port this
        cycle -- a queued event matching a pending popper, or a blocked push
        fitting the queue (including the slot a same-cycle pop frees) --
        else None: only a core transaction can re-arm it."""
        if self.fifo and self.poppers:
            return 0
        if self.pushers and len(self.fifo) < self.depth:
            return 0
        return None

    def evaluate(self, base_units) -> int:
        n = 0
        if self.fifo and self.poppers:
            cid = self.poppers.popleft()
            self.messages[cid] = self.fifo.popleft()
            base_units[cid].buffer_set(_EV_FIFO)
            n += 1
        if self.pushers and len(self.fifo) < self.depth:
            cid, event_id = self.pushers.popleft()
            self.fifo.append(event_id)
            self.pushed += 1
            self.messages[cid] = event_id
            base_units[cid].buffer_set(_EV_FIFO)
            n += 1
        return n

    def state_key(self):
        """Hashable snapshot for the compiled-trace recurrence digest.

        Deliberately includes the monotone ``pushed``/``dropped`` counters:
        they are observable in benchmark output, so a state carrying them
        never recurs and FIFO-driven programs are simply never collapsed
        (correct by construction rather than by a special case)."""
        return (
            tuple(self.fifo), tuple(self.poppers), tuple(self.pushers),
            tuple(sorted(self.messages.items())), self.dropped, self.pushed,
        )
