"""The micro-ops that simulator programs yield: the op records of ``repro``'s engine.

Copy of the records ``Compute``, ``Mem``, ``Poll`` and ``Scu`` of
``repro/core/scu/engine.py``, field for field, so that the port's sync
fragments (``primitives``, ``repro_torch.sync``) are written against the
same records, and of ``_COUNTERS``, the nine per-core counters in the
engine's order, which the trace executor (``trace_exec``) returns.  The
engine itself, which resolves arbitration, SCU events and clock gating over
these records, is not ported: it is numpy, and it is the oracle that the
trace executor is held to.
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["Compute", "Mem", "Poll", "Scu"]

# The per-core counters, in the order of ``repro/core/scu/engine.py``'s ``_COUNTERS``.
_COUNTERS = (
    "active_cycles",
    "comp_cycles",
    "wait_cycles",
    "gated_cycles",
    "stall_cycles",
    "instructions",
    "tcdm_accesses",
    "tas_accesses",
    "scu_accesses",
)


@dataclasses.dataclass
class Compute:
    """``cycles`` of core-local work (ALU/regfile only, no memory traffic)."""

    cycles: int


@dataclasses.dataclass
class Mem:
    """A TCDM transaction through the LINT.

    kind:
      ``lw``  -- load word (single cycle when granted; contention stalls)
      ``sw``  -- store word
      ``tas`` -- atomic test-and-set: returns current value, writes -1.
                 Occupies the bank for the engine's TAS cycles ("TAS
                 transactions take just three cycles", Sec. 4.1).
    """

    kind: str
    addr: int
    data: int = 0


@dataclasses.dataclass
class Poll:
    """A declarative spin/poll loop on one TCDM word, resolved engine-native.

    Stands in -- cycle- and stats-exact -- for the classic expanded loop::

        while True:
            v = yield Mem(kind, addr)     # "lw" poll or "tas" lock attempt
            yield Compute(hit_cycles)     # value check after the load
            if v == until:
                break
            yield Compute(miss_cycles - hit_cycles)   # branch back, retry

    Each granted access returning ``v != until`` burns ``miss_cycles`` ACTIVE
    cycles (plus the TAS busy time for ``kind="tas"``) and re-enters the bank
    queue; the access returning ``until`` burns ``hit_cycles`` and then
    resumes the program with that value.  Instruction accounting mirrors the
    expanded loop: ``miss_instr`` instructions per retry round on top of the
    re-issued load, ``hit_instr`` on the exit path.
    """

    kind: str
    addr: int
    until: int
    hit_cycles: int
    miss_cycles: int
    hit_instr: int = 1
    miss_instr: int = 2


@dataclasses.dataclass
class Scu:
    """A transaction on the private core<->SCU link (single cycle, Sec. 4.4).

    kind:
      ``elw``   -- event-load-word (Sec. 5): read `addr` in the aliased SCU
                   space; the SCU withholds the grant until a masked-in event
                   is buffered, clock-gating the core meanwhile.  The read
                   response carries extension-specific data.
      ``read``  -- plain (non-blocking) read of an SCU register.
      ``write`` -- plain write (mutex unlock, notifier trigger, mask setup...).
    """

    kind: str
    addr: Any
    data: int = 0
