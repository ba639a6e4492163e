"""The three synchronization-primitive implementations compared by the paper.

Own copy of ``repro/core/scu/primitives.py`` (the port imports nothing of
``repro``); ``tests/test_torch_sync_sim.py`` runs these fragments in
``repro``'s simulator and holds them to the originals cycle for cycle.  The
deprecated ``VARIANTS`` spelling of the reference is not carried over: the
list of disciplines is ``repro_torch.sync.available_policies()``.

* ``SW``  -- pure software: spin-locks on TAS-protected L1 variables
             (Sec. 6.1, "purely spin-lock based").
* ``TAS`` -- software + idle-waiting: failed contenders sleep on an SCU
             notifier event; the releasing core broadcasts a notifier
             (Sec. 6.1, second baseline).
* ``SCU`` -- the paper's contribution: single-``elw`` hardware barrier /
             mutex (Sec. 5).

Each primitive is a generator *fragment* whose instruction footprint follows
the paper's description (Sec. 6.3): SW lock attempt = 2 instructions, TAS
retry = 5 instructions incl. idle-wait handling, SCU = 1 instruction (plus
address setup); leaving a critical section = 1 instruction (SW/SCU) vs 2
(TAS).  On top of the raw instruction counts, :class:`CostModel` charges the
micro-architectural overheads of the RI5CY-class in-order cores the paper
uses (taken-branch penalty, load-use stall, call/return + local-sense
bookkeeping) -- its defaults are calibrated against Table 1 (see
``benchmarks/table1_primitives.py`` for the validation).

TCDM layout: synchronization variables live in distinct words (and hence,
with word interleaving, distinct banks) to avoid artificial bank conflicts --
matching how a real runtime lays them out.
"""

from __future__ import annotations

import dataclasses
from typing import Generator

from .engine import Compute, Mem, Poll, Scu

__all__ = [
    "CostModel",
    "DEFAULT_COSTS",
    "BarrierState",
    "sw_barrier",
    "tas_barrier",
    "scu_barrier",
    "sw_mutex_section",
    "tas_mutex_section",
    "scu_mutex_section",
    "trace_sw_barrier_body",
    "trace_tas_mutex_section",
]

# --- shared-variable addresses (word-aligned; word-interleaved banks) -------
A_BAR_LOCK = 0x100
A_BAR_COUNT = 0x104
A_BAR_SENSE = 0x108
A_MUTEX = 0x10C

_TAS_FREE = 0  # TAS returns the stored value and writes -1; 0 == free


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Micro-architectural cycle charges for the software primitives.

    Calibrated so the simulated Table-1 costs match the paper (RI5CY-class
    4-stage in-order pipeline: taken branches flush ~2 extra cycles, loads
    have a 1-cycle load-use shadow, primitives are called functions that
    maintain a local sense / queue state).
    """

    branch_taken: int = 2  # extra cycles for a taken branch
    load_use: int = 1  # load-to-use interlock
    call: int = 3  # call + prologue of the (non-inlined parts of) primitive
    ret: int = 2  # epilogue + return
    sense_setup: int = 5  # local-sense flip: lw/xori/sw + core-id indexing
    mask_setup: int = 2  # event-mask + elw address setup on the TAS path
    crit_extra: int = 8  # runtime bookkeeping inside the barrier lock
    # (team state / barrier-id address computation on the shared state --
    # the core-id-dependent address calculation the SCU removes, Sec. 2).
    # Values fitted against the paper's Table 1 (see benchmarks/
    # table1_primitives.py); barrier rows match within ~4%.


DEFAULT_COSTS = CostModel()


class BarrierState:
    """Per-run software-barrier bookkeeping shared by all cores.

    Holds the *local sense* of every core for the sense-reversal barrier.
    The actual counter/sense/lock words live in simulated TCDM.
    """

    def __init__(self, n_cores: int):
        self.n_cores = n_cores
        self.local_sense = [0] * n_cores


# ---------------------------------------------------------------------------
# Barriers
# ---------------------------------------------------------------------------


def _sw_barrier_body(cl, cid: int, st: BarrierState, cm: CostModel, idle_wait: bool):
    """Sense-reversal barrier on a TAS-protected counter (SW / TAS variants)."""
    n = st.n_cores
    sense = st.local_sense[cid] ^ 1
    st.local_sense[cid] = sense
    yield Compute(cm.call + cm.sense_setup)
    # -- acquire the barrier lock: "2 instructions per locking attempt" ------
    # (declarative TAS spin: bnez falls through on the free value, else the
    # taken branch loops back to the atomic -- see engine.Poll)
    yield Poll(
        "tas", A_BAR_LOCK, until=_TAS_FREE,
        hit_cycles=1, miss_cycles=1 + cm.branch_taken,
        hit_instr=1, miss_instr=1,
    )
    # -- critical: bump the arrival counter ----------------------------------
    if cm.crit_extra > 0:
        yield Compute(cm.crit_extra)  # team state / barrier-id bookkeeping
    c = yield Mem("lw", A_BAR_COUNT)
    yield Compute(1 + cm.load_use)  # addi after load-use shadow
    if c + 1 == n:
        # last arrival: reset counter, flip shared sense, release the lock
        yield Compute(1)  # beq taken on the count compare
        yield Mem("sw", A_BAR_COUNT, 0)
        yield Mem("sw", A_BAR_SENSE, sense)
        yield Mem("sw", A_BAR_LOCK, 0)
        if idle_wait:
            yield Scu("write", ("notifier", 0, "trigger"), 0)  # broadcast wake
        yield Compute(cm.ret)
    else:
        yield Compute(1)  # bne not taken
        yield Mem("sw", A_BAR_COUNT, c + 1)
        yield Mem("sw", A_BAR_LOCK, 0)
        if idle_wait:
            # idle-wait + re-check loop ("five instructions" per retry)
            while True:
                s = yield Mem("lw", A_BAR_SENSE)
                yield Compute(1 + cm.load_use)
                if s == sense:
                    break
                yield Compute(cm.mask_setup)
                yield Scu("elw", ("notifier", 0, "wait"))
                yield Compute(1 + cm.branch_taken)  # loop back to re-check
        else:
            # -- spin on the sense word (busy waiting) -----------------------
            # (declarative lw spin: load + check each round, bne taken back
            # to the poll on a miss -- see engine.Poll)
            yield Poll(
                "lw", A_BAR_SENSE, until=sense,
                hit_cycles=1 + cm.load_use,
                miss_cycles=1 + cm.load_use + cm.branch_taken,
                hit_instr=1, miss_instr=2,
            )
        yield Compute(cm.ret)


def sw_barrier(cl, cid: int, st: BarrierState, cm: CostModel = DEFAULT_COSTS):
    yield from _sw_barrier_body(cl, cid, st, cm, idle_wait=False)


def tas_barrier(cl, cid: int, st: BarrierState, cm: CostModel = DEFAULT_COSTS):
    yield from _sw_barrier_body(cl, cid, st, cm, idle_wait=True)


def scu_barrier(cl, cid: int, barrier_id: int = 0) -> Generator:
    """Hardware barrier: address setup + a single elw (Sec. 5, Fig. 4)."""
    yield Compute(1)  # elw address calculation (counted by the paper)
    yield Scu("elw", ("barrier", barrier_id, "wait_all"))


# ---------------------------------------------------------------------------
# Critical sections (mutex)
# ---------------------------------------------------------------------------


def sw_mutex_section(
    cl, cid: int, t_crit: int, cm: CostModel = DEFAULT_COSTS
) -> Generator:
    """Spin-lock entry, ``t_crit`` cycles of work, single-store exit."""
    yield Poll(
        "tas", A_MUTEX, until=_TAS_FREE,
        hit_cycles=1, miss_cycles=1 + cm.branch_taken,
        hit_instr=1, miss_instr=1,
    )
    if t_crit > 0:
        yield Compute(t_crit)
    yield Mem("sw", A_MUTEX, 0)


def tas_mutex_section(
    cl, cid: int, t_crit: int, cm: CostModel = DEFAULT_COSTS
) -> Generator:
    """TAS entry with notifier idle-wait; exit = store + notifier (2 instr).

    Failed contenders sleep on a notifier event; on wake-up they *re-test*
    the variable with a plain load first ("quickly wake up and re-test the
    TAS-variable, with all but the elected one immediately going back to
    sleep", Sec. 6.3) -- a test-and-test-and-set that keeps the thundering
    herd off the TAS bank.
    """
    v = yield Mem("tas", A_MUTEX)
    first = True
    while v != _TAS_FREE:
        if first:
            yield Compute(1 + cm.branch_taken)  # bnez taken into the wait path
            first = False
        # "five instructions ... to handle the idle-wait functionality"
        yield Compute(cm.mask_setup)
        yield Scu("elw", ("notifier", 1, "wait"))
        t = yield Mem("lw", A_MUTEX)  # re-test before the atomic
        yield Compute(1 + cm.load_use)
        if t != _TAS_FREE:
            yield Compute(cm.branch_taken)
            continue  # someone else was elected; back to sleep
        v = yield Mem("tas", A_MUTEX)
    yield Compute(1)  # bnez falls through
    if t_crit > 0:
        yield Compute(t_crit)
    yield Mem("sw", A_MUTEX, 0)
    yield Scu("write", ("notifier", 1, "trigger"), 0)  # wake the queued cores


def scu_mutex_section(
    cl, cid: int, t_crit: int, mutex_id: int = 0
) -> Generator:
    """Hardware mutex: elw-lock (elects one core), work, single-write unlock."""
    yield Compute(1)  # address setup
    yield Scu("elw", ("mutex", mutex_id, "lock"))
    if t_crit > 0:
        yield Compute(t_crit)
    yield Scu("write", ("mutex", mutex_id, "unlock"), 0)


# ---------------------------------------------------------------------------
# Trace-IR emitters (repro.core.scu.trace)
#
# The SW/TAS barrier and the TAS mutex are the value-*dependent* primitives:
# their generators branch on loaded values (the arrival count, the TAS
# re-test), so sentinel tracing rejects them.  These twins express the same
# control flow as explicit BR/JMP rows over the trace register R, which
# mirrors the engine's resume_value -- the row streams they produce are
# bit-identical to the generators under every schedule (the lowering parity
# suite in tests/test_trace.py holds the originals to that at 8/64/256 cores).
# ---------------------------------------------------------------------------


def trace_sw_barrier_body(tb, cid: int, st: BarrierState, cm: CostModel,
                          idle_wait: bool) -> None:
    """One sense-reversal barrier iteration as trace rows (SW/TAS twins).

    Mirrors :func:`_sw_barrier_body` row for row; the last-arrival decision
    becomes ``BR_EQ(n-1)`` on the loaded counter value.  Mutates the shared
    ``local_sense`` exactly like the generator -- the trace *replaces* the
    generator, consuming the same one build of the barrier state.
    """
    n = st.n_cores
    sense = st.local_sense[cid] ^ 1
    st.local_sense[cid] = sense
    tb.compute(cm.call + cm.sense_setup)
    tb.poll(
        "tas", A_BAR_LOCK, _TAS_FREE,
        hit_cycles=1, miss_cycles=1 + cm.branch_taken,
        hit_instr=1, miss_instr=1,
    )
    if cm.crit_extra > 0:
        tb.compute(cm.crit_extra)
    tb.mem("lw", A_BAR_COUNT)  # R = c
    tb.compute(1 + cm.load_use)
    br_last = tb.br_eq(n - 1)  # c + 1 == n -> last arrival
    # -- not the last arrival: publish c+1, release the lock, wait ----------
    tb.compute(1)
    tb.mem_delta("sw", A_BAR_COUNT, 1)  # store R + 1
    tb.mem("sw", A_BAR_LOCK, 0)
    if idle_wait:
        recheck = tb.label()
        tb.mem("lw", A_BAR_SENSE)  # R = s
        tb.compute(1 + cm.load_use)
        br_out = tb.br_eq(sense)
        tb.compute(cm.mask_setup)
        tb.scu("elw", ("notifier", 0, "wait"))
        tb.compute(1 + cm.branch_taken)
        tb.jmp(recheck)
        tb.set_target(br_out, tb.label())
    else:
        tb.poll(
            "lw", A_BAR_SENSE, sense,
            hit_cycles=1 + cm.load_use,
            miss_cycles=1 + cm.load_use + cm.branch_taken,
            hit_instr=1, miss_instr=2,
        )
    tb.compute(cm.ret)
    j_end = tb.jmp()
    # -- last arrival: reset, flip the shared sense, release ----------------
    tb.set_target(br_last, tb.label())
    tb.compute(1)
    tb.mem("sw", A_BAR_COUNT, 0)
    tb.mem("sw", A_BAR_SENSE, sense)
    tb.mem("sw", A_BAR_LOCK, 0)
    if idle_wait:
        tb.scu("write", ("notifier", 0, "trigger"), 0)
    tb.compute(cm.ret)
    tb.set_target(j_end, tb.label())


def trace_tas_mutex_section(tb, cid: int, t_crit: int, cm: CostModel) -> None:
    """One TAS idle-wait critical section as trace rows.

    Mirrors :func:`tas_mutex_section`: the test-and-test-and-set re-test
    loop becomes BR rows on the TAS / re-test load values.
    """
    tb.mem("tas", A_MUTEX)  # R = v
    br_acq0 = tb.br_eq(_TAS_FREE)
    tb.compute(1 + cm.branch_taken)  # first-attempt bnez taken
    wait = tb.label()
    tb.compute(cm.mask_setup)
    tb.scu("elw", ("notifier", 1, "wait"))
    tb.mem("lw", A_MUTEX)  # R = t (re-test before the atomic)
    tb.compute(1 + cm.load_use)
    br_retry = tb.br_eq(_TAS_FREE)
    tb.compute(cm.branch_taken)
    tb.jmp(wait)  # someone else was elected; back to sleep
    tb.set_target(br_retry, tb.label())
    tb.mem("tas", A_MUTEX)  # R = v
    br_acq1 = tb.br_eq(_TAS_FREE)
    tb.jmp(wait)  # lost the race; no first-attempt branch this time
    acquired = tb.label()
    tb.set_target(br_acq0, acquired)
    tb.set_target(br_acq1, acquired)
    tb.compute(1)  # bnez falls through
    if t_crit > 0:
        tb.compute(t_crit)
    tb.mem("sw", A_MUTEX, 0)
    tb.scu("write", ("notifier", 1, "trigger"), 0)
