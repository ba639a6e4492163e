"""Cycle-accurate discrete-event engine for the shared-L1 multiprocessor cluster.

Own copy of ``repro/core/scu/engine.py`` (the port imports nothing of
``repro``), line for line: host code in numpy and Python generators, as in
the reference, with no device path.  The part of the simulator that runs
on a card is the trace executor (``trace_exec.run_traces_torch``), which
this engine is the oracle of.  ``tests/test_torch_sim_engine.py`` holds
every count to the reference's on the same programs.

This is the Tier-1, paper-faithful model of the system evaluated in

    Glaser et al., "Energy-Efficient Hardware-Accelerated Synchronization for
    Shared-L1-Memory Multiprocessor Clusters" (2020).

The cluster consists of

  * ``n_cores`` in-order single-issue PEs (1 op/cycle when not stalled),
  * a word-interleaved multi-banked TCDM (banking factor 2 by default) behind a
    single-cycle logarithmic interconnect (LINT) with per-bank round-robin
    arbitration and native 3-cycle test-and-set (TAS) transactions,
  * the SCU: per-core base units (32 event lines, event buffer, event/irq
    masks, active/sleep/irq FSM, clock-enable control) reached over private
    single-cycle core<->SCU links, plus shared extensions (notifier, barrier,
    mutex, event FIFO) -- see :mod:`repro_torch.core.scu.scu_unit` and
    :mod:`repro_torch.core.scu.extensions`.

Programs are Python generators that yield micro-ops (:class:`Compute`,
:class:`Mem`, :class:`Scu`, :class:`Poll`); the engine resolves arbitration,
SCU event generation, sleep/wake-up sequencing and clock gating exactly as
described in Sec. 4/5 and Fig. 4 of the paper.

Accounting distinguishes *active* core cycles (clock enabled) from *gated*
cycles -- the quantity behind the paper's energy results.

Two execution modes produce bit-exact identical :class:`ClusterStats`:

``mode="lockstep"``
    The reference model: :meth:`Cluster.step` advances the whole cluster one
    clock cycle at a time with plain per-core Python loops, evaluating every
    phase every cycle.  Deliberately unvectorized -- this is the readable,
    obviously-correct implementation every fast path is cross-checked
    against.

``mode="fastforward"`` (default)
    The event-driven engine, organized as **three resolution tiers** (each
    cycle is resolved by the cheapest tier that can prove it exact):

    1. *Quiescent spans*: :meth:`Cluster.next_event_bound` computes a
       provably-safe number of cycles during which nothing observable can
       happen -- every core is burning a :class:`Compute` span, clock-gated
       asleep with no buffered wake event, or inside its wake countdown, and
       no SCU extension comparator can fire without a new core transaction
       (:meth:`repro_torch.core.scu.scu_unit.SCU.next_event_bound`).  The engine
       jumps the clock by the whole span with O(n_cores) span-based stats.
    2. *Spin-phase batch resolution* (:meth:`Cluster._resolve_spin_phase`):
       when every awake core sits inside a deterministic :class:`Poll` loop
       (fixed periodic bank traffic) while the rest are asleep or counting
       down, and no SCU comparator is armed, the cluster's evolution until
       the next spectator deadline is fully engine-determined.  The
       resolver replays exactly the per-bank round-robin outcomes with
       per-*grant* instead of per-cycle work -- queue-wait spans, retry
       shadows and the implied stall/conflict accounting settle in closed
       form per segment, and empty cycles between re-polls are skipped
       outright.  Long phases additionally run a period detector
       (configuration hashing over the relative spinner state, the involved
       round-robin pointers and the polled TCDM words): a repeat proves
       periodicity and the remaining horizon collapses into one multiply of
       the per-period stat deltas -- the closed form for "one core computes
       for 10^5 cycles while everyone else spins".
    3. *Full steps*: any cycle in which a generator advance, SCU grant, or
       comparator could act runs through a full cluster step.  On clusters
       with ``n_cores >= VEC_MIN_CORES`` this step is the **vectorized
       structure-of-arrays core** (:class:`_VecState`): per-core scheduler
       state and stat counters live in numpy arrays and the per-cycle phases
       (countdowns, TCDM round-robin arbitration with per-bank winner
       election via one lexsort, elw grant scans against the SCU's event
       vectors, accounting) are numpy kernels over all cores at once.
       Smaller clusters use the same scalar step as lockstep mode (numpy
       overhead would dominate at 8 cores).

    Parity with lockstep is bit-exact and enforced by golden values plus
    randomized cross-checks up to 256 cores in ``tests/test_scu_simulator.py``.

Sweeps over many independent configurations additionally have **fleet
mode**: :func:`simulate_fleet` stacks N clusters onto the same
structure-of-arrays core along a flattened ``(config, core)`` axis --
per-config segments partition the TCDM arbitration, SCU registers and the
``next_event_bound()`` reduction, quiescent jumps become per-config
segment-min spans, and full steps batch across every config at once (which
is what makes 8-core configs vectorizable for the first time).  Results are
bit-exact per config against one-at-a-time runs; see :class:`_Fleet`.
"""

from __future__ import annotations

import bisect
import dataclasses
import enum
from typing import Any, Callable, Dict, Generator, List, Optional, Tuple

import numpy as np

from .faults import DeadlockError, FaultPlan, SimTimeout, build_wait_graph

__all__ = [
    "Compute",
    "Mem",
    "Scu",
    "Poll",
    "CoreState",
    "CoreStats",
    "ClusterStats",
    "Cluster",
    "FleetConfig",
    "Program",
    "simulate_fleet",
    "SlotFleet",
]


# ---------------------------------------------------------------------------
# Micro-ops yielded by core programs
# ---------------------------------------------------------------------------


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
                 Occupies the bank for :attr:`Cluster.TAS_CYCLES` cycles
                 ("TAS transactions take just three cycles", Sec. 4.1).
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

    The engine re-polls without ever resuming the generator on a miss: each
    granted access returning ``v != until`` burns ``miss_cycles`` ACTIVE
    cycles (plus the TAS busy time for ``kind="tas"``) and re-enters the
    bank queue; the access returning ``until`` burns ``hit_cycles`` and then
    resumes the program with that value.  Instruction accounting mirrors the
    expanded loop: ``miss_instr`` instructions per retry round on top of the
    re-issued load, ``hit_instr`` on the exit path.

    Declaring the spin (instead of expanding it) is what enables the
    fast-forward engine's *spin-phase batch resolution*: a pending ``Poll``
    is a complete description of the core's behaviour until the polled word
    changes, with no generator state hidden from the scheduler.
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


Program = Callable[["Cluster", int], Generator]


class CoreState(enum.Enum):
    ACTIVE = 0  # clock enabled, executing / issuing
    STALL_MEM = 1  # clock enabled, waiting for a TCDM grant
    STALL_SCU = 2  # clock enabled, elw issued, pre-gate window (Fig. 4 left)
    SLEEP = 3  # clock gated by the SCU
    WAKING = 4  # event seen; grant/response sequencing (Fig. 4 right)
    DONE = 5


# integer state codes for the structure-of-arrays engine (== enum values)
_ACTIVE = CoreState.ACTIVE.value
_STALL_MEM = CoreState.STALL_MEM.value
_STALL_SCU = CoreState.STALL_SCU.value
_SLEEP = CoreState.SLEEP.value
_WAKING = CoreState.WAKING.value
_DONE = CoreState.DONE.value

_STATE_BY_CODE = {s.value: s for s in CoreState}


@dataclasses.dataclass
class CoreStats:
    active_cycles: int = 0  # clock enabled (= comp + wait)
    comp_cycles: int = 0  # clocked and executing/issuing (full core power)
    wait_cycles: int = 0  # clocked but pipeline held (stall/grant/wake)
    gated_cycles: int = 0  # clock gated by the SCU
    stall_cycles: int = 0  # subset of wait: stalled on LINT contention
    instructions: int = 0
    tcdm_accesses: int = 0
    tas_accesses: int = 0
    scu_accesses: int = 0
    finished_at: Optional[int] = None


@dataclasses.dataclass
class ClusterStats:
    cycles: int = 0
    cores: List[CoreStats] = dataclasses.field(default_factory=list)
    bank_conflicts: int = 0
    scu_events: int = 0

    # -- aggregates ---------------------------------------------------------
    @property
    def total_active(self) -> int:
        return sum(c.active_cycles for c in self.cores)

    @property
    def total_comp(self) -> int:
        return sum(c.comp_cycles for c in self.cores)

    @property
    def total_wait(self) -> int:
        return sum(c.wait_cycles for c in self.cores)

    @property
    def total_gated(self) -> int:
        return sum(c.gated_cycles for c in self.cores)

    @property
    def total_tcdm(self) -> int:
        return sum(c.tcdm_accesses for c in self.cores)

    @property
    def total_scu(self) -> int:
        return sum(c.scu_accesses for c in self.cores)


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
# row indices into _VecState.counter_block
(
    _C_ACTIVE,
    _C_COMP,
    _C_WAIT,
    _C_GATED,
    _C_STALL,
    _C_INSTR,
    _C_TCDM,
    _C_TAS,
    _C_SCU,
) = range(len(_COUNTERS))

# Phase-5 accounting as a lookup table: column = CoreState code, row = one
# of the first five counters (active/comp/wait/gated/stall); one fancy
# gather + add replaces the per-counter boolean mask arithmetic in the
# vectorized step kernels.  DONE contributes zeros (no clock, no counters).
_ACCT_INC = np.zeros((5, len(CoreState)), dtype=np.int64)
_ACCT_INC[_C_ACTIVE, [_ACTIVE, _STALL_MEM, _STALL_SCU, _WAKING]] = 1
_ACCT_INC[_C_COMP, _ACTIVE] = 1
_ACCT_INC[_C_WAIT, [_STALL_MEM, _STALL_SCU, _WAKING]] = 1
_ACCT_INC[_C_GATED, _SLEEP] = 1
_ACCT_INC[_C_STALL, _STALL_MEM] = 1


class _Core:
    """Execution context of one PE, including its scheduler state.

    The countdown fields (``busy``, ``wake_countdown``, ``sleep_entry``) are
    the *explicit scheduler state* of the core: between steps they fully
    determine how many cycles the core can advance without interacting with
    any shared resource.  :meth:`quiescent_bound` derives that number and
    :meth:`fast_forward` applies a whole span of it at once (span-based
    accounting); the lockstep path consumes the same state one cycle at a
    time through :meth:`Cluster._issue`.

    Stat counters are plain attributes (structure-of-scalars); the
    :attr:`stats` property materializes a :class:`CoreStats` snapshot on
    demand, so programs sampling their own counters mid-run always see
    current values in either engine mode.
    """

    __slots__ = (
        "cid",
        "gen",
        "started",
        "state",
        "busy",
        "pending",
        "resume_value",
        "wake_countdown",
        "sleep_entry",
        "elw_issued",
        "finished_at",
    ) + _COUNTERS

    def __init__(self, cid: int, gen: Generator):
        self.cid = cid
        self.gen = gen
        self.started = False
        self.state = CoreState.ACTIVE
        self.busy = 0  # remaining Compute (or Poll grant-shadow) cycles
        self.pending: Optional[Any] = None  # outstanding Mem/Poll/Scu op
        self.resume_value: int = 0  # data returned to the generator
        self.wake_countdown = 0
        self.sleep_entry = 0  # busy-release window before clock gating
        self.elw_issued = False  # extension trigger-once guard (Sec. 5)
        self.finished_at: Optional[int] = None
        for name in _COUNTERS:
            setattr(self, name, 0)

    @property
    def stats(self) -> CoreStats:
        return CoreStats(
            finished_at=self.finished_at,
            **{name: getattr(self, name) for name in _COUNTERS},
        )

    # ------------------------------------------------------------ scheduler
    def quiescent_bound(self, scu) -> Optional[int]:
        """Cycles this core is guaranteed to spend without any observable
        interaction, or ``None`` for "indefinitely many" (needs an external
        stimulus to make progress).  0 means the core must be stepped.

        Safe bounds per state (mirrors one lockstep :meth:`Cluster._issue`):

        * ``ACTIVE`` with ``busy=k>0`` -- k pure countdown cycles; the
          generator advance (or :class:`Poll` re-issue) happens on the
          following step.
        * ``WAKING`` with ``wake_countdown=w>1`` -- w-1 countdown cycles; the
          step where the countdown reaches 0 resumes the generator.
        * ``SLEEP`` -- indefinite, unless the waited-on event is already
          buffered (then the phase-4 poll would grant *this* cycle).
        * everything else (``STALL_MEM`` arbitration, ``STALL_SCU`` grant /
          sleep-entry windows, ``busy==0`` advances) -- 0: these transients
          touch shared resources and must run through the full step.
        """
        state = self.state
        if state is CoreState.DONE:
            return None
        if state is CoreState.ACTIVE:
            return self.busy if self.busy > 0 else 0
        if state is CoreState.WAKING:
            return self.wake_countdown - 1 if self.wake_countdown > 1 else 0
        if state is CoreState.SLEEP:
            if self.pending is None or scu is None:  # pragma: no cover
                return 0
            return 0 if scu.elw_would_grant(self.cid, self.pending.addr) else None
        return 0

    def fast_forward(self, span: int) -> None:
        """Advance this core ``span`` quiescent cycles in one O(1) update.

        Only the three states with a positive/indefinite quiescent bound can
        appear here; the stats written are exactly what ``span`` iterations
        of the lockstep phase-5 accounting would have written.
        """
        state = self.state
        if state is CoreState.ACTIVE:
            self.busy -= span
            self.active_cycles += span
            self.comp_cycles += span
        elif state is CoreState.WAKING:
            self.wake_countdown -= span
            self.active_cycles += span
            self.wait_cycles += span
        elif state is CoreState.SLEEP:
            self.gated_cycles += span
        # DONE: no clock, no accounting


class _VecState:
    """Structure-of-arrays mirror-free core state for the vectorized engine.

    Owns the scheduler state and stat counters of every core as numpy
    arrays; :class:`_VecCore` objects are thin per-core views so the shared
    scalar helpers (:meth:`Cluster._advance`, SCU servicing) and programs
    reading ``cluster.cores[cid]`` keep working unchanged.
    """

    __slots__ = (
        "n",
        "state",
        "busy",
        "wake",
        "sleep_entry",
        "pend_bank",
        "has_poll",
        "elw",
        "counter_block",
        "counters",
        "finished_at",
    )

    def __init__(self, n: int):
        self.n = n
        self.state = np.zeros(n, dtype=np.int64)  # CoreState codes
        self.busy = np.zeros(n, dtype=np.int64)
        self.wake = np.zeros(n, dtype=np.int64)
        self.sleep_entry = np.zeros(n, dtype=np.int64)
        self.pend_bank = np.full(n, -1, dtype=np.int64)  # bank of pending Mem/Poll
        self.has_poll = np.zeros(n, dtype=bool)  # pending op is a Poll
        self.elw = np.zeros(n, dtype=bool)  # elw_issued
        # one (n_counters, n_cores) block so snapshots/deltas are single
        # fancy-index operations; the dict maps names to row views
        self.counter_block = np.zeros((len(_COUNTERS), n), dtype=np.int64)
        self.counters = {
            name: self.counter_block[i] for i, name in enumerate(_COUNTERS)
        }
        self.finished_at: List[Optional[int]] = [None] * n

    @classmethod
    def view_of(cls, parent: "_VecState", sl: slice) -> "_VecState":
        """A per-segment view sharing the parent's storage (fleet mode).

        Every array field is a basic slice of the parent's arrays, so the
        member cluster's scalar helpers and the fleet's flattened kernels
        operate on the same memory -- the view *is* the segment partition.
        ``finished_at`` stays a per-member list (never touched vectorized).
        """
        v = object.__new__(cls)
        v.n = sl.stop - sl.start
        for name in ("state", "busy", "wake", "sleep_entry", "pend_bank",
                     "has_poll", "elw"):
            setattr(v, name, getattr(parent, name)[sl])
        v.counter_block = parent.counter_block[:, sl]
        v.counters = {
            name: v.counter_block[i] for i, name in enumerate(_COUNTERS)
        }
        v.finished_at = [None] * v.n
        return v


def _vec_scalar_property(array_name: str):
    def get(self):
        return int(getattr(self._V, array_name)[self.cid])

    def set(self, value):
        getattr(self._V, array_name)[self.cid] = value

    return property(get, set)


def _vec_counter_property(counter: str):
    def get(self):
        return int(self._V.counters[counter][self.cid])

    def set(self, value):
        self._V.counters[counter][self.cid] = value

    return property(get, set)


class _VecCore(_Core):
    """Per-core view into a :class:`_VecState` (vectorized engine mode).

    Scheduler fields and counters resolve into the shared arrays; everything
    idiosyncratic (the program generator, pending op object, resume value)
    stays a per-object attribute.  Property access is slower than a slot --
    this view is only touched on the cold paths (generator advances, SCU
    servicing, tests/programs introspecting a core); the per-cycle kernels
    operate on the arrays directly.
    """

    __slots__ = ("_V",)

    def __init__(self, cid: int, gen: Generator, vec: _VecState):
        self._V = vec
        super().__init__(cid, gen)

    busy = _vec_scalar_property("busy")
    wake_countdown = _vec_scalar_property("wake")
    sleep_entry = _vec_scalar_property("sleep_entry")

    @property
    def state(self) -> CoreState:
        return _STATE_BY_CODE[int(self._V.state[self.cid])]

    @state.setter
    def state(self, value: CoreState) -> None:
        self._V.state[self.cid] = value.value

    @property
    def elw_issued(self) -> bool:
        return bool(self._V.elw[self.cid])

    @elw_issued.setter
    def elw_issued(self, value: bool) -> None:
        self._V.elw[self.cid] = value

    @property
    def finished_at(self) -> Optional[int]:
        return self._V.finished_at[self.cid]

    @finished_at.setter
    def finished_at(self, value: Optional[int]) -> None:
        self._V.finished_at[self.cid] = value


for _name in _COUNTERS:
    setattr(_VecCore, _name, _vec_counter_property(_name))


class Cluster:
    """The cycle-accurate cluster model.

    Parameters
    ----------
    n_cores:
        Number of PEs (the paper's cluster: 8; SCU supports up to 16).
    banking_factor:
        TCDM banks = ``banking_factor * n_cores`` (paper: 2).
    scu:
        An :class:`repro_torch.core.scu.scu_unit.SCU` instance (constructed by the
        caller so extensions are configurable).  May be ``None`` for purely
        software experiments.
    mode:
        ``"fastforward"`` (default) -- event-driven engine with three
        resolution tiers (quiescent span / spin-phase batch / full step; the
        full step is the vectorized structure-of-arrays kernel on clusters
        with at least :attr:`VEC_MIN_CORES` cores); ``"lockstep"`` -- the
        unvectorized cycle-by-cycle reference model.  Both produce bit-exact
        identical :class:`ClusterStats` (see module docstring).
    faults:
        An optional :class:`repro_torch.core.scu.faults.FaultPlan` -- a
        deterministic schedule of injected upsets (lost/spurious wake-ups,
        transient core stalls, TCDM bank blackouts).  The plan implements
        the ``next_event_bound()`` contract, so fault-injected runs stay
        bit-exact between the two modes.  Plans are single-use; pass a
        fresh (or :meth:`~repro_torch.core.scu.faults.FaultPlan.clone`\\ d) plan
        per cluster.
    """

    MODES = ("fastforward", "lockstep")

    TAS_CYCLES = 3  # Sec. 4.1: "TAS transactions take just three cycles"
    # Fig. 4 timing: elw issue -> busy release -> clock gate takes 2 cycles on
    # the way in; event -> clock enable + grant -> response -> resume takes 4
    # cycles on the way out.  Together with the issue and address-setup cycles
    # this yields the paper's 6 active core cycles per handled
    # synchronization point (Sec. 5, Fig. 4).
    SLEEP_ENTRY_CYCLES = 1
    WAKE_CYCLES = 4

    # Minimum cluster size for the numpy kernels: below this the fixed
    # per-numpy-call overhead exceeds the per-core Python loop it replaces,
    # so small fastforward clusters keep the scalar step (still tiered).
    VEC_MIN_CORES = 16

    # Spin-phase batch resolution: phases expected to outlast this many
    # cycles additionally run the period detector, which can collapse the
    # remaining horizon into one closed-form multiply (see
    # :meth:`_resolve_spin_phase`).  Short phases are resolved grant-by-grant
    # without paying for configuration hashing.
    SPIN_PERIOD_MIN_HORIZON = 64
    # ... and the detector gives up after this many distinct configurations
    # (a phase whose period is longer is replayed grant-by-grant; the memo
    # must not grow unboundedly on pathological rotations).
    SPIN_PERIOD_MEMO_LIMIT = 4096

    # Spin-resolver spectator handling: at or below this core count the
    # horizon/writeback passes use direct scalar reads on the SoA arrays (a
    # handful of element accesses beat the fixed cost of the numpy mask
    # kernels on such narrow arrays -- the fleet runs many 8-core members).
    SPIN_SCALAR_MAX_CORES = 32

    def __init__(
        self,
        n_cores: int,
        scu=None,
        banking_factor: int = 2,
        mode: str = "fastforward",
        faults: Optional[FaultPlan] = None,
    ):
        if mode not in self.MODES:
            raise ValueError(f"mode must be one of {self.MODES}, got {mode!r}")
        self.n_cores = n_cores
        self.n_banks = banking_factor * n_cores
        self.scu = scu
        self.mode = mode
        self.faults = faults
        self.vectorized = mode == "fastforward" and n_cores >= self.VEC_MIN_CORES
        if scu is not None:
            scu.attach(self)
        self.tcdm: Dict[int, int] = {}
        self._rr = np.zeros(self.n_banks, dtype=np.int64)  # round-robin ptrs
        self.cores: List[_Core] = []
        self._vec: Optional[_VecState] = None
        self._n_done = 0
        self.cycle = 0
        self.max_cycles = 0  # horizon of the current run()
        self.stats = ClusterStats()
        # fast-forward diagnostics (engine-internal; never part of
        # ClusterStats so the two modes stay bit-exact comparable)
        self.ff_spans = 0  # number of quiescent-span jumps taken
        self.ff_cycles = 0  # cycles covered by those jumps
        self.ff_batch_spans = 0  # number of spin-phase batch jumps taken
        self.ff_batch_cycles = 0  # cycles covered by those jumps
        # compiled-trace fast path (armed by load() when every core runs a
        # pure TraceProgram cursor; see repro_torch.core.scu.trace)
        self._trace_monitor = None
        self.trace_jumps = 0  # whole-cluster period collapses taken
        self.trace_jump_cycles = 0  # cycles covered by those collapses

    # ------------------------------------------------------------------ api
    def load(self, programs: List[Program]) -> None:
        assert len(programs) == self.n_cores
        if self.vectorized:
            self._vec = _VecState(self.n_cores)
            self.cores = [
                _VecCore(i, prog(self, i), self._vec)
                for i, prog in enumerate(programs)
            ]
        else:
            self._vec = None
            self.cores = [_Core(i, prog(self, i)) for i, prog in enumerate(programs)]
        self.stats = ClusterStats()
        self._n_done = 0
        # Arm the compiled-trace period collapse when the *entire* cluster
        # state is static trace state: every core a pure table cursor, no
        # fault plan rewriting state mid-run, no watchdog measuring wall
        # progress.  (Generator fallbacks hold opaque Python frames the
        # digest cannot cover, so one fallback disables the whole monitor.)
        self._trace_monitor = None
        if (
            self.mode == "fastforward"
            and self.faults is None
            and (self.scu is None or self.scu.watchdog is None)
            and self.cores
            and all(
                getattr(c.gen, "_is_trace_cursor", False) for c in self.cores
            )
        ):
            from .trace import TraceRunMonitor  # deferred: trace imports us

            self._trace_monitor = TraceRunMonitor(
                self, [c.gen for c in self.cores]
            )

    def run(self, max_cycles: int = 10_000_000) -> ClusterStats:
        self.max_cycles = max_cycles
        try:
            if self.mode == "fastforward":
                self._run_fast(max_cycles)
            else:
                scu = self.scu
                has_wd = scu is not None and scu.watchdog is not None
                while self._n_done < self.n_cores:
                    if self.cycle >= max_cycles:
                        self._raise_timeout(max_cycles)
                    self.step()
                    if has_wd and scu.watchdog.tripped is not None:
                        raise self._watchdog_error()
        finally:
            self.stats.cycles = self.cycle
            self.stats.cores = [c.stats for c in self.cores]
        return self.stats

    def _raise_timeout(self, max_cycles: int) -> None:
        graph = build_wait_graph(self)
        raise SimTimeout(
            f"cluster did not finish within {max_cycles} cycles "
            f"(states: {[c.state.name for c in self.cores]})\n"
            + graph.describe(),
            graph=graph,
        )

    def _watchdog_error(self) -> Optional[DeadlockError]:
        """The pending watchdog trip as a raisable error, or ``None``.

        Trips are detected *after* a step completes (trip-and-report): the
        watchdog never aborts a step half-way, which in fleet mode would
        corrupt co-resident members sharing the batched step."""
        scu = self.scu
        if scu is None or scu.watchdog is None:
            return None
        wd = scu.watchdog
        graph = wd.tripped
        if graph is None:
            return None
        return DeadlockError(
            f"watchdog tripped at cycle {graph.cycle}: no armed-set progress "
            f"within {wd.timeout} cycles "
            f"(mode={wd.mode!r}, releases={wd.release_count})\n"
            + graph.describe(),
            graph=graph,
        )

    def _run_fast(self, max_cycles: int) -> None:
        step = self._step_vec if self.vectorized else self.step
        scu = self.scu
        has_wd = scu is not None and scu.watchdog is not None
        monitor = self._trace_monitor
        while self._n_done < self.n_cores:
            if monitor is not None:
                # compiled-trace tier: digest the full cluster state at
                # loop-head crossings; a recurring digest collapses all
                # remaining periods into one multiply of the stat deltas
                monitor.poll()
            if self.cycle >= max_cycles:
                self._raise_timeout(max_cycles)
            bound = self.next_event_bound()
            if bound is None:
                # deadlock: every core is gated with no wake event in
                # sight -- burn to the cap so the failure mode (and the
                # cycle count it reports) matches lockstep exactly
                bound = max_cycles - self.cycle
            if bound > 0:
                self.fast_forward(min(bound, max_cycles - self.cycle))
                continue
            if self._resolve_spin_phase():
                continue
            step()
            if has_wd and scu.watchdog.tripped is not None:
                raise self._watchdog_error()

    # ---------------------------------------------------------------- cycle
    def step(self) -> None:
        """Advance the whole cluster by one clock cycle (scalar reference)."""
        # Injected upsets land before anything else sees the cycle; the
        # fault plan's bound guarantees a full step runs on every scheduled
        # cycle in either mode.
        if self.faults is not None:
            self.faults.apply(self)

        # Phase 0: extension comparators are registered -- events caused by
        # the *previous* cycle's triggers become visible in the buffers now.
        if self.scu is not None:
            n_ev = self.scu.evaluate(self.cycle)
            self.stats.scu_events += n_ev

        # Phase 1: issue -- every clocked core makes progress / places reqs.
        for core in self.cores:
            self._issue(core)

        # Phase 2: TCDM / LINT arbitration (per-bank round robin).
        self._arbitrate_tcdm()

        # Phase 3: SCU -- private links, elw grant logic, extension triggers.
        if self.scu is not None:
            self._service_scu()

        # Phase 4: pending elw transactions are polled against the buffers.
        if self.scu is not None:
            self._wake_cores()

        # Phase 5: accounting.
        for core in self.cores:
            state = core.state
            if state is CoreState.DONE:
                continue
            if state is CoreState.SLEEP:
                core.gated_cycles += 1
            else:
                core.active_cycles += 1
                if state is CoreState.ACTIVE:
                    core.comp_cycles += 1
                else:
                    # clocked but held: LINT stall, elw grant window, wake
                    core.wait_cycles += 1
                    if state is CoreState.STALL_MEM:
                        core.stall_cycles += 1
        self.cycle += 1

    # ----------------------------------------------------- fast-forward path
    def next_event_bound(self) -> Optional[int]:
        """Number of cycles that can be skipped before anything observable
        can happen; 0 forces a full step, ``None`` means no internal event is
        ever due (every core gated/done and no comparator armed).

        The bound is the min over the per-core countdown bounds
        (:meth:`_Core.quiescent_bound`) and the SCU extension bound
        (:meth:`repro_torch.core.scu.scu_unit.SCU.next_event_bound`): extensions
        are pure comparators over state written by core transactions, so if
        none can fire now and no core acts, none can fire during the span.

        An attached :class:`FaultPlan` is a third bound source: injected
        faults are observable events, so the plan's own
        ``next_event_bound()`` is min'd in -- every fault cycle (and every
        cycle of a bank-blackout window) resolves through a full step.
        """
        if self.vectorized:
            bound = self._next_event_bound_vec()
        else:
            bound = self._next_event_bound_scalar()
        faults = self.faults
        if faults is not None and bound != 0:
            fb = faults.next_event_bound(self.cycle)
            if fb is not None and (bound is None or fb < bound):
                bound = fb
        return bound

    def _next_event_bound_scalar(self) -> Optional[int]:
        # cores first: during contention phases the first stalled core
        # short-circuits the scan before any extension comparator is touched
        bound: Optional[int] = None
        scu = self.scu
        for core in self.cores:
            b = core.quiescent_bound(scu)
            if b is None:
                continue
            if b <= 0:
                return 0
            if bound is None or b < bound:
                bound = b
        if scu is not None:
            b = scu.next_event_bound()
            if b is not None:
                if b <= 0:
                    return 0
                if bound is None or b < bound:
                    bound = b
        return bound

    def _next_event_bound_vec(self) -> Optional[int]:
        V = self._vec
        st = V.state
        active = st == _ACTIVE
        waking = st == _WAKING
        # any transient state or imminent advance forces a step now
        if (
            np.any(st == _STALL_MEM)
            or np.any(st == _STALL_SCU)
            or np.any(active & (V.busy <= 0))
            or np.any(waking & (V.wake <= 1))
        ):
            return 0
        bound: Optional[int] = None
        if np.any(active):
            bound = int(V.busy[active].min())
        if np.any(waking):
            w = int(V.wake[waking].min()) - 1
            if bound is None or w < bound:
                bound = w
        scu = self.scu
        if scu is not None:
            sleeping = np.nonzero(st == _SLEEP)[0]
            if sleeping.size and scu.elw_any_grantable(sleeping):
                return 0
            b = scu.next_event_bound()
            if b is not None:
                if b <= 0:
                    return 0
                if bound is None or b < bound:
                    bound = b
        return bound

    def fast_forward(self, span: int) -> None:
        """Jump ``span`` quiescent cycles: counters and stats advance in one
        span-based update, no arbitration / SCU phases run (the scheduler
        proved none could act -- see :meth:`next_event_bound`)."""
        if self.vectorized:
            V = self._vec
            st = V.state
            active = st == _ACTIVE
            waking = st == _WAKING
            sleeping = st == _SLEEP
            V.busy[active] -= span
            V.wake[waking] -= span
            clocked = active | waking
            V.counters["active_cycles"][clocked] += span
            V.counters["comp_cycles"][active] += span
            V.counters["wait_cycles"][waking] += span
            V.counters["gated_cycles"][sleeping] += span
        else:
            for core in self.cores:
                core.fast_forward(span)
        self.cycle += span
        self.ff_spans += 1
        self.ff_cycles += span

    # --------------------------------------------- spin-phase batch resolver
    def _spin_participants_vec(self) -> Optional[np.ndarray]:
        """Vectorized eligibility check: participant cids, or ``None``."""
        V = self._vec
        st = V.state
        if (st == _STALL_SCU).any():
            return None
        has_poll = V.has_poll
        stalled = st == _STALL_MEM
        if (stalled & ~has_poll).any():
            return None  # a plain Mem transaction is in flight
        part = has_poll & (stalled | (st == _ACTIVE))
        if not part.any():
            return None
        if ((st == _ACTIVE) & (V.busy <= 0) & ~part).any():
            return None  # generator advance due this cycle
        waking = st == _WAKING
        if waking.any() and (waking & (V.wake <= 1)).any():
            return None
        scu = self.scu
        if scu is not None:
            if scu.next_event_bound() is not None:
                return None
            sleeping = np.nonzero(st == _SLEEP)[0]
            if sleeping.size and scu.elw_any_grantable(sleeping):
                return None
        return np.nonzero(part)[0]

    def _spin_participants(self) -> Optional[List[_Core]]:
        """The polling cores of an eligible spin phase, or ``None``.

        A spin phase requires every non-DONE core to be one of

        * a *participant*: a pending :class:`Poll` (requesting the bank or
          counting down a retry shadow) -- engine-deterministic until the
          polled word changes;
        * a *spectator*: a pure countdown (``Compute`` span, wake sequencing
          with at least one safe cycle left) or clock-gated sleep with no
          buffered wake event;

        and no armed SCU comparator.  Under those conditions the only state
        evolving is the participants' round-robin rotation -- periodic, and
        therefore batch-resolvable.
        """
        scu = self.scu
        participants: List[_Core] = []
        for core in self.cores:
            state = core.state
            if state is CoreState.DONE:
                continue
            pending = core.pending
            if isinstance(pending, Poll) and state in (
                CoreState.STALL_MEM,
                CoreState.ACTIVE,
            ):
                participants.append(core)
                continue
            if state is CoreState.ACTIVE:
                if core.busy <= 0:
                    return None  # generator advance due this cycle
            elif state is CoreState.WAKING:
                if core.wake_countdown <= 1:
                    return None
            elif state is CoreState.SLEEP:
                if scu is None or scu.elw_would_grant(core.cid, pending.addr):
                    return None
            else:  # STALL_SCU or anything mid-transaction
                return None
        if not participants:
            return None
        if scu is not None and scu.next_event_bound() is not None:
            return None
        return participants

    def _resolve_spin_phase(self, pids_arr: Optional[np.ndarray] = None) -> bool:
        """Tier-2 resolution: batch-resolve a pure spin/poll phase.

        When every awake core is inside a :class:`Poll` (eligibility via
        :meth:`_spin_participants`), the cluster's evolution until the next
        spectator deadline is fully determined by engine state: per cycle,
        each polled bank grants one requester (round robin), misses re-enter
        the queue after their retry shadow, and nothing else can move.  This
        resolver replays exactly those round-robin outcomes with per-*grant*
        (not per-cycle) work -- queue-wait spans, retry shadows and the
        implied conflict/stall accounting are settled in closed form per
        segment -- and skips empty cycles between rejoins entirely.

        For long phases (horizon > :attr:`SPIN_PERIOD_MIN_HORIZON`) it
        additionally hashes the relative spin configuration each cycle; a
        repeat proves periodicity, and the remaining horizon collapses into
        one multiply of the per-period stat deltas (the closed form for the
        "one core computes for 10^5 cycles while the rest spin" phases of
        the imbalanced applications).

        The phase ends at the first poll *hit* (the program must resume), at
        the spectator horizon (a countdown expires), or at ``max_cycles``;
        the cores are written back in exactly the state the same number of
        lockstep steps would have left them in.  Returns True when at least
        one cycle was resolved.

        ``pids_arr`` short-circuits the eligibility check with a
        caller-proven participant set -- the fleet engine computes
        eligibility for every config in one flattened pass and hands each
        eligible member its participants directly.
        """
        V = self._vec
        cores = self.cores
        n = self.n_cores
        t0 = self.cycle

        # -- fault plan: the resolver replays TCDM grants without the
        #    arbitration (and blackout) machinery, so a fault due now blocks
        #    tier 2 outright and a future fault caps the replay horizon
        fault_bound = None
        if self.faults is not None:
            fault_bound = self.faults.next_event_bound(t0)
            if fault_bound == 0:
                return False

        # -- eligibility + participant set ---------------------------------
        if pids_arr is not None:
            pids = [int(c) for c in pids_arr]
        elif self.vectorized:
            p_arr = self._spin_participants_vec()
            if p_arr is None:
                return False
            pids = [int(c) for c in p_arr]
        else:
            parts = self._spin_participants()
            if parts is None:
                return False
            pids = [c.cid for c in parts]

        # -- spectator horizon ---------------------------------------------
        horizon = self.max_cycles - t0
        pid_set = set(pids)
        small = n <= self.SPIN_SCALAR_MAX_CORES
        if self.vectorized and not small:
            st = V.state
            spect = np.ones(n, dtype=bool)
            spect[pids] = False
            sa = spect & (st == _ACTIVE)
            if sa.any():
                horizon = min(horizon, int(V.busy[sa].min()))
            sw = spect & (st == _WAKING)
            if sw.any():
                horizon = min(horizon, int(V.wake[sw].min()) - 1)
        elif self.vectorized:
            # small clusters: direct scalar reads beat the numpy mask ops
            stv, busyv, wakev = V.state, V.busy, V.wake
            for cid in range(n):
                if cid in pid_set:
                    continue
                s = stv[cid]
                if s == _ACTIVE:
                    b = busyv[cid]
                    if b < horizon:
                        horizon = int(b)
                elif s == _WAKING:
                    w = wakev[cid] - 1
                    if w < horizon:
                        horizon = int(w)
        else:
            for core in cores:
                if core.cid in pid_set:
                    continue
                cs = core.state
                if cs is CoreState.ACTIVE:
                    horizon = min(horizon, core.busy)
                elif cs is CoreState.WAKING:
                    horizon = min(horizon, core.wake_countdown - 1)
        if fault_bound is not None and fault_bound < horizon:
            horizon = fault_bound
        if horizon <= 0:  # pragma: no cover - eligibility guarantees >= 1
            return False

        # -- participant records -------------------------------------------
        k = len(pids)
        banks_ = [0] * k
        addrs_ = [0] * k
        untils = [0] * k
        is_tas = [False] * k
        miss_sh = [0] * k  # full ACTIVE shadow after a miss grant
        hit_sh = [0] * k
        h_in = [0] * k
        m_in = [0] * k
        queued_at = [-1] * k  # request time while queued, else -1
        rejoin_at = [-1] * k  # re-issue time while in a retry shadow
        shadow_from = [0] * k  # start of the unsettled comp segment
        acc = [[0] * len(_COUNTERS) for _ in range(k)]
        queues: Dict[int, List[int]] = {}
        rejoins: Dict[int, List[int]] = {}
        tas_cycles = self.TAS_CYCLES - 1
        vec = self.vectorized
        if vec:
            stv_, busyv_ = V.state, V.busy
        n_banks = self.n_banks
        for i, cid in enumerate(pids):
            op = cores[cid].pending
            b = (op.addr >> 2) % n_banks  # _bank_of, inlined
            banks_[i] = b
            addrs_[i] = op.addr
            untils[i] = op.until
            tas = op.kind == "tas"
            base = tas_cycles if tas else 0
            is_tas[i] = tas
            miss_sh[i] = base + op.miss_cycles
            hit_sh[i] = base + op.hit_cycles
            h_in[i] = op.hit_instr
            m_in[i] = op.miss_instr
            if vec:
                in_queue = stv_[cid] == _STALL_MEM
                busy_c = int(busyv_[cid])
            else:
                in_queue = cores[cid].state is CoreState.STALL_MEM
                busy_c = cores[cid].busy
            if in_queue:
                queued_at[i] = t0
                queues.setdefault(b, []).append(i)
            else:
                # mid-shadow at entry: the re-issue lands busy cycles out
                tr = t0 + busy_c
                rejoin_at[i] = tr
                shadow_from[i] = t0
                rejoins.setdefault(tr, []).append(i)

        # -- replay grants until a hit / the horizon ------------------------
        t = t0
        t_end = t0 + horizon
        hits: List[Tuple[int, int]] = []
        rr = self._rr
        tcdm = self.tcdm
        detect = horizon > self.SPIN_PERIOD_MIN_HORIZON
        bank_list = sorted(set(banks_)) if detect else ()
        # the round-robin pointers of the involved banks, mirrored into a
        # plain dict for the replay (one numpy scalar read/write per bank
        # instead of one per grant); written back after the loop
        rr_loc = {b: int(rr[b]) for b in set(banks_)}
        # lazy detection start: most phases end by a hit long before
        # periodicity could pay off, so the per-cycle configuration hashing
        # only begins once the replay has actually outlasted the threshold
        detect_from = t0 + self.SPIN_PERIOD_MIN_HORIZON
        seen: Dict[Any, Tuple[int, List[List[int]]]] = {}
        while t < t_end:
            joiners = rejoins.pop(t, None)
            if joiners:
                for i in joiners:
                    a = acc[i]
                    seg = t - shadow_from[i]
                    a[_C_COMP] += seg
                    a[_C_ACTIVE] += seg
                    a[_C_INSTR] += 1  # the re-issued load
                    queued_at[i] = t
                    rejoin_at[i] = -1
                    queues.setdefault(banks_[i], []).append(i)
            if not queues:
                if not rejoins:  # pragma: no cover - all cores hit
                    break
                nxt = min(rejoins)
                t = nxt if nxt < t_end else t_end
                continue
            if detect and t >= detect_from:
                # a shadow's key carries both the rejoin offset and the
                # unsettled-segment start: an entry shadow (segment began at
                # phase entry, not at a grant) must never alias an in-phase
                # shadow with the same rejoin offset, or the settled-delta
                # cancellation argument breaks
                key = (
                    tuple(
                        (i, t - queued_at[i])
                        if queued_at[i] >= 0
                        else (i, t - rejoin_at[i], t - shadow_from[i])
                        for i in range(k)
                    ),
                    tuple(rr_loc[b] for b in bank_list),
                    tuple(tcdm.get(a, 0) for a in addrs_),
                )
                prev = seen.get(key)
                if prev is None:
                    if len(seen) >= self.SPIN_PERIOD_MEMO_LIMIT:
                        detect = False
                        seen.clear()
                    else:
                        seen[key] = (t, [list(a) for a in acc])
                else:
                    t1, acc1 = prev
                    period = t - t1
                    m = (t_end - t) // period
                    if m > 0:
                        shift = m * period
                        for i in range(k):
                            a, a1 = acc[i], acc1[i]
                            for j in range(len(_COUNTERS)):
                                a[j] += m * (a[j] - a1[j])
                            if queued_at[i] >= 0:
                                queued_at[i] += shift
                            else:
                                rejoin_at[i] += shift
                                shadow_from[i] += shift
                        rejoins = {
                            tk + shift: v for tk, v in rejoins.items()
                        }
                        t += shift
                        seen.clear()
                        if t >= t_end:
                            break
            for b in list(queues):
                q = queues[b]
                if len(q) == 1:
                    wi = q[0]
                    del queues[b]
                else:
                    rb = rr_loc[b]
                    best = n
                    for i in q:
                        kk = (pids[i] - rb) % n
                        if kk < best:
                            best = kk
                            wi = i
                    q.remove(wi)
                rr_loc[b] = (pids[wi] + 1) % n
                dt = t - queued_at[wi]
                queued_at[wi] = -1
                a = acc[wi]
                a[_C_ACTIVE] += dt + 1
                a[_C_WAIT] += dt
                a[_C_STALL] += dt
                a[_C_COMP] += 1
                a[_C_TCDM] += 1
                addr = addrs_[wi]
                value = tcdm.get(addr, 0)
                if is_tas[wi]:
                    tcdm[addr] = -1
                    a[_C_TAS] += 1
                if value == untils[wi]:
                    a[_C_INSTR] += h_in[wi]
                    hits.append((wi, value))
                else:
                    a[_C_INSTR] += m_in[wi]
                    tr = t + miss_sh[wi] + 1
                    shadow_from[wi] = t + 1
                    rejoin_at[wi] = tr
                    rejoins.setdefault(tr, []).append(wi)
            t += 1
            if hits:
                t_end = t
                break
        for b, v in rr_loc.items():
            rr[b] = v

        # -- settle partial segments + write the cores back -----------------
        span = t_end - t0
        hit_idx = {i for i, _ in hits}
        conflicts = 0
        for i, cid in enumerate(pids):
            a = acc[i]
            if i in hit_idx:
                pass  # exits at the grant cycle; shadow runs under tier 1
            elif queued_at[i] >= 0:
                seg = t_end - queued_at[i]
                a[_C_ACTIVE] += seg
                a[_C_WAIT] += seg
                a[_C_STALL] += seg
            else:
                seg = t_end - shadow_from[i]
                a[_C_COMP] += seg
                a[_C_ACTIVE] += seg
            conflicts += a[_C_STALL]
        self.stats.bank_conflicts += conflicts
        if self.vectorized:
            CB = V.counter_block
            # all participants' accumulated counters in one fancy add
            CB[:, pids] += np.array(acc, dtype=np.int64).T
            for i, value in hits:
                cid = pids[i]
                core = cores[cid]
                core.pending = None
                core.resume_value = value
                V.state[cid] = _ACTIVE
                V.busy[cid] = hit_sh[i]
                V.pend_bank[cid] = -1
                V.has_poll[cid] = False
            for i in range(k):
                if i in hit_idx:
                    continue
                cid = pids[i]
                if queued_at[i] >= 0:
                    # the virtual re-issue happened inside the phase: the
                    # core is waiting in the bank queue again
                    V.state[cid] = _STALL_MEM
                    V.busy[cid] = 0
                else:
                    V.state[cid] = _ACTIVE
                    V.busy[cid] = rejoin_at[i] - t_end
            # spectators: span-based countdown accounting
            st = V.state
            if small:
                stv, busyv, wakev = st, V.busy, V.wake
                for cid in range(n):
                    if cid in pid_set:
                        continue
                    s = stv[cid]
                    if s == _ACTIVE:
                        busyv[cid] -= span
                        CB[_C_ACTIVE, cid] += span
                        CB[_C_COMP, cid] += span
                    elif s == _WAKING:
                        wakev[cid] -= span
                        CB[_C_ACTIVE, cid] += span
                        CB[_C_WAIT, cid] += span
                    elif s == _SLEEP:
                        CB[_C_GATED, cid] += span
            else:
                spect = np.ones(n, dtype=bool)
                spect[pids] = False
                sa = spect & (st == _ACTIVE)
                sw = spect & (st == _WAKING)
                V.busy[sa] -= span
                V.wake[sw] -= span
                C = V.counters
                C["active_cycles"][sa] += span
                C["comp_cycles"][sa] += span
                C["active_cycles"][sw] += span
                C["wait_cycles"][sw] += span
                C["gated_cycles"][spect & (st == _SLEEP)] += span
        else:
            for i, cid in enumerate(pids):
                core = cores[cid]
                a = acc[i]
                for j, name in enumerate(_COUNTERS):
                    setattr(core, name, getattr(core, name) + a[j])
                if i in hit_idx:
                    continue
                if queued_at[i] >= 0:
                    # the virtual re-issue happened inside the phase: the
                    # core is waiting in the bank queue again
                    core.state = CoreState.STALL_MEM
                    core.busy = 0
                else:
                    core.state = CoreState.ACTIVE
                    core.busy = rejoin_at[i] - t_end
            for i, value in hits:
                core = cores[pids[i]]
                core.pending = None
                core.resume_value = value
                core.state = CoreState.ACTIVE
                core.busy = hit_sh[i]
            pid_set = set(pids)
            for core in cores:
                if core.cid not in pid_set:
                    core.fast_forward(span)
        self.cycle = t_end
        self.ff_batch_spans += 1
        self.ff_batch_cycles += span
        return True


    def _step_vec(self) -> None:
        """One full cluster step through the structure-of-arrays kernels.

        Phase order and semantics are identical to the scalar :meth:`step`;
        every per-core loop is replaced by a numpy kernel over the state
        arrays, dropping to Python only for the idiosyncratic transitions
        (generator advances, SCU transactions, elw grants).
        """
        V = self._vec
        cores = self.cores
        st = V.state

        # Injected upsets land before anything else sees the cycle.
        if self.faults is not None:
            self.faults.apply(self)

        # Phase 0: extension comparators.
        if self.scu is not None:
            n_ev = self.scu.evaluate(self.cycle)
            self.stats.scu_events += n_ev

        # Phase 1a: countdowns (vectorized).
        active = st == _ACTIVE
        counting = active & (V.busy > 0)
        V.busy[counting] -= 1
        waking = st == _WAKING
        V.wake[waking] -= 1
        gating = (st == _STALL_SCU) & V.elw
        if np.any(gating):
            V.sleep_entry[gating] -= 1
            gated = gating & (V.sleep_entry <= 0)
            st[gated] = _SLEEP

        # Phase 1b: generator advances and Poll re-issues (scalar).
        due = np.nonzero((active & ~counting) | (waking & (V.wake <= 0)))[0]
        for cid in due:
            core = cores[cid]
            if st[cid] == _WAKING:
                st[cid] = _ACTIVE
            if core.pending is not None and not V.elw[cid]:
                # armed Poll whose retry shadow expired: re-enter the queue
                st[cid] = _STALL_MEM
                V.counters["instructions"][cid] += 1
            else:
                self._advance(core, core.resume_value)

        # Phase 2: TCDM / LINT arbitration (vectorized round robin).
        self._arbitrate_tcdm_vec()

        # Phase 3 + 4: SCU private links and elw grant scans.
        if self.scu is not None:
            fresh = np.nonzero((st == _STALL_SCU) & ~V.elw)[0]
            for cid in fresh:
                self._service_one(cores[cid])
            self._wake_cores_vec()

        # Phase 5: accounting (one state-code table gather, see _ACCT_INC).
        V.counter_block[:5] += _ACCT_INC[:, st]
        self.cycle += 1

    def _arbitrate_tcdm_vec(self) -> None:
        V = self._vec
        st = V.state
        req = np.nonzero(st == _STALL_MEM)[0]
        if req.size == 0:
            return
        if self.faults is not None:
            blk = self.faults.blacked_banks(self.cycle)
            if blk:
                # filter before the single-requester shortcut: a blacked
                # bank grants nothing and charges no conflicts
                req = req[~np.isin(V.pend_bank[req], tuple(blk))]
                if req.size == 0:
                    return
        n = self.n_cores
        if req.size == 1:
            cid = int(req[0])
            self._rr[V.pend_bank[cid]] = (cid + 1) % n
            self._grant_mem_vec(cid)
            return
        banks = V.pend_bank[req]
        key = (req - self._rr[banks]) % n
        order = np.lexsort((key, banks))
        sorted_banks = banks[order]
        # winners: the first requester of each bank group (lowest rr key)
        first = np.ones(order.size, dtype=bool)
        first[1:] = sorted_banks[1:] != sorted_banks[:-1]
        winners = req[order[first]]
        self.stats.bank_conflicts += int(req.size - winners.size)
        rr = self._rr
        for cid in winners:
            cid = int(cid)
            rr[V.pend_bank[cid]] = (cid + 1) % n
            self._grant_mem_vec(cid)

    def _grant_mem_vec(self, cid: int) -> None:
        """Granted TCDM transaction, writing the SoA state directly.

        Deliberate (measured) duplicate of :meth:`_grant_mem`: the generic
        version goes through the `_VecCore` property layer, which costs ~3x
        more per winner, and this path takes up to one grant per bank per
        cycle.  Keep the two in lockstep when touching grant semantics --
        the 16..256-core randomized cross-checks in
        ``tests/test_scu_simulator.py`` trip on any divergence."""
        V = self._vec
        core = self.cores[cid]
        op = core.pending
        CB = V.counter_block
        CB[_C_TCDM, cid] += 1
        if type(op) is Poll:
            value = self.tcdm.get(op.addr, 0)
            base = 0
            if op.kind == "tas":
                self.tcdm[op.addr] = -1
                CB[_C_TAS, cid] += 1
                base = self.TAS_CYCLES - 1
            if value == op.until:
                core.pending = None
                core.resume_value = value
                V.busy[cid] = base + op.hit_cycles
                CB[_C_INSTR, cid] += op.hit_instr
                V.pend_bank[cid] = -1
                V.has_poll[cid] = False
            else:
                V.busy[cid] = base + op.miss_cycles
                CB[_C_INSTR, cid] += op.miss_instr
            V.state[cid] = _ACTIVE
            return
        kind = op.kind
        if kind == "lw":
            value = self.tcdm.get(op.addr, 0)
        elif kind == "sw":
            self.tcdm[op.addr] = op.data
            value = 0
        elif kind == "tas":
            value = self.tcdm.get(op.addr, 0)
            self.tcdm[op.addr] = -1
            CB[_C_TAS, cid] += 1
            V.busy[cid] = self.TAS_CYCLES - 1
        else:  # pragma: no cover
            raise ValueError(kind)
        core.pending = None
        core.resume_value = value
        V.state[cid] = _ACTIVE
        V.pend_bank[cid] = -1
        V.has_poll[cid] = False

    def _wake_cores_vec(self) -> None:
        """Phase 4, vectorized precheck: only cores whose waited-on event is
        actually buffered run the scalar grant sequencing."""
        V = self._vec
        st = V.state
        pending = V.elw & ((st == _STALL_SCU) | (st == _SLEEP))
        if not np.any(pending):
            return
        cids = np.nonzero(pending)[0]
        granted = self.scu.elw_grantable_mask(cids)
        for cid in cids[granted]:
            self._wake_one(self.cores[cid])

    # ------------------------------------------------------------ internals
    def _advance(self, core: _Core, value: int = 0) -> None:
        """Feed ``value`` into the program generator and fetch the next op."""
        try:
            op = core.gen.send(value) if core.started else next(core.gen)
        except StopIteration:
            core.state = CoreState.DONE
            core.finished_at = self.cycle
            core.pending = None
            self._n_done += 1
            return
        core.started = True
        V = self._vec
        if V is not None:
            # SoA fast path: write the arrays directly instead of going
            # through the _VecCore property layer (~6 property round-trips
            # per advance otherwise; this runs once per micro-op on every
            # core of a vectorized cluster or fleet)
            cid = core.cid
            V.counter_block[_C_INSTR, cid] += 1
            t = type(op)
            if t is Compute:
                c = op.cycles
                V.busy[cid] = c - 1 if c > 1 else 0  # this cycle counts
                V.state[cid] = _ACTIVE
                core.pending = None
            elif t is Mem or t is Poll:
                core.pending = op
                V.state[cid] = _STALL_MEM
                V.pend_bank[cid] = self._bank_of(op.addr)
                V.has_poll[cid] = t is Poll
            elif t is Scu:
                core.pending = op
                V.state[cid] = _STALL_SCU
            else:  # pragma: no cover - programming error
                raise TypeError(f"bad micro-op {op!r}")
            return
        core.instructions += 1
        if isinstance(op, Compute):
            core.busy = max(0, op.cycles - 1)  # this cycle counts as work
            core.state = CoreState.ACTIVE
            core.pending = None
        elif isinstance(op, (Mem, Poll)):
            core.pending = op
            core.state = CoreState.STALL_MEM
        elif isinstance(op, Scu):
            core.pending = op
            core.state = CoreState.STALL_SCU
        else:  # pragma: no cover - programming error
            raise TypeError(f"bad micro-op {op!r}")

    def _issue(self, core: _Core) -> None:
        state = core.state
        if state is CoreState.DONE:
            return
        if state is CoreState.ACTIVE:
            if core.busy > 0:
                core.busy -= 1
                return
            if core.pending is not None:
                # armed Poll whose retry shadow expired: re-enter the queue
                core.state = CoreState.STALL_MEM
                core.instructions += 1
                return
            self._advance(core, core.resume_value)
        elif state is CoreState.WAKING:
            core.wake_countdown -= 1
            if core.wake_countdown <= 0:
                core.state = CoreState.ACTIVE
                # response data already latched in resume_value
                self._advance(core, core.resume_value)
        elif state is CoreState.STALL_SCU and core.elw_issued:
            # busy-release window (Fig. 4 left): active, then clock gated
            core.sleep_entry -= 1
            if core.sleep_entry <= 0:
                core.state = CoreState.SLEEP

    def _bank_of(self, addr: int) -> int:
        return (addr >> 2) % self.n_banks

    def _arbitrate_tcdm(self) -> None:
        by_bank: Dict[int, List[_Core]] = {}
        for core in self.cores:
            if core.state is CoreState.STALL_MEM:
                by_bank.setdefault(self._bank_of(core.pending.addr), []).append(core)
        if by_bank and self.faults is not None:
            blk = self.faults.blacked_banks(self.cycle)
            if blk:
                # blacked-out banks grant nothing; queued requests are the
                # interconnect's fault, not contention -- no conflict charge
                for bank in blk:
                    by_bank.pop(bank, None)
        for bank, reqs in by_bank.items():
            # round-robin election among contenders
            rrb = int(self._rr[bank])
            n = self.n_cores
            reqs.sort(key=lambda c: (c.cid - rrb) % n)
            winner = reqs[0]
            self._rr[bank] = (winner.cid + 1) % n
            self.stats.bank_conflicts += len(reqs) - 1
            self._grant_mem(winner)

    def _grant_mem(self, winner: _Core) -> None:
        """Execute a granted TCDM transaction (shared by both arbiters)."""
        op = winner.pending
        winner.tcdm_accesses += 1
        if type(op) is Poll:
            value = self.tcdm.get(op.addr, 0)
            base = 0
            if op.kind == "tas":
                self.tcdm[op.addr] = -1
                winner.tas_accesses += 1
                base = self.TAS_CYCLES - 1
            if value == op.until:
                # hit: check cycles, then resume the program with the value
                winner.pending = None
                winner.resume_value = value
                winner.busy = base + op.hit_cycles
                winner.instructions += op.hit_instr
                if self._vec is not None:
                    self._vec.pend_bank[winner.cid] = -1
                    self._vec.has_poll[winner.cid] = False
            else:
                # miss: retry shadow, the Poll stays armed for re-issue
                winner.busy = base + op.miss_cycles
                winner.instructions += op.miss_instr
            winner.state = CoreState.ACTIVE
            return
        if op.kind == "lw":
            value = self.tcdm.get(op.addr, 0)
        elif op.kind == "sw":
            self.tcdm[op.addr] = op.data
            value = 0
        elif op.kind == "tas":
            value = self.tcdm.get(op.addr, 0)
            self.tcdm[op.addr] = -1
            winner.tas_accesses += 1
            # "-1 written back to memory in the next cycle before any
            # other core gets its request granted" (Sec. 4.1): the LINT
            # sequences the write-back through a forwarding write buffer
            # (atomicity is guaranteed by the arbitration order), and the
            # requesting core sees the full 3-cycle TAS latency.
            winner.busy = self.TAS_CYCLES - 1
        else:  # pragma: no cover
            raise ValueError(op.kind)
        # single-cycle TCDM: response consumed next cycle
        winner.pending = None
        winner.resume_value = value
        winner.state = CoreState.ACTIVE
        if self._vec is not None:
            self._vec.pend_bank[winner.cid] = -1
            self._vec.has_poll[winner.cid] = False

    def _service_scu(self) -> None:
        for core in self.cores:
            if core.state is CoreState.STALL_SCU and not core.elw_issued:
                self._service_one(core)

    def _service_one(self, core: _Core) -> None:
        """Service one fresh transaction on a private core<->SCU link."""
        op: Scu = core.pending
        V = self._vec
        if V is not None:
            # SoA fast path (see _advance): array writes, no property layer
            cid = core.cid
            V.counter_block[_C_SCU, cid] += 1
            if op.kind in ("write", "read"):
                value = self.scu.access(cid, op.kind, op.addr, op.data)
                core.pending = None
                core.resume_value = value if value is not None else 0
                V.state[cid] = _ACTIVE
            elif op.kind == "elw":
                self.scu.elw_trigger(cid, op.addr, op.data)
                V.elw[cid] = True
                V.sleep_entry[cid] = self.SLEEP_ENTRY_CYCLES
            else:  # pragma: no cover
                raise ValueError(op.kind)
            return
        core.scu_accesses += 1
        if op.kind in ("write", "read"):
            value = self.scu.access(core.cid, op.kind, op.addr, op.data)
            core.pending = None
            core.resume_value = value if value is not None else 0
            core.state = CoreState.ACTIVE
        elif op.kind == "elw":
            # Trigger the addressed extension exactly once per elw
            # transaction (FSM trigger-once guard, Sec. 5).
            self.scu.elw_trigger(core.cid, op.addr, op.data)
            core.elw_issued = True
            # Grant withheld for now; if the event is already buffered
            # the phase-4 poll grants in this same cycle with no
            # power management ("to not waste any cycles", Sec. 5).
            core.sleep_entry = self.SLEEP_ENTRY_CYCLES
        else:  # pragma: no cover
            raise ValueError(op.kind)

    def _wake_one(self, core: _Core) -> None:
        granted, value = self.scu.elw_poll(core.cid, core.pending.addr)
        if granted:
            V = self._vec
            if V is not None:
                # SoA fast path: immediate grants skip the clock-gate entry
                # latency but still pay grant + response + resume
                cid = core.cid
                never_slept = V.state[cid] == _STALL_SCU
                core.pending = None
                core.resume_value = value
                V.elw[cid] = False
                V.state[cid] = _WAKING
                V.wake[cid] = (
                    self.WAKE_CYCLES - 1 if never_slept else self.WAKE_CYCLES
                )
                return
            never_slept = core.state is CoreState.STALL_SCU
            core.pending = None
            core.elw_issued = False
            core.resume_value = value
            core.state = CoreState.WAKING
            # Immediate grants skip the clock-gate entry latency but still
            # pay grant + response + resume.
            core.wake_countdown = (
                self.WAKE_CYCLES - 1 if never_slept else self.WAKE_CYCLES
            )

    def _wake_cores(self) -> None:
        """Phase 4: poll every in-flight elw against the event buffers."""
        for core in self.cores:
            if core.pending is None or not core.elw_issued:
                continue
            if core.state not in (CoreState.STALL_SCU, CoreState.SLEEP):
                continue
            self._wake_one(core)

    # ------------------------------------------------------------- helpers
    def poke(self, addr: int, value: int) -> None:
        self.tcdm[addr] = value

    def peek(self, addr: int) -> int:
        return self.tcdm.get(addr, 0)


# ---------------------------------------------------------------------------
# Batched fleet simulation: many independent clusters, one array program
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetConfig:
    """One member of a batched fleet run: a cluster plus its programs.

    The cluster must be freshly constructed (``mode="fastforward"``, not yet
    loaded or run); :func:`simulate_fleet` loads ``programs`` itself so the
    per-core state lands in the fleet's flattened arrays.
    """

    cluster: Cluster
    programs: List[Program]
    max_cycles: int = 10_000_000


# sentinel for "no internal event due" in the segment-min reductions
_NO_BOUND = np.int64(1) << 60


class _FleetMember:
    """Bookkeeping of one config inside the fleet's flattened state.

    ``index`` is the member's segment id: the position in the config list
    for the static fleet (:class:`_Fleet`), the slot id for the
    slot-recycling fleet (:class:`SlotFleet`).  ``error`` stays ``None``
    except in slot mode, where a member that burns to its ``max_cycles``
    cap is marked failed instead of aborting the whole fleet.
    """

    __slots__ = ("index", "cluster", "max_cycles", "sl", "off", "done", "error")

    def __init__(self, index: int, cfg: FleetConfig, off: int):
        self.index = index
        self.cluster = cfg.cluster
        self.max_cycles = cfg.max_cycles
        self.off = off
        self.sl = slice(off, off + cfg.cluster.n_cores)
        self.done = False
        self.error: Optional[str] = None


def _check_fleet_config(cfg: FleetConfig, label: str, needs: str) -> None:
    """Shared admission validation of the static and slot-recycling fleets."""
    cl = cfg.cluster
    if cl.mode != "fastforward":
        raise ValueError(
            f"{label}: cluster mode must be 'fastforward', got {cl.mode!r}"
        )
    if len(cfg.programs) != cl.n_cores:
        raise ValueError(
            f"{label}: {len(cfg.programs)} programs for {cl.n_cores} cores"
        )
    if cl.cycle != 0 or cl.cores:
        raise ValueError(
            f"{label}: cluster already loaded or run; "
            f"{needs} needs a fresh cluster"
        )
    if cl.n_cores < 1:
        raise ValueError(f"{label}: cluster has no cores")


class _FleetEngine:
    """Shared flattened-array core of the two fleet dispatchers.

    Owns nothing itself -- subclasses allocate the flattened state
    (:class:`_Fleet` packs variable-size segments back to back;
    :class:`SlotFleet` uses fixed-width recyclable slots) and this base
    provides the member-attachment protocol plus the scheduling round:
    per-segment bound/spin reductions, the vectorized multi-span jump and
    the batched full step.  Every method here treats ``self.members`` as a
    list indexed by segment id (entries may be ``None`` in slot mode).

    Required fields (populated by the subclass):

    ``_vec``/``_rr``/``seg``/``local_cid``/``cfg_n``/``bank_base``/
    ``seg_offsets`` -- the flattened scheduler state and geometry;
    ``ev_buf``/``ev_mask``/``irq_mask``/``ntf_target``/``elw_wait`` -- the
    flattened SCU base-unit registers; ``_step_mask``/``_span_buf`` --
    reused scratch; ``members``/``_no_spin``/``_cl_list``/``_core_list``/
    ``_lcid_list`` -- per-segment and per-lane lookup tables.
    """

    # ------------------------------------------------------------ attachment
    def _attach_member(
        self, m: "_FleetMember", cfg: FleetConfig, bank_off: int
    ) -> None:
        """Adopt one member cluster's state into the flattened arrays.

        After this, the member's own engine code (generator advances, SCU
        servicing, the spin resolver) runs unchanged on *views* of the
        fleet-level storage -- the view is the segment partition.  The
        slot-recycling fleet calls this at admission time on a freshly
        zeroed segment; the static fleet calls it once per config at
        construction."""
        cl = m.cluster
        sl = m.sl
        cl.vectorized = True
        cl._vec = _VecState.view_of(self._vec, sl)
        cl._rr = self._rr[bank_off:bank_off + cl.n_banks]
        cl.max_cycles = m.max_cycles
        if cl.scu is not None:
            cl.scu.adopt_views(
                self.ev_buf[sl], self.ev_mask[sl], self.irq_mask[sl],
                self.ntf_target[sl], self.elw_wait[sl],
            )
        cl.cores = [
            _VecCore(i, prog(cl, i), cl._vec)
            for i, prog in enumerate(cfg.programs)
        ]
        cl.stats = ClusterStats()
        cl._n_done = 0

    # ------------------------------------------------------------ scheduling
    def _on_timeout(self, m: "_FleetMember") -> None:
        """A member hit its ``max_cycles`` cap.  The static fleet aborts the
        whole run (matching ``Cluster.run``); the slot fleet overrides this
        to mark the member failed so co-resident jobs keep running."""
        m.cluster._raise_timeout(m.max_cycles)

    def _round(self, live: List["_FleetMember"]) -> List["_FleetMember"]:
        """One scheduling round over the ``live`` members: per-segment
        bound/spin reductions in one flattened pass, then every member
        either jumps its own quiescent span, batch-resolves a spin phase,
        or joins the batched full step.  Returns the members that finished
        (or, in slot mode, failed) this round, with ``done`` set."""
        V = self._vec
        st = V.state
        offs = self.seg_offsets
        # -- per-config bounds + spin eligibility (one flattened pass,
        #    segment reductions instead of N per-member scans).  Cores of
        #    finished members and empty slots are all DONE, so no live-mask
        #    is needed: every state test below excludes them already.
        active = st == _ACTIVE
        waking = st == _WAKING
        stalled = st == _STALL_MEM
        stall_scu = st == _STALL_SCU
        sleeping = st == _SLEEP
        if sleeping.any():
            sleep_grant = sleeping & (
                (self.ev_buf & self.elw_wait) != 0
            )
        else:
            sleep_grant = sleeping
        adv_due = active & (V.busy <= 0)
        wake_due = waking & (V.wake <= 1)
        need = stalled | stall_scu
        need |= adv_due
        need |= wake_due
        need |= sleep_grant
        seg_need = np.logical_or.reduceat(need, offs).tolist()
        # one fused countdown-min reduction: busy for active cores,
        # wake-1 for waking cores, +inf sentinel otherwise
        countdown = np.where(
            active, V.busy, np.where(waking, V.wake - 1, _NO_BOUND)
        )
        seg_bound = np.minimum.reduceat(countdown, offs).tolist()
        # spin-phase eligibility, mirroring _spin_participants_vec: the
        # participants (armed Polls queued or in their retry shadow) and
        # the disqualifiers, reduced per segment
        if V.has_poll.any():
            part = V.has_poll & (stalled | active)
            spin_bad = stall_scu | (stalled & ~V.has_poll)
            spin_bad |= adv_due & ~part
            spin_bad |= wake_due
            spin_bad |= sleep_grant
            seg_spin = (
                np.logical_or.reduceat(part, offs)
                & ~np.logical_or.reduceat(spin_bad, offs)
            ).tolist()
        else:
            part = None
            seg_spin = self._no_spin

        jumps: List[Tuple[_FleetMember, int]] = []
        stepping: List[_FleetMember] = []
        finished: List[_FleetMember] = []
        for m in live:
            cl = m.cluster
            if cl.cycle >= m.max_cycles:
                self._on_timeout(m)  # static fleet: raises
                m.done = True
                finished.append(m)
                continue
            g = m.index
            if seg_need[g]:
                scu = cl.scu
                if (
                    seg_spin[g]
                    and (scu is None or scu.next_event_bound() is None)
                    and cl._resolve_spin_phase(np.flatnonzero(part[m.sl]))
                ):
                    continue
                stepping.append(m)
                continue
            b = seg_bound[g]
            scu = cl.scu
            if scu is not None:
                sb = scu.next_event_bound()
                if sb is not None:
                    if sb <= 0:
                        stepping.append(m)
                        continue
                    b = min(b, sb)
            if cl.faults is not None:
                fb = cl.faults.next_event_bound(cl.cycle)
                if fb is not None:
                    if fb <= 0:
                        stepping.append(m)
                        continue
                    b = min(b, fb)
            if b >= _NO_BOUND:
                # deadlock: no internal event in sight -- burn to the
                # cap so the failure matches the sequential engine
                b = m.max_cycles - cl.cycle
            jumps.append((m, min(b, m.max_cycles - cl.cycle)))

        if jumps:
            self._jump(jumps)
        if stepping:
            self._step(stepping)
            for m in stepping:
                err = m.cluster._watchdog_error()
                if err is not None:
                    self._on_deadlock(m, err)  # static fleet: raises
                    m.done = True
                    finished.append(m)
                    continue
                if m.cluster._n_done >= m.cluster.n_cores:
                    m.done = True
                    finished.append(m)
        return finished

    def _on_deadlock(self, m: "_FleetMember", err: "DeadlockError") -> None:
        """A member's watchdog tripped.  The static fleet aborts the run
        (matching ``Cluster.run``); the slot fleet contains the failure."""
        raise err

    # ----------------------------------------------------------------- jump
    def _jump(self, jumps: List[Tuple["_FleetMember", int]]) -> None:
        """Per-config quiescent-span jumps, one vectorized update.

        Every member jumps by its *own* bound (members sit at different
        local cycles); exactness per member follows from
        :meth:`Cluster.fast_forward` -- the span never exceeds the
        segment's proven bound."""
        V = self._vec
        st = V.state
        span = self._span_buf
        span[:] = 0
        for m, s in jumps:
            span[m.sl] = s
        # elementwise span products instead of fancy indexing: non-jumping
        # members carry span 0, so the unmasked updates are exact
        a_span = span * (st == _ACTIVE)
        w_span = span * (st == _WAKING)
        V.busy -= a_span
        V.wake -= w_span
        C = V.counters
        C["active_cycles"] += a_span
        C["active_cycles"] += w_span
        C["comp_cycles"] += a_span
        C["wait_cycles"] += w_span
        C["gated_cycles"] += span * (st == _SLEEP)
        for m, s in jumps:
            cl = m.cluster
            cl.cycle += s
            cl.ff_spans += 1
            cl.ff_cycles += s

    # ----------------------------------------------------------------- step
    def _step(self, stepping: List["_FleetMember"]) -> None:
        """One batched full cluster step over every member in ``stepping``.

        Phase order and semantics are identical to
        :meth:`Cluster._step_vec`, with every kernel masked to the stepping
        members' cores and the idiosyncratic transitions (generator
        advances, grants, SCU servicing) delegated to the member cluster --
        whose state lives in the same arrays."""
        V = self._vec
        st = V.state
        members = self.members
        cls_l = self._cl_list
        cores_l = self._core_list
        lcid_l = self._lcid_list
        mask = self._step_mask
        mask[:] = False
        for m in stepping:
            mask[m.sl] = True

        # Phase 0: injected upsets, then per-config extension comparators
        # (armed sets checked inline: a disarmed SCU's evaluate is a
        # guaranteed no-op -- unless a watchdog deadline is due, which
        # fires from inside evaluate).
        for m in stepping:
            cl = m.cluster
            if cl.faults is not None:
                cl.faults.apply(cl)
            scu = cl.scu
            if scu is not None and (
                scu._armed_barriers or scu._armed_mutexes or scu._armed_fifos
                or (scu.watchdog is not None and scu.watchdog_due(cl.cycle))
            ):
                cl.stats.scu_events += scu.evaluate(cl.cycle)

        # Phase 1a: countdowns (vectorized across configs; bool subtraction
        # instead of fancy indexing -- non-stepping cores subtract 0).
        active = st == _ACTIVE
        active &= mask
        counting = V.busy > 0
        counting &= active
        V.busy -= counting
        waking = st == _WAKING
        waking &= mask
        V.wake -= waking
        gating = st == _STALL_SCU
        gating &= V.elw
        gating &= mask
        if gating.any():
            V.sleep_entry -= gating
            gated = V.sleep_entry <= 0
            gated &= gating
            st[gated] = _SLEEP

        # Phase 1b: Poll re-issues (vectorized: an ACTIVE core with an armed
        # Poll and no busy left re-enters its bank queue -- the only way a
        # core sits ACTIVE with a pending op) and generator advances
        # (scalar; WAKING cores reaching 0 always advance, their pending was
        # consumed by the wake).
        CB = V.counter_block
        adv = active ^ counting  # active with no busy left (counting
        reissue = adv & V.has_poll  # is a subset of active, so xor == and-not)
        if reissue.any():
            st[reissue] = _STALL_MEM
            CB[_C_INSTR] += reissue
            adv ^= reissue
        wdue = V.wake <= 0
        wdue &= waking
        if wdue.any():
            st[wdue] = _ACTIVE
            adv |= wdue
        for g in np.nonzero(adv)[0].tolist():
            core = cores_l[g]
            cls_l[g]._advance(core, core.resume_value)

        # Phase 2: TCDM / LINT arbitration -- one lexsort across the
        # fleet's banks (bank ids offset per config, round-robin keys taken
        # modulo each config's own core count).
        req = np.nonzero(mask & (st == _STALL_MEM))[0]
        if req.size:
            blk_banks: Optional[List[int]] = None
            for m in stepping:
                f = m.cluster.faults
                if f is not None:
                    bb = f.blacked_banks(m.cluster.cycle)
                    if bb:
                        base = int(self.bank_base[m.off])
                        if blk_banks is None:
                            blk_banks = []
                        blk_banks.extend(base + b for b in bb)
            if blk_banks:
                gb = self.bank_base[req] + V.pend_bank[req]
                req = req[~np.isin(gb, blk_banks)]
        if req.size:
            gbank = self.bank_base[req] + V.pend_bank[req]
            key = (self.local_cid[req] - self._rr[gbank]) % self.cfg_n[req]
            order = np.lexsort((key, gbank))
            sorted_banks = gbank[order]
            first = np.ones(order.size, dtype=bool)
            first[1:] = sorted_banks[1:] != sorted_banks[:-1]
            winners = req[order[first]]
            if winners.size != req.size:
                n_req = np.bincount(self.seg[req], minlength=len(members))
                n_win = np.bincount(self.seg[winners], minlength=len(members))
                for m in stepping:
                    d = int(n_req[m.index] - n_win[m.index])
                    if d:
                        m.cluster.stats.bank_conflicts += d
            for g in winners.tolist():
                cl = cls_l[g]
                cid = lcid_l[g]
                cl._rr[cl._vec.pend_bank[cid]] = (cid + 1) % cl.n_cores
                cl._grant_mem_vec(cid)

        # Phase 3 + 4: SCU private links and elw grant scans.  ``stall_scu``
        # is sampled before servicing; that is safe for the pending scan
        # because a serviced read/write leaves ACTIVE with ``elw`` False and
        # the ``&= V.elw`` filter drops it.
        stall_scu = st == _STALL_SCU
        fresh = stall_scu & ~V.elw
        fresh &= mask
        for g in np.nonzero(fresh)[0].tolist():
            cls_l[g]._service_one(cores_l[g])
        if V.elw.any():
            pending = stall_scu | (st == _SLEEP)
            pending &= V.elw
            pending &= mask
            granted = (self.ev_buf & self.elw_wait) != 0
            granted &= pending
            for g in np.nonzero(granted)[0].tolist():
                cls_l[g]._wake_one(cores_l[g])

        # Phase 5: accounting (one state-code table gather, see _ACCT_INC;
        # non-stepping cores read the all-zero DONE column).
        stm = np.where(mask, st, _DONE)
        V.counter_block[:5] += _ACCT_INC[:, stm]
        for m in stepping:
            m.cluster.cycle += 1


class _Fleet(_FleetEngine):
    """The fleet engine: N independent clusters on one flattened SoA core.

    Every member cluster's scheduler state (:class:`_VecState`), round-robin
    pointers and SCU base-unit registers become *views* into fleet-level
    arrays laid out along a flattened ``(config, core)`` axis -- per-config
    segments partition TCDM bank arbitration, SCU registers, armed-extension
    sets and the ``next_event_bound()`` reduction, so configs never interact
    (each keeps its own TCDM dict, SCU instance, stats and local clock).

    The run loop generalizes :meth:`Cluster._run_fast` per segment:

    * per-config quiescent bounds come from segment-min reductions over the
      flattened arrays (one ``np.minimum.reduceat`` instead of N bound
      scans), and the global jump becomes a **per-config span jump** --
      members at different local cycles advance by their own bound in one
      vectorized update;
    * members whose bound is 0 first try their own spin-phase batch
      resolver (tier 2, unchanged -- it operates on the views), then join
      one **batched full step** whose phase kernels run over the cores of
      every stepping config at once -- this is what makes 8-core configs
      vectorizable for the first time (64 eight-core clusters = one
      512-lane array program);
    * members that finish early are masked out of every kernel.

    Each tier is individually exact (a full step *is* the reference
    semantics; any jump up to the bound is exact; the spin resolver is
    exact), so per-config results are bit-identical to a one-at-a-time
    ``Cluster.run()`` -- enforced by the fleet parity suite in
    ``tests/test_scu_simulator.py``.
    """

    def __init__(self, configs: List[FleetConfig]):
        self.members: List[_FleetMember] = []
        total = 0
        total_banks = 0
        for i, cfg in enumerate(configs):
            _check_fleet_config(cfg, f"fleet member {i}", "simulate_fleet")
            cl = cfg.cluster
            self.members.append(_FleetMember(i, cfg, total))
            total += cl.n_cores
            total_banks += cl.n_banks
        self.total = total

        # flattened (config, core) state + per-core constants
        self._vec = _VecState(total)
        self._rr = np.zeros(total_banks, dtype=np.int64)
        self.seg = np.zeros(total, dtype=np.int64)  # member index per core
        self.local_cid = np.zeros(total, dtype=np.int64)
        self.cfg_n = np.zeros(total, dtype=np.int64)  # member n_cores per core
        self.bank_base = np.zeros(total, dtype=np.int64)
        self.seg_offsets = np.zeros(len(self.members), dtype=np.int64)
        # flattened SCU base-unit registers + latched elw wait masks
        self.ev_buf = np.zeros(total, dtype=np.int64)
        self.ev_mask = np.zeros(total, dtype=np.int64)
        self.irq_mask = np.zeros(total, dtype=np.int64)
        self.ntf_target = np.zeros(total, dtype=np.int64)
        self.elw_wait = np.zeros(total, dtype=np.int64)
        self._step_mask = np.zeros(total, dtype=bool)  # reused per step
        self._span_buf = np.zeros(total, dtype=np.int64)  # reused per jump
        self._no_spin = [False] * len(self.members)  # shared, never mutated

        bank_off = 0
        for m, cfg in zip(self.members, configs):
            cl = m.cluster
            sl = m.sl
            n = cl.n_cores
            self.seg[sl] = m.index
            self.local_cid[sl] = np.arange(n)
            self.cfg_n[sl] = n
            self.bank_base[sl] = bank_off
            self.seg_offsets[m.index] = m.off
            # adopt the member's state into the fleet arrays: the member's
            # engine code keeps running unchanged on these views
            self._attach_member(m, cfg, bank_off)
            bank_off += cl.n_banks
        # plain-int lookup tables for the scalar loops (indexing a numpy
        # array with a Python int and converting is ~5x the list cost)
        self._lcid_list = self.local_cid.tolist()
        # per-core cluster + core-object tables: one list index from a
        # flattened core id to the owning member's state
        self._cl_list = [
            m.cluster for m in self.members for _ in range(m.cluster.n_cores)
        ]
        self._core_list = [c for m in self.members for c in m.cluster.cores]

    # ------------------------------------------------------------------ run
    def run(self) -> List[ClusterStats]:
        try:
            self._run()
        finally:
            for m in self.members:
                cl = m.cluster
                cl.stats.cycles = cl.cycle
                cl.stats.cores = [c.stats for c in cl.cores]
        return [m.cluster.stats for m in self.members]

    def _run(self) -> None:
        live = list(self.members)  # zero-core members rejected at build time
        while live:
            if self._round(live):
                live = [m for m in live if not m.done]


class SlotFleet(_FleetEngine):
    """Slot-recycling fleet: a fixed lane geometry that admits jobs mid-run.

    Where :class:`_Fleet` packs a *fixed* config list into back-to-back
    segments and drains them all, this engine owns ``n_slots`` recyclable
    segments of ``slot_cores`` lanes each and exposes an incremental API:

    * :meth:`admit` binds a fresh :class:`FleetConfig` (``n_cores <=
      slot_cores``) into the lowest free slot -- the same view adoption as
      the static fleet (:meth:`_FleetEngine._attach_member`), on freshly
      scrubbed lanes;
    * :meth:`advance` runs **one scheduling round** over every occupied
      slot and returns the members that completed (or failed) in it, with
      their :class:`ClusterStats` already materialized -- safe to read
      after the slot is recycled;
    * :meth:`free` scrubs a finished member's lanes back to ``DONE`` and
      returns the slot to the free list, ready for the next admission.

    Empty lanes (free slots, and the tail of a slot running a job narrower
    than ``slot_cores``) sit in the ``DONE`` state, whose column in every
    flattened kernel is neutral: segment reductions see ``+inf`` bounds and
    no needs, jumps multiply them by span 0, the step's accounting gather
    reads the all-zero ``DONE`` column.  That is what makes admission
    timing invisible to co-residents -- a job admitted while another slot
    is mid-quiescent-span neither shortens nor lengthens that span, it just
    changes which *scheduler round* resolves each event.  Per-member
    results therefore stay bit-exact against one-at-a-time ``Cluster.run()``
    calls regardless of what shared a step with them (enforced by the
    service parity suite in ``tests/test_fleet_service.py``).

    Deadlock/timeout semantics match :func:`simulate_fleet` per member: a
    member with no internal event in sight burns to its ``max_cycles`` cap
    and is then marked **failed** -- ``member.error`` carries the exact
    message ``Cluster.run`` would have raised -- instead of aborting the
    fleet, so co-resident jobs are unaffected.
    """

    def __init__(
        self, n_slots: int, slot_cores: int, banking_factor: int = 2
    ):
        if n_slots < 1 or slot_cores < 1:
            raise ValueError("SlotFleet needs at least one slot and one lane")
        self.n_slots = n_slots
        self.slot_cores = slot_cores
        self.slot_banks = banking_factor * slot_cores
        total = n_slots * slot_cores
        self.total = total

        # flattened (slot, lane) state -- fixed geometry, recycled in place
        self._vec = _VecState(total)
        self._vec.state[:] = _DONE  # every empty lane is neutral
        self._rr = np.zeros(n_slots * self.slot_banks, dtype=np.int64)
        self.seg = np.repeat(np.arange(n_slots, dtype=np.int64), slot_cores)
        self.local_cid = np.tile(
            np.arange(slot_cores, dtype=np.int64), n_slots
        )
        self.cfg_n = np.ones(total, dtype=np.int64)  # 1 on empty lanes: no %0
        self.bank_base = np.repeat(
            np.arange(n_slots, dtype=np.int64) * self.slot_banks, slot_cores
        )
        self.seg_offsets = (
            np.arange(n_slots, dtype=np.int64) * slot_cores
        )
        # flattened SCU base-unit registers + latched elw wait masks
        self.ev_buf = np.zeros(total, dtype=np.int64)
        self.ev_mask = np.zeros(total, dtype=np.int64)
        self.irq_mask = np.zeros(total, dtype=np.int64)
        self.ntf_target = np.zeros(total, dtype=np.int64)
        self.elw_wait = np.zeros(total, dtype=np.int64)
        self._step_mask = np.zeros(total, dtype=bool)
        self._span_buf = np.zeros(total, dtype=np.int64)
        self._no_spin = [False] * n_slots

        # slot directory: members[slot] is None while the slot is free
        self.members: List[Optional[_FleetMember]] = [None] * n_slots
        self._free: List[int] = list(range(n_slots))  # kept sorted
        self._lcid_list = self.local_cid.tolist()
        self._cl_list: List[Optional[Cluster]] = [None] * total
        self._core_list: List[Optional[_VecCore]] = [None] * total

    # ------------------------------------------------------------- occupancy
    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def occupied(self) -> int:
        return self.n_slots - len(self._free)

    # ------------------------------------------------------------------ admit
    def validate(self, cfg: FleetConfig) -> None:
        """Admission checks without claiming a slot (queue-time screening).

        Same config checks as :func:`simulate_fleet` plus the slot-width
        fit; raises ``ValueError`` on the first violation."""
        _check_fleet_config(cfg, "slot fleet job", "SlotFleet.admit")
        cl = cfg.cluster
        if cl.n_cores > self.slot_cores:
            raise ValueError(
                f"slot fleet job: {cl.n_cores} cores exceed the "
                f"{self.slot_cores}-lane slot width"
            )
        if cl.n_banks > self.slot_banks:
            raise ValueError(
                f"slot fleet job: {cl.n_banks} banks exceed the "
                f"{self.slot_banks}-bank slot range"
            )

    def admit(self, cfg: FleetConfig) -> int:
        """Bind a fresh config into the lowest free slot; returns the slot id.

        Raises ``ValueError`` on an invalid config (same checks as
        :func:`simulate_fleet`, plus the slot-width fit) and
        ``RuntimeError`` when no slot is free -- check :attr:`free_slots`
        first; queueing policy belongs to the caller (see
        ``repro_torch.serve.fleet_service``)."""
        self.validate(cfg)
        slot = self._claim()
        return self._bind(slot, cfg)

    def _claim(self, slot: Optional[int] = None) -> int:
        """Take a slot off the free list (the lowest, or a specific one)."""
        if not self._free:
            raise RuntimeError("SlotFleet.admit: no free slot")
        if slot is None:
            return self._free.pop(0)
        try:
            self._free.remove(slot)
        except ValueError:
            raise RuntimeError(
                f"SlotFleet: slot {slot} is not free"
            ) from None
        return slot

    def _bind(self, slot: int, cfg: FleetConfig) -> int:
        """Scrub ``slot``'s lanes and attach ``cfg`` (the admit body --
        restore reuses this path verbatim, so a restored member lands on
        exactly the residue-free lane state a fresh admission gets)."""
        cl = cfg.cluster
        off = slot * self.slot_cores
        full = slice(off, off + self.slot_cores)

        # scrub the whole slot: the previous occupant may have timed out
        # mid-SLEEP/STALL and view adoption only overwrites the SCU
        # registers, not the scheduler lanes
        V = self._vec
        V.state[full] = _DONE
        V.busy[full] = 0
        V.wake[full] = 0
        V.sleep_entry[full] = 0
        V.pend_bank[full] = -1
        V.has_poll[full] = False
        V.elw[full] = False
        V.counter_block[:, full] = 0
        self.ev_buf[full] = 0
        self.ev_mask[full] = 0
        self.irq_mask[full] = 0
        self.ntf_target[full] = 0
        self.elw_wait[full] = 0
        self.cfg_n[full] = 1
        bank_off = slot * self.slot_banks
        self._rr[bank_off:bank_off + self.slot_banks] = 0

        m = _FleetMember(slot, cfg, off)
        n = cl.n_cores
        self.cfg_n[m.sl] = n
        self._attach_member(m, cfg, bank_off)
        V.state[m.sl] = _ACTIVE  # lanes join the flattened passes now
        self.members[slot] = m
        for i in range(n):
            self._cl_list[off + i] = cl
            self._core_list[off + i] = cl.cores[i]
        return slot

    # ------------------------------------------------------------------ free
    def free(self, slot: int) -> None:
        """Recycle a finished (or failed) member's slot.

        The member's stats were materialized when :meth:`advance` returned
        it; after this call its lanes are ``DONE`` and the slot is back on
        the free list."""
        m = self.members[slot]
        if m is None:
            raise ValueError(f"SlotFleet.free: slot {slot} is already free")
        if not m.done:
            raise ValueError(f"SlotFleet.free: slot {slot} is still running")
        off = slot * self.slot_cores
        full = slice(off, off + self.slot_cores)
        V = self._vec
        # back to the neutral lane state (a timed-out member can leave
        # SLEEP/STALL lanes and latched elw waits behind)
        V.state[full] = _DONE
        V.has_poll[full] = False
        V.elw[full] = False
        self.ev_buf[full] = 0
        self.elw_wait[full] = 0
        self.cfg_n[full] = 1
        for i in range(off, off + self.slot_cores):
            self._cl_list[i] = None
            self._core_list[i] = None
        self.members[slot] = None
        bisect.insort(self._free, slot)

    # ----------------------------------------------------- checkpoint/restore
    def snapshot(self, slot: int):
        """Checkpoint the member in ``slot`` at the current round boundary.

        Non-destructive: the member keeps running.  Returns a
        :class:`repro_torch.core.scu.checkpoint.MemberCheckpoint`; raises
        :class:`~repro_torch.core.scu.checkpoint.NotCheckpointable` when the
        member runs generator-backed programs (callers fall back to
        restart) and ``ValueError`` on a free or finished slot."""
        from .checkpoint import capture_cluster

        m = self.members[slot]
        if m is None:
            raise ValueError(f"SlotFleet.snapshot: slot {slot} is free")
        if m.done:
            raise ValueError(
                f"SlotFleet.snapshot: slot {slot} already finished"
            )
        return capture_cluster(m.cluster)

    def suspend(self, slot: int):
        """Snapshot the member in ``slot`` and evict it (preemption).

        The slot is scrubbed and returned to the free list; the returned
        checkpoint resumes the job later via :meth:`restore` -- in this
        fleet or any other wide enough."""
        ckpt = self.snapshot(slot)
        m = self.members[slot]
        m.done = True  # free() refuses live members; this one is suspended
        self.free(slot)
        return ckpt

    def restore(self, ckpt, slot: Optional[int] = None, faults="carry"):
        """Re-admit a checkpointed member; returns the slot id.

        Runs the exact admission scrub+attach path on the lowest free slot
        (or a specific free ``slot``), then overwrites the fresh member
        with the checkpointed scheduler/SCU/TCDM state -- restore into any
        slot of any fleet is residue-free by construction.  ``faults``
        forwards to :func:`repro_torch.core.scu.checkpoint.resume_config`:
        ``"carry"`` resumes the checkpointed :class:`FaultPlan` cursor,
        ``None`` strips it (live migration to a healthy domain), a plan
        overrides."""
        from .checkpoint import apply_cluster_state, resume_config

        cfg = resume_config(ckpt, faults=faults)
        self.validate(cfg)
        slot = self._claim(slot)
        self._bind(slot, cfg)
        apply_cluster_state(self.members[slot].cluster, ckpt)
        return slot

    # --------------------------------------------------------------- advance
    def advance(self) -> List[_FleetMember]:
        """One scheduling round over every occupied slot.

        Returns the members that completed this round (``error`` set on the
        ones that hit their ``max_cycles`` cap), with ``ClusterStats``
        materialized -- the caller reads ``member.cluster.stats`` and then
        :meth:`free`\\ s the slot.  A fleet with no live member returns
        ``[]`` without touching the arrays."""
        live = [m for m in self.members if m is not None and not m.done]
        if not live:
            return []
        finished = self._round(live)
        for m in finished:
            cl = m.cluster
            cl.stats.cycles = cl.cycle
            cl.stats.cores = [c.stats for c in cl.cores]
        return finished

    def _on_timeout(self, m: _FleetMember) -> None:
        # capture exactly the message Cluster.run would have raised, but
        # contain the failure to this member
        try:
            m.cluster._raise_timeout(m.max_cycles)
        except RuntimeError as e:
            m.error = str(e)

    def _on_deadlock(self, m: _FleetMember, err: DeadlockError) -> None:
        # same containment for watchdog trips: the member is failed, the
        # co-resident jobs keep running
        m.error = str(err)


def simulate_fleet(configs: List[FleetConfig]) -> List[ClusterStats]:
    """Run N independent cluster configurations as one batched array program.

    Stacks the configs onto the structure-of-arrays engine core along a
    flattened ``(config, core)`` axis (see :class:`_Fleet`); results are
    **bit-exact per config** against one-at-a-time ``Cluster.run()`` calls.
    Empty-handed configs (``n_cores == 0``) are not supported; an empty
    ``configs`` list returns ``[]``.

    Use this for sweeps: a fleet of 64 eight-core clusters is a 512-lane
    array program, amortizing the per-step kernel overhead that makes
    individually-run 8-core clusters fall below the vectorization threshold
    (:attr:`Cluster.VEC_MIN_CORES`).
    """
    if not configs:
        return []
    return _Fleet(list(configs)).run()
