"""Static micro-op trace IR: core programs as data tables, not generators.

Own copy of the data side of ``repro/core/scu/trace.py`` (the port imports
nothing of ``repro``): the row encoding, the sentinel tracer, the
:class:`TraceBuilder` with its re-rolling of marked iterations into ``LOOP``
rows, the :class:`TraceProgram` record and the lowering helpers.  A
:class:`TraceProgram` is a per-core table of ``(op_kind, repeat, a0..a6)``
rows compiled from the ``Compute``/``Mem``/``Poll``/``Scu`` generator
programs, with an explicit "not traceable" escape: an untraceable program
still becomes a :class:`TraceProgram`, with ``is_traced`` False, which the
trace executor (``trace_exec.run_traces_torch``) refuses.

Not ported, because they drive the numpy engine, which stays in ``repro``:
``TraceProgram.__call__`` (a program as an engine ``Program``), the
``_TraceCursor`` that interprets a table for the engine, and the
``TraceRunMonitor`` that collapses periodic whole-cluster spans.

Value semantics: a trace tracks one register ``R`` mirroring the engine's
``resume_value`` -- every granted transaction latches into it, exactly like
the value sent into a generator.  ``BR`` branches compare ``R`` against an
immediate; ``sw`` rows may store ``R + delta`` (latched at fetch time, like
a generator computing from the value it received).  Programs whose control
flow depends on values in ways the IR cannot express are detected by the
sentinel tracer (:func:`trace_generator`) and fall back.

Lifecycle: a :class:`TraceProgram` is **single-use** -- the lowering that
produced it consumed one build of the (shared, mutable) policy state, and
the executor consumes it.  Re-running a config means re-lowering or
:meth:`TraceProgram.clone`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Set, Tuple

from .engine import Compute, Mem, Poll, Scu

__all__ = [
    "T_COMPUTE",
    "T_MEM",
    "T_POLL",
    "T_SCU",
    "T_JMP",
    "T_BR",
    "T_LOOP",
    "T_HALT",
    "Untraceable",
    "TraceBuilder",
    "TraceProgram",
    "trace_generator",
    "trace_fragments",
    "lower_or_fallback",
]

# --------------------------------------------------------------------------
# Row encoding: (op, repeat, a0..a6) int tuples.  Control rows cost zero
# cycles and zero instructions -- branch/loop costs are already folded into
# the Compute cycles the generators charge (see primitives.CostModel).
# --------------------------------------------------------------------------

T_COMPUTE = 0  # a0 = cycles
T_MEM = 1  # a0 = kind code, a1 = addr, a2 = data, a3 = 1 if data is R + a2
T_POLL = 2  # a0 = kind, a1 = addr, a2 = until, a3..a6 = hit_c/miss_c/hit_i/miss_i
T_SCU = 3  # a0 = index into the program's scu op pool
T_JMP = 4  # a0 = target row
T_BR = 5  # a0 = immediate, a1 = target row; taken when R == a0
T_LOOP = 6  # a0 = target row, a1 = count of back-jumps before falling through
T_HALT = 7

_MK_LW, _MK_SW, _MK_TAS = 0, 1, 2
_MEM_KIND_CODE = {"lw": _MK_LW, "sw": _MK_SW, "tas": _MK_TAS}

_DATA_OPS = (T_COMPUTE, T_MEM, T_POLL, T_SCU)

# Bound on resolved control rows per fetch: a trace whose control flow
# cycles without reaching a data op is malformed (it would hang the engine).
_CONTROL_GUARD = 100_000


class Untraceable(Exception):
    """The program's op stream depends on values the trace IR cannot carry."""


# --------------------------------------------------------------------------
# Sentinel tracer: prove value-independence by poisoning every resume value
# --------------------------------------------------------------------------


class _ValueUsed(Exception):
    pass


def _poison(*_a, **_k):
    raise _ValueUsed


class _Sentinel:
    """Poison resume value: any observation (comparison, arithmetic, truth
    test, hashing, conversion) raises; storing or ignoring it is allowed."""

    __slots__ = ()

    def __repr__(self) -> str:  # repr stays safe for error messages
        return "<trace sentinel>"


for _name in (
    "__eq__", "__ne__", "__lt__", "__le__", "__gt__", "__ge__", "__hash__",
    "__bool__", "__int__", "__index__", "__float__",
    "__add__", "__radd__", "__sub__", "__rsub__", "__mul__", "__rmul__",
    "__floordiv__", "__rfloordiv__", "__mod__", "__rmod__",
    "__and__", "__rand__", "__or__", "__ror__", "__xor__", "__rxor__",
    "__lshift__", "__rlshift__", "__rshift__", "__rrshift__", "__neg__",
    "__invert__", "__getitem__", "__iter__", "__len__", "__format__",
):
    setattr(_Sentinel, _name, _poison)

_SENTINEL = _Sentinel()


def _check_static(value: Any) -> Any:
    if isinstance(value, _Sentinel):
        raise Untraceable("micro-op embeds a value the program received")
    if isinstance(value, tuple):
        for item in value:
            _check_static(item)
    return value


# --------------------------------------------------------------------------
# Builder
# --------------------------------------------------------------------------


class TraceBuilder:
    """Append-only trace assembler with iteration marks and loop re-rolling.

    Emitters call :meth:`mark` at each iteration boundary; :meth:`build`
    re-rolls runs of identical marked segments (period 1..4, e.g. the
    sense-alternating barrier pair) into one segment plus a ``LOOP`` row --
    required for the table to stay small *and* for program counters to
    recur, which is what the period-collapse monitor keys on.  All branch
    targets must stay inside their own segment (asserted at build time).
    """

    def __init__(self) -> None:
        self._rows: List[Tuple[int, ...]] = []
        self._marks: List[int] = []
        self._scu_pool: List[Scu] = []
        self._scu_index: Dict[Tuple[Any, ...], int] = {}
        self._pinned: set = set()  # rows a label points at (no coalescing)

    # ------------------------------------------------------------- emitters
    def label(self) -> int:
        self._pinned.add(len(self._rows))
        return len(self._rows)

    def mark(self) -> None:
        if not self._marks or self._marks[-1] != len(self._rows):
            self._marks.append(len(self._rows))

    def _push(self, row: Tuple[int, ...]) -> int:
        idx = len(self._rows)
        self._rows.append(row)
        return idx

    def compute(self, cycles: int) -> int:
        cycles = int(_check_static(cycles))
        rows = self._rows
        if rows and len(rows) not in self._pinned:
            last = rows[-1]
            if last[0] == T_COMPUTE and last[2] == cycles and (
                not self._marks or self._marks[-1] != len(rows)
            ):
                rows[-1] = (T_COMPUTE, last[1] + 1, cycles, 0, 0, 0, 0, 0, 0)
                return len(rows) - 1
        return self._push((T_COMPUTE, 1, cycles, 0, 0, 0, 0, 0, 0))

    def mem(self, kind: str, addr: int, data: int = 0) -> int:
        code = _MEM_KIND_CODE[kind]
        return self._push((
            T_MEM, 1, code, int(_check_static(addr)), int(_check_static(data)),
            0, 0, 0, 0,
        ))

    def mem_delta(self, kind: str, addr: int, delta: int) -> int:
        """A store whose data is ``R + delta`` (latched at fetch time)."""
        code = _MEM_KIND_CODE[kind]
        return self._push((T_MEM, 1, code, int(addr), int(delta), 1, 0, 0, 0))

    def poll(
        self,
        kind: str,
        addr: int,
        until: int,
        hit_cycles: int,
        miss_cycles: int,
        hit_instr: int = 1,
        miss_instr: int = 2,
    ) -> int:
        code = _MEM_KIND_CODE[kind]
        return self._push((
            T_POLL, 1, code, int(_check_static(addr)),
            int(_check_static(until)), int(_check_static(hit_cycles)),
            int(_check_static(miss_cycles)), int(_check_static(hit_instr)),
            int(_check_static(miss_instr)),
        ))

    def scu(self, kind: str, addr: Any, data: int = 0) -> int:
        _check_static(addr)
        data = int(_check_static(data))
        key = (kind, addr, data)
        pool_idx = self._scu_index.get(key)
        if pool_idx is None:
            pool_idx = len(self._scu_pool)
            self._scu_pool.append(Scu(kind, addr, data))
            self._scu_index[key] = pool_idx
        return self._push((T_SCU, 1, pool_idx, 0, 0, 0, 0, 0, 0))

    def jmp(self, target: int = -1) -> int:
        return self._push((T_JMP, 1, target, 0, 0, 0, 0, 0, 0))

    def br_eq(self, imm: int, target: int = -1) -> int:
        return self._push((T_BR, 1, int(_check_static(imm)), target, 0, 0, 0, 0, 0))

    def set_target(self, row_idx: int, target: int) -> None:
        row = self._rows[row_idx]
        if row[0] == T_JMP:
            self._rows[row_idx] = (T_JMP, 1, target) + row[3:]
        elif row[0] == T_BR:
            self._rows[row_idx] = (T_BR, 1, row[2], target) + row[4:]
        else:  # pragma: no cover - programming error
            raise TypeError(f"row {row_idx} is not a branch")

    def emit_op(self, op: Any) -> None:
        """Record one engine micro-op object (the sentinel tracer's hook)."""
        t = type(op)
        if t is Compute:
            self.compute(op.cycles)
        elif t is Mem:
            self.mem(op.kind, op.addr, op.data)
        elif t is Poll:
            self.poll(
                op.kind, op.addr, op.until, op.hit_cycles, op.miss_cycles,
                op.hit_instr, op.miss_instr,
            )
        elif t is Scu:
            self.scu(op.kind, op.addr, op.data)
        else:
            raise Untraceable(f"not a static micro-op: {op!r}")

    # --------------------------------------------------------------- build
    @staticmethod
    def _target_of(row: Tuple[int, ...]) -> Optional[int]:
        if row[0] == T_JMP:
            return row[2]
        if row[0] == T_BR:
            return row[3]
        return None

    @staticmethod
    def _retarget(row: Tuple[int, ...], target: int) -> Tuple[int, ...]:
        if row[0] == T_JMP:
            return (T_JMP, row[1], target) + row[3:]
        return (T_BR, row[1], row[2], target) + row[4:]

    def _segments(self) -> List[Tuple[int, int]]:
        bounds = sorted({0, len(self._rows), *self._marks})
        return [
            (bounds[i], bounds[i + 1])
            for i in range(len(bounds) - 1)
            if bounds[i] < bounds[i + 1]
        ]

    def build(
        self,
        *,
        fallback: Optional[Callable[..., Any]] = None,
        label: str = "",
        roll: bool = True,
    ) -> "TraceProgram":
        segments = self._segments()
        # Canonical per-segment keys: rows with branch targets rebased to
        # segment-relative offsets, so identical iterations compare equal
        # wherever they land.  Cross-segment targets are an emitter error --
        # re-rolling could not preserve them.
        keys: List[Tuple[Tuple[int, ...], ...]] = []
        for start, end in segments:
            seg = []
            for idx in range(start, end):
                row = self._rows[idx]
                tgt = self._target_of(row)
                if tgt is not None:
                    if tgt < 0:
                        raise ValueError(f"unpatched branch target at row {idx}")
                    # ``tgt == end`` is the fall-through target ("skip to the
                    # next iteration"): after re-rolling it lands on the next
                    # segment, the LOOP row, or the final HALT -- all of which
                    # continue the program exactly like falling off the end.
                    if not (start <= tgt <= end):
                        raise ValueError(
                            f"branch at row {idx} targets row {tgt} outside "
                            f"its iteration segment [{start}, {end}]"
                        )
                    row = self._retarget(row, tgt - start)
                seg.append(row)
            keys.append(tuple(seg))

        out: List[Tuple[int, ...]] = []

        def emit_segment(seg: Tuple[Tuple[int, ...], ...]) -> int:
            base = len(out)
            for row in seg:
                tgt = self._target_of(row)
                if tgt is not None:
                    row = self._retarget(row, tgt + base)
                out.append(row)
            return base

        i = 0
        n_seg = len(keys)
        while i < n_seg:
            rolled = False
            if roll:
                for period in (1, 2, 3, 4):
                    if i + 2 * period > n_seg:
                        break
                    group = keys[i:i + period]
                    reps = 0
                    j = i + period
                    while j + period <= n_seg and keys[j:j + period] == group:
                        reps += 1
                        j += period
                    if reps >= 1:
                        base = len(out)
                        for seg in group:
                            emit_segment(seg)
                        out.append((T_LOOP, 1, base, reps, 0, 0, 0, 0, 0))
                        i += period * (reps + 1)
                        rolled = True
                        break
            if not rolled:
                emit_segment(keys[i])
                i += 1
        out.append((T_HALT, 1, 0, 0, 0, 0, 0, 0, 0))
        return TraceProgram(
            rows=tuple(out),
            scu_pool=tuple(self._scu_pool),
            fallback=fallback,
            label=label,
        )


# --------------------------------------------------------------------------
# The program object
# --------------------------------------------------------------------------


class TraceProgram:
    """A compiled per-core micro-op table (or a declared generator fallback).

    Single-use: the executor that runs it marks it consumed, and a second
    run raises -- :meth:`clone` (or re-lowering) produces a fresh usable
    instance for retries.
    """

    __slots__ = ("rows", "scu_pool", "fallback", "label", "_consumed")

    def __init__(
        self,
        rows: Optional[Tuple[Tuple[int, ...], ...]] = None,
        scu_pool: Tuple[Scu, ...] = (),
        fallback: Optional[Callable[..., Any]] = None,
        label: str = "",
    ):
        if rows is None and fallback is None:
            raise ValueError("TraceProgram needs a row table or a fallback")
        self.rows = rows
        self.scu_pool = scu_pool
        self.fallback = fallback
        self.label = label
        self._consumed = False

    @property
    def is_traced(self) -> bool:
        """True when a static table exists (False: generator fallback)."""
        return self.rows is not None

    @property
    def consumed(self) -> bool:
        return self._consumed

    def clone(self) -> "TraceProgram":
        """A fresh, un-consumed program sharing the immutable tables."""
        return TraceProgram(
            rows=self.rows, scu_pool=self.scu_pool,
            fallback=self.fallback, label=self.label,
        )

    def addresses(self) -> Set[int]:
        """Union of the static TCDM addresses the table touches."""
        addrs: Set[int] = set()
        if self.rows:
            for row in self.rows:
                if row[0] in (T_MEM, T_POLL):
                    addrs.add(row[3])
        return addrs

    def n_data_rows(self) -> int:
        return sum(1 for r in self.rows or () if r[0] in _DATA_OPS)


# --------------------------------------------------------------------------
# Lowering helpers: sentinel-trace generators into tables
# --------------------------------------------------------------------------


def trace_generator(tb: TraceBuilder, gen, max_ops: int = 200_000) -> int:
    """Drain ``gen`` into ``tb``, feeding a poisoned sentinel as every
    resume value.  Completing without observing a value *proves* the op
    stream is value-independent, so the linear recording is exact for any
    engine schedule.  Raises :class:`Untraceable` otherwise."""
    n = 0
    try:
        op = next(gen)
    except StopIteration:
        return 0
    except _ValueUsed:
        raise Untraceable("program observed a resume value") from None
    while True:
        n += 1
        if n > max_ops:
            gen.close()
            raise Untraceable(
                f"program exceeded {max_ops} recorded micro-ops (unbounded "
                "or data-dependent loop)"
            )
        tb.emit_op(op)
        try:
            op = gen.send(_SENTINEL)
        except StopIteration:
            return n
        except _ValueUsed:
            raise Untraceable("program observed a resume value") from None


def trace_fragments(
    tb: TraceBuilder,
    fragments: Iterable[Callable[[], Any]],
    max_ops: int = 200_000,
) -> int:
    """Sentinel-trace a sequence of per-iteration generator factories,
    marking each boundary so :meth:`TraceBuilder.build` can re-roll the
    repeated iterations into ``LOOP`` rows."""
    total = 0
    for make in fragments:
        tb.mark()
        total += trace_generator(tb, make(), max_ops=max_ops)
        if total > max_ops:
            raise Untraceable(f"program exceeded {max_ops} recorded micro-ops")
    return total


def lower_or_fallback(
    program: Callable[..., Any],
    cluster,
    cid: int,
    *,
    fragments: Optional[Callable[[], Iterable[Callable[[], Any]]]] = None,
    emit: Optional[Callable[[TraceBuilder], None]] = None,
    label: str = "",
) -> TraceProgram:
    """Compile one core's program into a :class:`TraceProgram`.

    Strategy order: an explicit ``emit`` hook (policy-provided BR-based
    emitter for value-dependent fragments), then ``fragments`` (marked
    per-iteration sentinel tracing), then whole-program sentinel tracing of
    ``program(cluster, cid)``.  An :class:`Untraceable` program becomes a
    declared generator fallback carrying ``program`` -- the escape hatch,
    still a valid ``TraceProgram`` for every dispatch layer."""
    tb = TraceBuilder()
    try:
        if emit is not None:
            emit(tb)
        elif fragments is not None:
            trace_fragments(tb, fragments())
        else:
            trace_generator(tb, program(cluster, cid))
    except Untraceable:
        return TraceProgram(fallback=program, label=label or f"fallback:{cid}")
    return tb.build(label=label or f"trace:{cid}")

