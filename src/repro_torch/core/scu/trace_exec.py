"""The batched trace executor: pure-TCDM traces as one array program on the card.

Counterpart of ``run_traces_xp`` / ``run_traces_jax`` of
``repro/core/scu/trace.py`` (``:832``, ``:1143``): the engine's TCDM
semantics (issue, per-bank round-robin arbitration, Poll retry, phase-5
accounting) as tensor operations over every core ("lane") at once.  The
reference runs it as one ``jax.lax.while_loop``; here a block of K cycles is
captured once as one CUDA graph and replayed, and the host reads one
done-flag and the cycle count a replay.  On the CPU the same block runs
eagerly.  The per-cycle step stays PyTorch ops: no Pallas kernel stands
behind it, and none is written here.

The port is held to the engine (its own ``Cluster(..., mode="lockstep")``), not to
the reference executor, which differs from it in two places:

* The reference's ``_set`` writes every lane's index, and masked-off lanes
  write back the old value, so a losing lane that names the same word can
  undo the winner's store or test-and-set.  Here only the lanes in the mask
  write: every scattered array (``tcdm``, ``rr``, the per-lane loop
  counters) has a sink slot a lane, which a masked-off lane writes and
  nobody reads.  Each bank grants at most one lane and each word lies in one bank,
  so a real slot sees at most one writer a cycle (``index_put_`` with
  duplicate indices has no defined order on CUDA).
* The reference builds an ``(n_banks, n)`` key matrix every cycle.  Here
  arbitration is O(n): a requesting lane's key is ``(lane - rr[bank]) mod
  n``, one ``scatter_reduce(amin)`` gives each bank's least key, the lane
  whose key equals it wins, and the bank's pointer moves past the winner.

The state is int64 on the device (the JAX executor runs int32 unless x64 is
on).  Nothing in a block syncs with the host: no boolean-mask indexing, no
``.item()``, no ``nonzero``.  Each cycle computes ``live`` (some lane is not
done and the cycle is below ``max_cycles``) on the device and folds it into
every mask, so a finished run's state stays frozen and the results do not
depend on K.  The inner fetch loop, which the reference runs until no lane
fetches, is unrolled to the longest path through the tables' control rows,
known on the host.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.compat import resolve_device

from .engine import _COUNTERS
from .trace import _CONTROL_GUARD, _MK_LW, _MK_SW, _MK_TAS, T_BR, T_COMPUTE, T_HALT, T_JMP, T_LOOP, T_MEM, T_POLL, T_SCU

__all__ = ["run_traces_torch", "control_depth", "BLOCK_CYCLES"]

_X_ACTIVE, _X_STALL, _X_DONE = 0, 1, 2
# counter rows (``_COUNTERS``' order)
_C_ACTIVE, _C_COMP, _C_WAIT, _C_STALL, _C_INSTR, _C_TCDM, _C_TAS = 0, 1, 2, 4, 5, 6, 7

# cycles a block: one CUDA graph replay, one host sync
BLOCK_CYCLES = 64


def _pack_tables(programs: Sequence) -> tuple:
    """Flatten trace tables into padded per-lane numpy arrays.

    Own copy of ``repro/core/scu/trace.py:807``: ``tab[lane, row]`` is the
    row, padded with ``HALT``; a ``MEM``/``POLL`` row's address becomes its
    index into ``addrs``, the sorted union of every program's addresses.
    """
    for p in programs:
        if not p.is_traced:
            raise ValueError("array executor needs pure traced programs")
        for row in p.rows:
            if row[0] == T_SCU:
                raise ValueError(
                    "array executor supports pure-TCDM traces only "
                    "(SCU rows need the full engine)"
                )
    n = len(programs)
    length = max(len(p.rows) for p in programs)
    addrs = np.array(sorted(set().union(*(p.addresses() for p in programs))), dtype=np.int64)
    tab = np.zeros((n, length, 9), dtype=np.int64)
    tab[:, :, 0] = T_HALT
    for lane, p in enumerate(programs):
        tab[lane, : len(p.rows)] = p.rows
    memp = (tab[:, :, 0] == T_MEM) | (tab[:, :, 0] == T_POLL)
    tab[:, :, 3][memp] = np.searchsorted(addrs, tab[:, :, 3][memp])
    return tab, addrs


def control_depth(rows: Sequence[Sequence[int]]) -> int:
    """The most control rows one fetch can resolve before it reaches a data row.

    The longest path through the control rows (``JMP``, ``BR``, ``LOOP``,
    ``HALT``), following every edge a row can take (a branch taken or not, a
    loop back or through) and fall-through, counted in rows: a ``LOOP`` can
    jump back onto a ``BR``.  A cycle of control rows with no data row on it
    would spin a fetch forever (``_CONTROL_GUARD`` rows in the engine's
    cursor) and raises ``ValueError``.
    """
    n = len(rows)

    def successors(pc):
        kind, _, a0, a1 = rows[pc][:4]
        if kind == T_JMP:
            return (a0,)
        if kind == T_BR:
            return (a1, pc + 1)
        if kind == T_LOOP:
            return (a0, pc + 1)
        return ()  # HALT

    depth: Dict[int, int] = {}
    for start in range(n):
        if rows[start][0] < T_JMP or start in depth:
            continue
        # iterative depth-first search; ``on_path`` finds a control cycle
        stack, on_path = [start], {start}
        while stack:
            pc = stack[-1]
            pending = [s for s in successors(pc) if s < n and rows[s][0] >= T_JMP and s not in depth]
            for s in pending:
                if s in on_path:
                    raise ValueError(
                        f"control rows cycle through row {s} without reaching a data row "
                        f"(the engine's cursor gives up after {_CONTROL_GUARD} rows)"
                    )
            if pending:
                stack.append(pending[0])
                on_path.add(pending[0])
                continue
            depth[pc] = 1 + max((depth.get(s, 0) for s in successors(pc) if s < n), default=0)
            stack.pop()
            on_path.discard(pc)
    return max(depth.values(), default=0)


# int columns of the executor's row table (derived from the packed rows on the
# host); _I_A1 is a MEM/POLL row's address index and a LOOP row's count
(_I_REP, _I_BUSY, _I_A1, _I_DATA, _I_TAKEN, _I_NOT_TAKEN, _I_IMM,
 _I_HIT_C, _I_MISS_C, _I_HIT_I, _I_MISS_I) = range(11)
# bool columns
(_F_DATA, _F_CTRL, _F_COMPUTE, _F_MEMP, _F_MEM, _F_DELTA, _F_BR, _F_LOOP, _F_HALT,
 _F_POLL, _F_TAS, _F_LOADS, _F_SW, _F_MEM_TAS) = range(14)


def _row_columns(tab: np.ndarray) -> tuple:
    """The packed rows as the executor reads them: ``(int columns, bool columns)``,
    each ``(k, length * n)`` with row ``pc`` of lane ``l`` at ``pc * n + l``.
    One gather a pass fetches every field a phase needs, each field a
    contiguous vector, and no phase compares op kinds; lanes at the same pc
    read neighbouring words."""
    n, length, _ = tab.shape
    kind, rep, a0, a1, a2, a3, a4, a5, a6 = (tab[:, :, j] for j in range(9))
    pc = np.arange(length)[None, :]
    jmp, br, loop, halt = kind == T_JMP, kind == T_BR, kind == T_LOOP, kind == T_HALT
    is_mem, is_poll = kind == T_MEM, kind == T_POLL
    # a control row's two successors: BR taken when R == a0, LOOP while its counter
    # is positive; a JMP takes a0 either way and a HALT stays
    taken = np.select([jmp | loop, br], [a0, a1], pc)
    not_taken = np.select([jmp, br | loop], [a0, pc + 1], pc)
    ints = np.stack([rep, np.where(kind == T_COMPUTE, np.maximum(a0 - 1, 0), 0), a1, a2, taken, not_taken,
                     a0, a3, a4, a5, a6], axis=-1)
    flags = np.stack([kind <= T_SCU, kind >= T_JMP, kind == T_COMPUTE, is_mem | is_poll, is_mem,
                      is_mem & (a3 == 1), br, loop, halt, is_poll, (is_mem | is_poll) & (a0 == _MK_TAS),
                      is_mem & ((a0 == _MK_LW) | (a0 == _MK_TAS)), is_mem & (a0 == _MK_SW),
                      is_mem & (a0 == _MK_TAS)], axis=-1)
    return (ints.transpose(2, 1, 0).reshape(-1, length * n), flags.transpose(2, 1, 0).reshape(-1, length * n))


class _Executor:
    """The tables and the state of one run, and the cycle step over them."""

    def __init__(self, tab: np.ndarray, addrs: np.ndarray, depth: int, *, n_banks: int, tas_cycles: int,
                 max_cycles: int, device: torch.device):
        n, length, _ = tab.shape
        self.n, self.depth = n, depth
        self.n_banks, self.tas_cycles, self.max_cycles = n_banks, tas_cycles, max_cycles
        self.n_addrs = len(addrs)
        i64 = dict(dtype=torch.int64, device=device)
        ints, flags = _row_columns(tab)
        self.ints = torch.as_tensor(ints, **i64)
        self.flags = torch.as_tensor(flags, device=device)
        self.lanes = torch.arange(n, **i64)
        self.next_lane = torch.remainder(self.lanes + 1, n)
        # a sink slot a lane in every scattered array, so that masked-off lanes
        # neither write a real slot nor pile onto one address: lane l's sink word
        # is n_addrs + l, and it lies in its sink bank n_banks + l
        self.word_sink = self.n_addrs + self.lanes
        self.bank_sink = n_banks + self.lanes
        self.addr_bank = torch.cat([torch.as_tensor((addrs >> 2) % n_banks, **i64), self.bank_sink])
        self.ctr_sink = length * n + self.lanes
        self.state = {
            "pc": torch.zeros(n, **i64),
            "rep": torch.zeros(n, **i64),
            "R": torch.zeros(n, **i64),
            "st": torch.zeros(n, **i64),
            "busy": torch.zeros(n, **i64),
            "pend": torch.full((n,), -1, **i64),  # row of the pending op
            "pdata": torch.zeros(n, **i64),  # latched store data
            "tcdm": torch.zeros(self.n_addrs + n, **i64),  # + the sink words
            "rr": torch.zeros(n_banks + n, **i64),  # + the sink banks
            "ctr": torch.full(((length + 1) * n,), -1, **i64),  # at pc * n + lane, + the sinks; -1 unarmed
            "cnt": torch.zeros((len(_COUNTERS), n), **i64),
            "conflicts": torch.zeros((), **i64),
            "fin": torch.full((n,), -1, **i64),
            "cycle": torch.zeros((), **i64),
        }

    def _rows(self, pc: torch.Tensor) -> tuple:
        """Every lane's row ``pc``: its int and bool columns, ``(k, n)`` each."""
        at = pc * self.n + self.lanes
        return self.ints.index_select(1, at), self.flags.index_select(1, at)

    # -- the fetch loop: one data row issued, or one control row resolved -----------
    def _issue_data(self, s: dict, ints: torch.Tensor, flags: torch.Tensor, fetch: torch.Tensor) -> torch.Tensor:
        """Fetching lanes whose pc sits on a data row issue it; returns who still fetches."""
        pc, rep = s["pc"], s["rep"]
        data = fetch & flags[_F_DATA]
        r = torch.where(rep > 0, rep, ints[_I_REP]) - 1
        s["pc"] = torch.where(data & (r == 0), pc + 1, pc)
        s["rep"] = torch.where(data, r, rep)
        s["cnt"][_C_INSTR].add_(data)
        s["busy"] = torch.where(data & flags[_F_COMPUTE], ints[_I_BUSY], s["busy"])
        # MEM / POLL: pend at the issuing row and stall; a store latches its data now
        memp = data & flags[_F_MEMP]
        s["st"] = torch.where(memp, _X_STALL, s["st"])
        s["pend"] = torch.where(memp, pc, s["pend"])
        stored = ints[_I_DATA] + s["R"] * flags[_F_DELTA]
        s["pdata"] = torch.where(data & flags[_F_MEM], stored, s["pdata"])
        return fetch & flags[_F_CTRL]

    def _decode_step(self, s: dict, ints: torch.Tensor, flags: torch.Tensor, fetch: torch.Tensor) -> torch.Tensor:
        """Fetching lanes (all on control rows now) resolve the row at their pc;
        returns who still fetches."""
        pc = s["pc"]
        # LOOP: a counter a (lane, row), armed with the row's count on first use
        at = pc * self.n + self.lanes
        cur = s["ctr"][at]
        cur = torch.where(cur < 0, ints[_I_A1], cur)
        taken = torch.where(flags[_F_BR], s["R"] == ints[_I_IMM], cur > 0)
        s["pc"] = torch.where(fetch, torch.where(taken, ints[_I_TAKEN], ints[_I_NOT_TAKEN]), pc)
        s["ctr"].index_put_((torch.where(fetch & flags[_F_LOOP], at, self.ctr_sink),),
                            torch.where(cur > 0, cur - 1, -1))
        halt = fetch & flags[_F_HALT]
        s["st"] = torch.where(halt, _X_DONE, s["st"])
        s["fin"] = torch.where(halt & (s["fin"] < 0), s["cycle"], s["fin"])
        return fetch & ~flags[_F_HALT]

    # -- phase 2: per-bank round-robin arbitration and the transactions' effects ----
    def _grant(self, s: dict, live: torch.Tensor) -> None:
        n, sink = self.n, self.word_sink
        req = (s["st"] == _X_STALL) & live
        ints, flags = self._rows(torch.where(req, s["pend"], 0))
        aidx = torch.where(req, ints[_I_A1], sink)
        bank = self.addr_bank[aidx]  # its sink bank for a lane that does not request
        rr = s["rr"]
        key = torch.remainder(self.lanes - rr[bank], n)
        least = torch.full_like(rr, n).scatter_reduce(0, bank, key, "amin")
        win = req & (key == least[bank])
        s["conflicts"] = s["conflicts"] + (req ^ win).sum()  # requesters not granted (win is within req)
        rr.index_put_((torch.where(win, bank, self.bank_sink),), self.next_lane)
        cnt = s["cnt"]
        cnt[_C_TCDM].add_(win)
        tcdm = s["tcdm"]
        val = tcdm[aidx]
        is_tas = win & flags[_F_TAS]
        cnt[_C_TAS].add_(is_tas)
        # a poll hits when the word holds ``until``; a test-and-set (Mem or Poll)
        # writes -1 and holds the core for the TAS latency
        is_poll = win & flags[_F_POLL]
        hit_v = val == ints[_I_DATA]
        hit, miss = is_poll & hit_v, is_poll & ~hit_v
        busy = torch.where(is_tas, self.tas_cycles - 1, 0) + torch.where(hit_v, ints[_I_HIT_C], ints[_I_MISS_C])
        busy = torch.where(is_poll, busy, s["busy"])
        s["busy"] = torch.where(win & flags[_F_MEM_TAS], self.tas_cycles - 1, busy)
        cnt[_C_INSTR].add_(torch.where(hit_v, ints[_I_HIT_I], ints[_I_MISS_I]) * is_poll)
        is_sw = win & flags[_F_SW]
        R = torch.where(hit | (win & flags[_F_LOADS]), val, s["R"])
        s["R"] = torch.where(is_sw, 0, R)
        tcdm.index_put_((torch.where(is_tas, aidx, sink),), torch.full_like(aidx, -1))
        tcdm.index_put_((torch.where(is_sw, aidx, sink),), s["pdata"])
        # winners go ACTIVE; a missed poll stays armed and re-issues
        s["pend"] = torch.where(win & ~miss, -1, s["pend"])
        s["st"] = torch.where(win, _X_ACTIVE, s["st"])

    def cycle_step(self, s: dict) -> dict:
        """One cycle.  The scattered arrays (``tcdm``, ``rr``, ``ctr``) and the
        counters are updated in place; the other entries of ``s`` are replaced."""
        s = dict(s)
        live = (s["st"] != _X_DONE).any() & (s["cycle"] < self.max_cycles)
        # phase 1: issue.  busy countdown; armed polls re-enter the queue (one
        # instruction, like the engine's re-issue); everyone else fetches through
        # the table until a data row lands
        st, busy = s["st"], s["busy"]
        act = (st == _X_ACTIVE) & live
        counting = act & (busy > 0)
        advancing = act & ~counting
        s["busy"] = torch.where(counting, busy - 1, busy)
        armed = s["pend"] >= 0
        reissue = advancing & armed
        s["st"] = torch.where(reissue, _X_STALL, st)
        s["cnt"][_C_INSTR].add_(reissue)
        fetch = advancing & ~armed
        for _ in range(self.depth):
            ints, flags = self._rows(s["pc"])
            fetch = self._issue_data(s, ints, flags, fetch)
            fetch = self._decode_step(s, ints, flags, fetch)
        self._issue_data(s, *self._rows(s["pc"]), fetch)
        # phase 2: arbitration and grants; phase 5: accounting
        self._grant(s, live)
        st, cnt = s["st"], s["cnt"]
        cnt[_C_ACTIVE].add_((st != _X_DONE) & live)
        cnt[_C_COMP].add_((st == _X_ACTIVE) & live)
        stall = (st == _X_STALL) & live
        cnt[_C_WAIT].add_(stall)
        cnt[_C_STALL].add_(stall)
        s["cycle"] = s["cycle"] + live
        return s

    def block(self, s: dict, cycles: int) -> dict:
        for _ in range(cycles):
            s = self.cycle_step(s)
        return s

    def done_and_cycle(self, s: dict) -> torch.Tensor:
        """``[every lane done, cycle]``: what the host reads a block."""
        return torch.stack([(s["st"] == _X_DONE).all().to(torch.int64), s["cycle"]])


class _CapturedBlock:
    """K cycle steps captured once as one CUDA graph over static state tensors."""

    def __init__(self, ex: _Executor, cycles: int):
        self.state = ex.state
        # a warm-up on a copy, so that the capture meets initialised kernels
        # and the run's state does not advance
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            ex.block({k: v.clone() for k, v in ex.state.items()}, 1)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            out = ex.block(dict(self.state), cycles)
            for k, v in self.state.items():
                if out[k] is not v:
                    v.copy_(out[k])
            self.done_and_cycle = ex.done_and_cycle(self.state)
        self.replays = 0

    def replay(self) -> List[int]:
        self.graph.replay()
        self.replays += 1
        return self.done_and_cycle.tolist()


def _table_depth(tab: np.ndarray) -> int:
    """:func:`control_depth` over every lane's table, taken once a distinct
    control skeleton (op kinds and targets; data rows and immediates zeroed)."""
    n, length, _ = tab.shape
    kind = tab[:, :, 0]
    skel = np.zeros((n, length, 4), dtype=np.int64)
    skel[:, :, 0] = np.where(kind >= T_JMP, kind, T_COMPUTE)
    skel[:, :, 2] = np.where((kind == T_JMP) | (kind == T_LOOP), tab[:, :, 2], 0)
    skel[:, :, 3] = np.where(kind == T_BR, tab[:, :, 3], 0)
    # one lane's skeleton as one opaque value: np.unique sorts these far faster than rows (axis=0)
    flat = skel.reshape(n, -1)
    _, first = np.unique(flat.view(np.dtype((np.void, flat.shape[1] * flat.itemsize))).ravel(), return_index=True)
    return max(control_depth(flat[i].reshape(length, 4).tolist()) for i in first)


@torch.inference_mode()
def run_traces_torch(
    programs: Sequence,
    *,
    n_banks: int,
    tas_cycles: int = 3,
    max_cycles: int = 10_000_000,
    device: Union[str, torch.device] = "cuda",
    block_cycles: int = BLOCK_CYCLES,
    stats: Optional[dict] = None,
) -> dict:
    """Execute pure-TCDM traces as one batched tensor program.

    Returns what ``run_traces_xp`` returns: ``cycles``, ``counters`` (numpy
    rows by name, ``_COUNTERS``' order), ``bank_conflicts``, ``finished_at``
    (numpy, a core) and ``tcdm`` as ``{addr: value}`` over every address the
    programs touch.  Consumes the programs (single-use); reads of each only
    ``rows``, ``addresses()``, ``is_traced`` and the consumed flag.  Raises
    ``ValueError`` on SCU rows or a control cycle, ``RuntimeError`` on a
    consumed program or when the run is not done at ``max_cycles``.

    ``device`` defaults to the card and raises without one.  On the card a
    block of ``block_cycles`` cycles runs as one captured CUDA graph, or the
    call raises; on the CPU it runs eagerly.  ``stats``, if given, receives
    ``block_cycles``, ``replays`` (blocks run; one host sync each),
    ``capture_s`` and ``run_s`` (host clock: the capture, then the blocks up
    to the last sync) and ``depth`` (the fetch passes unrolled a cycle).
    """
    dev = resolve_device(device)
    if block_cycles < 1:
        raise ValueError(f"block_cycles must be at least 1, got {block_cycles}")
    for p in programs:
        if p.consumed:
            raise RuntimeError("TraceProgram already consumed (single-use)")
        p._consumed = True
    tab, addrs = _pack_tables(programs)
    depth = _table_depth(tab)
    ex = _Executor(tab, addrs, depth, n_banks=n_banks, tas_cycles=tas_cycles, max_cycles=max_cycles, device=dev)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        captured = _CapturedBlock(ex, block_cycles)
        t1 = time.perf_counter()
        while True:
            done, cycle = captured.replay()
            if done or cycle >= max_cycles:
                break
        replays = captured.replays
    else:
        t1, replays, state = t0, 0, ex.state
        while True:
            state = ex.block(state, block_cycles)
            replays += 1
            done, cycle = ex.done_and_cycle(state).tolist()
            if done or cycle >= max_cycles:
                break
        ex.state = state
    t2 = time.perf_counter()
    if not done:
        raise RuntimeError(f"traced run did not finish within {max_cycles} cycles")
    if stats is not None:
        stats.update(block_cycles=block_cycles, replays=replays, capture_s=t1 - t0, run_s=t2 - t1, depth=depth)
    state = {k: v.cpu().numpy() for k, v in ex.state.items()}
    return {
        "cycles": int(cycle),
        "counters": {name: state["cnt"][i] for i, name in enumerate(_COUNTERS)},
        "bank_conflicts": int(state["conflicts"]),
        "finished_at": state["fin"],
        "tcdm": dict(zip(addrs.tolist(), state["tcdm"][: len(addrs)].tolist())),
    }
