"""A fourth discipline: log-depth tree/hierarchical barrier (MemPool-style).

Counterpart of ``repro/sync/tree.py``; the chip level runs over a party axis
of ``repro_torch.sync.axis`` (stacked, or one party a process).

Proves the ``repro_torch.sync`` extension point: this policy is registered once
and shows up with zero per-layer special-casing in Table 1, the Fig. 5
sweep, Table 2, the chip-level wall-clock benchmark and the training path.

The discipline follows the hierarchical barriers used by large shared-L1
clusters (MemPool, arXiv 2303.17742): instead of all cores contending on
one counter (the SW/TAS pattern) or dedicated hardware (SCU), arrivals are
combined up a binary tournament tree -- O(log n) depth, and each shared
flag word is only ever written by one core and read by one core, so the
hot-spot bank traffic of the central-counter barrier disappears.

  * simulator -- software tournament barrier with sense reversal: core
    ``cid`` publishes its arrival at the first level where its base-``radix``
    digit is non-zero into its private flag word; block representatives wait
    for their ``radix - 1`` partners' subtrees, the champion (core 0)
    broadcasts the release word.  ``radix`` is a policy parameter
    (:func:`make_tree_policy`): depth is ``ceil(log_radix n)``, so radix 4
    halves the tree depth of the default radix-2 tournament on 16-core
    clusters at the cost of wider fan-in spins per level.
  * chip level -- butterfly (recursive-doubling) exchange: log2(n) pairwise
    rounds; the released count is the sum of the exchanged values (blocks
    are disjoint, so the sum is exact).  Non-power-of-two groups fall back
    to the dissemination exchange, which is also log-depth and exact.
  * training -- hierarchical bucketed reduce-scatter: numerically identical
    to the ``scu`` fine-grain discipline; optimizer state is ZeRO-sharded the
    same way.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.scu.engine import Compute, Mem, Poll, Scu
from repro_torch.core.scu.primitives import DEFAULT_COSTS, sw_mutex_section
from repro_torch.sync.api import PolicyDef, register_policy
from repro_torch.sync.axis import axis_size, ppermute
from repro_torch.sync.policies import (
    tas_chip_barrier,
    zero_opt_state_specs,
    zero_shape_gradients,
)

__all__ = [
    "TREE",
    "TREE4",
    "TREE_EW",
    "TreeBarrierState",
    "make_tree_policy",
    "tree_barrier",
    "tree_chip_barrier",
]

# TCDM layout: one arrival flag word per core + one release word, all in
# distinct words (distinct banks under word interleaving), above the
# central-barrier variables of core/scu/primitives.py.
A_TREE_RELEASE = 0x1F0
A_TREE_FLAG_BASE = 0x200


def _flag_addr(cid: int) -> int:
    return A_TREE_FLAG_BASE + 4 * cid


class TreeBarrierState:
    """Per-run tournament-barrier bookkeeping (local sense per core)."""

    def __init__(self, n_cores: int, radix: int = 2):
        if radix < 2:
            raise ValueError(f"tree barrier radix must be >= 2, got {radix}")
        self.n_cores = n_cores
        self.radix = radix
        self.local_sense = [0] * n_cores


def tree_barrier(
    cl, cid: int, st: TreeBarrierState, cm=DEFAULT_COSTS, idle_wait: bool = False
):
    """Software radix-k tournament barrier: log_k-depth combining, sense
    reversal.

    Each core loses at exactly one level (the first where its base-``radix``
    digit is non-zero), so a single flag word per core suffices; flags carry
    the sense value, which makes the barrier reusable back-to-back without
    resets.  ``radix=2`` reproduces the classic binary tournament op-for-op.

    ``idle_wait`` selects the release broadcast: the default spins on the
    shared release word; the idle-wait variant instead clock-gates every
    loser on an SCU notifier event and the champion releases the whole
    group with one targeted notifier trigger -- the release-word bank
    traffic disappears and losers sleep instead of polling (the tree
    analogue of the paper's TAS idle-wait discipline).  Safe back-to-back:
    each loser's wake consumes only its own buffered event bit, and the
    champion cannot re-trigger before every loser has re-published its
    next-round arrival flag (the elw is on each loser's critical path).
    """
    n = st.n_cores
    radix = st.radix
    sense = st.local_sense[cid] ^ 1
    st.local_sense[cid] = sense
    yield Compute(cm.call + cm.sense_setup)
    stride = 1
    is_champion = True
    while stride < n:
        if (cid // stride) % radix:
            # loser at this level: publish the subtree's arrival, then wait
            # for the champion's release broadcast
            yield Compute(1)  # flag address computation
            yield Mem("sw", _flag_addr(cid), sense)
            is_champion = False
            break
        # block representative: wait for every partner subtree in the block
        for m in range(1, radix):
            partner = cid + m * stride
            if partner >= n:
                break
            yield Poll(
                "lw", _flag_addr(partner), until=sense,
                hit_cycles=1 + cm.load_use,
                miss_cycles=1 + cm.load_use + cm.branch_taken,
                hit_instr=1, miss_instr=2,
            )
        stride *= radix
    if is_champion:
        if idle_wait:
            # one targeted notifier trigger wakes every loser (core 0 is
            # excluded: its own stale event bit would leak into the next
            # barrier's elw)
            yield Scu("write", ("notifier", 0, "trigger"), ((1 << n) - 1) & ~1)
        else:
            # core 0 saw every subtree arrive: flip the shared release word
            yield Mem("sw", A_TREE_RELEASE, sense)
    elif idle_wait:
        # clock-gated wait for the champion's notifier broadcast
        yield Compute(cm.mask_setup)
        yield Scu("elw", ("notifier", 0, "wait"))
    else:
        yield Poll(
            "lw", A_TREE_RELEASE, until=sense,
            hit_cycles=1 + cm.load_use,
            miss_cycles=1 + cm.load_use + cm.branch_taken,
            hit_instr=1, miss_instr=2,
        )
    yield Compute(cm.ret)


def _tree_sim_mutex(cluster, cid, t_crit, state, cost_model=None):
    # The tree discipline restructures *barriers*; critical sections keep the
    # plain spin-lock (a combining tree has no analogue for mutexes).
    yield from sw_mutex_section(cluster, cid, t_crit, cost_model or DEFAULT_COSTS)


def make_tree_policy(
    radix: int = 2, name: Optional[str] = None, idle_wait: bool = False
) -> PolicyDef:
    """Build a tournament-barrier policy with the given ``radix``.

    ``radix=2`` is the registered builtin ``tree``; higher radices trade
    per-level fan-in for depth (``ceil(log_radix n)`` levels -- radix 4
    halves the depth on 16-core clusters).  ``idle_wait=True`` replaces the
    release-word spin with a clock-gated SCU-notifier wait (the builtin
    ``tree_ew``).  The returned policy is not registered; call
    :func:`repro_torch.sync.register_policy` to add e.g. a ``tree4`` row to every
    benchmark.
    """
    name = name or ("tree" if radix == 2 else f"tree{radix}")

    def _state(n_cores: int) -> TreeBarrierState:
        return TreeBarrierState(n_cores, radix=radix)

    def _sim_barrier(cluster, cid, state, cost_model=None):
        yield from tree_barrier(
            cluster, cid, state, cost_model or DEFAULT_COSTS, idle_wait=idle_wait
        )

    release = "SCU-notifier idle-wait release" if idle_wait else "release-word spin"
    return PolicyDef(
        name=name,
        description=(
            f"log-depth hierarchical barrier (MemPool-style), radix {radix}, "
            f"{release}: simulator tournament tree, chip-level butterfly "
            "exchange, training: hierarchical bucketed reduce-scatter "
            "(numerically identical to scu)"
        ),
        aliases=(name.upper(),),
        make_sim_state=_state,
        sim_barrier=_sim_barrier,
        sim_mutex=_tree_sim_mutex,
        # the chip-level exchange stays the radix-2 butterfly: the radix only
        # shapes the simulator tree
        chip_barrier=tree_chip_barrier,
        shape_gradients=zero_shape_gradients,
        opt_state_specs=zero_opt_state_specs,
        # the tournament's control flow is fixed by (cid, n, radix): every
        # poll/elw wait is a linear wait on a statically-known address, so
        # per-core sentinel tracing is sound (the mutex is sw_mutex_section,
        # also value-independent)
        trace_safe_barrier=True,
        trace_safe_mutex=True,
    )


def tree_chip_barrier(arrive: torch.Tensor, axis) -> torch.Tensor:
    """Butterfly exchange: log2(n) pairwise rounds, partner = idx XOR 2**k.

    At round k every party holds the sum of its 2**k-aligned block; the XOR
    partner holds the disjoint sibling block, so adding the exchanged value
    is exact -- the count derives entirely from the exchanged values.
    """
    n = axis_size(arrive, axis)
    if n & (n - 1):
        # butterfly pairing needs a power-of-two group; dissemination is the
        # log-depth exchange that stays exact for any group size
        return tas_chip_barrier(arrive, axis)
    total = arrive
    shift = 1
    while shift < n:
        perm = [(i, i ^ shift) for i in range(n)]
        total = total + ppermute(total, axis, perm)
        shift *= 2
    return total


TREE = register_policy(make_tree_policy(radix=2, name="tree"))
# Radix-4 tournament: half the tree depth on 16-core clusters, registered as
# a builtin so every benchmark (Table 1, Fig. 5, scaling sweeps, Table 2,
# chip-level, chain) carries a dedicated ``tree4`` row.
TREE4 = register_policy(make_tree_policy(radix=4))
# Idle-wait release variant: losers clock-gate on an SCU notifier event
# instead of spinning on the release word -- the release broadcast costs one
# targeted trigger and zero TCDM polls.
TREE_EW = register_policy(make_tree_policy(radix=2, name="tree_ew", idle_wait=True))
