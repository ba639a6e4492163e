"""The paper's three builtin disciplines as :class:`~repro_torch.sync.api.PolicyDef`s.

Counterpart of ``repro/sync/policies.py``.  Each policy bundles the three
layer implementations:

  * ``sw``  -- pure software spin-locks (Sec. 6.1, "purely spin-lock based").
    Chip level: serialized ring accumulation, one contender per turn.
    Training: per-tensor chain (one collective per parameter tensor,
    strictly in order).
  * ``tas`` -- software + idle-waiting on SCU notifier events.
    Chip level: log-n dissemination rounds over the shared status word.
    Training: a single coarse synchronization point after backward.
  * ``scu`` -- the paper's hardware primitives (single-``elw`` barrier).
    Chip level: one fused synchronization event -- on a card, the CUDA kernel
    K3 (``repro_torch.kernels.scu_barrier``), a dissemination barrier among
    CTAs; on the CPU its plain version.
    Training: fine-grain bucketed reduce-scatter onto ZeRO shards.

The chip-level barriers run over parties stacked on the leading axis of one
tensor (``repro_torch.sync.axis``): ``arrive`` is ``(n, *s)`` and so is the
released count.  They *derive the count from the exchanged values* -- the
oracle lives only in tests (``ref_barrier_count``).  All disciplines are
numerically identical; they differ in schedule only.

Layer (c) on one device: the reference shapes the gradients' collectives
with sharding constraints and ``optimization_barrier`` chains, which XLA
schedules.  Eager PyTorch on one device has no collectives to schedule, so
each hook returns a new tree with the same leaves in the same order,
bit-identical; the schedule structure (chain, one sync point, four stages)
waits for a ``torch.distributed`` backend.  The optimizer-state specs are the
reference's, from ``repro_torch.parallel.sharding``.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.scu.primitives import (
    DEFAULT_COSTS,
    BarrierState,
    scu_barrier,
    scu_mutex_section,
    sw_barrier,
    sw_mutex_section,
    tas_barrier,
    tas_mutex_section,
    trace_sw_barrier_body,
    trace_tas_mutex_section,
)
from repro_torch.kernels.scu_barrier import ops as scu_ops
from repro_torch.parallel.sharding import is_spec, param_specs, tree_map_with_path, zero_spec
from repro_torch.sync.api import PolicyDef, register_policy
from repro_torch.sync.axis import axis_size, ppermute

__all__ = ["SCU", "TAS", "SW"]


# ---------------------------------------------------------------------------
# Layer (a): simulator fragments -- thin adapters over core/scu/primitives
# ---------------------------------------------------------------------------


def _no_sim_state(n_cores: int) -> None:
    """The hardware SCU keeps all barrier state in the unit itself."""
    return None


def _scu_sim_barrier(cluster, cid, state, cost_model=None):
    yield from scu_barrier(cluster, cid)


def _scu_sim_mutex(cluster, cid, t_crit, state, cost_model=None):
    yield from scu_mutex_section(cluster, cid, t_crit)


def _sw_sim_barrier(cluster, cid, state, cost_model=None):
    yield from sw_barrier(cluster, cid, state, cost_model or DEFAULT_COSTS)


def _sw_sim_mutex(cluster, cid, t_crit, state, cost_model=None):
    yield from sw_mutex_section(cluster, cid, t_crit, cost_model or DEFAULT_COSTS)


def _tas_sim_barrier(cluster, cid, state, cost_model=None):
    yield from tas_barrier(cluster, cid, state, cost_model or DEFAULT_COSTS)


def _tas_sim_mutex(cluster, cid, t_crit, state, cost_model=None):
    yield from tas_mutex_section(cluster, cid, t_crit, cost_model or DEFAULT_COSTS)


# Trace-IR lowerings.  The sw/tas barriers and the tas mutex branch on
# *observed* TCDM values (arrival count, lock word), so sentinel tracing
# cannot linearize them -- they get explicit emitters that encode the
# branches as BR rows.  The sw mutex and both scu fragments are
# value-independent, so per-core sentinel tracing is declared safe instead.


def _sw_trace_barrier(tb, cluster, cid, state, cost_model=None):
    trace_sw_barrier_body(tb, cid, state, cost_model or DEFAULT_COSTS, idle_wait=False)


def _tas_trace_barrier(tb, cluster, cid, state, cost_model=None):
    trace_sw_barrier_body(tb, cid, state, cost_model or DEFAULT_COSTS, idle_wait=True)


def _tas_trace_mutex(tb, cluster, cid, t_crit, state, cost_model=None):
    trace_tas_mutex_section(tb, cid, t_crit, cost_model or DEFAULT_COSTS)


# ---------------------------------------------------------------------------
# Layer (b): chip-level barriers over the stacked party axis
# ---------------------------------------------------------------------------


def scu_chip_barrier(arrive: torch.Tensor, axis: str) -> torch.Tensor:
    """One fused synchronization event: the SCU barrier kernel (K3) on a card."""
    axis_size(arrive, axis)  # checks the axis
    return scu_ops.barrier(arrive)


def contribution_vector(arrive: torch.Tensor, axis: str) -> torch.Tensor:
    """Per-party one-hot contribution slots for exchange-based barriers.

    Party ``i``'s vector is row ``i`` of the result, ``(n, n, *s)``: slot
    ``j`` holds party ``j``'s arrival word (or 0 until it is heard from);
    combining two vectors with ``maximum`` is a union because each slot only
    ever carries one party's non-negative arrival count.
    """
    n = axis_size(arrive, axis)
    vec = torch.zeros((n,) + tuple(arrive.shape), dtype=arrive.dtype, device=arrive.device)
    idx = torch.arange(n, device=arrive.device)
    vec[idx, idx] = arrive
    return vec


def tas_chip_barrier(arrive: torch.Tensor, axis: str) -> torch.Tensor:
    """Log-n dissemination rounds on the shared status word.

    Round k: every party forwards what it has heard so far to the party
    ``2**k`` ahead (mod n).  After ceil(log2 n) rounds every party has heard
    from everyone (windows are contiguous and grow as min(2**k, n)), so the
    released count is the sum of the exchanged contributions -- exact for any
    group size, with no oracle correction.
    """
    n = axis_size(arrive, axis)
    vec = contribution_vector(arrive, axis)
    shift = 1
    while shift < n:
        perm = [(i, (i + shift) % n) for i in range(n)]
        incoming = ppermute(vec, axis, perm)
        vec = torch.maximum(vec, incoming)
        shift *= 2
    return vec.sum(dim=1)


def sw_chip_barrier(arrive: torch.Tensor, axis: str) -> torch.Tensor:
    """n-1 serialized ring turns: each contestant's word circulates in order.

    The turns are a dependency chain, like the spin-lock's serialized acquire
    order (the reference's optimization barrier, which only kept XLA from
    fusing them, has no eager counterpart).  The count is the sum of every
    token received, exact for any group size.
    """
    n = axis_size(arrive, axis)
    perm = [(i, (i + 1) % n) for i in range(n)]
    total = arrive
    token = arrive
    for _ in range(n - 1):
        token = ppermute(token, axis, perm)
        total = total + token
    return total


# ---------------------------------------------------------------------------
# Layer (c): training-schedule hooks
# ---------------------------------------------------------------------------


def _same_leaves(tree: Any) -> Any:
    """A new tree of the same structure holding the same leaves, untouched."""
    return tree_map_with_path(lambda path, leaf: leaf, tree)


def _zero_specs(params_shape: Any, mesh, cfg=None) -> Any:
    """ZeRO shard specs over the data axes for every parameter."""
    specs = param_specs(params_shape, mesh, cfg=cfg)
    return tree_map_with_path(
        lambda path, s, p: zero_spec(s, tuple(p.shape), mesh), specs, params_shape, is_leaf=is_spec
    )


def sw_shape_gradients(grads, params_shape, mesh, cfg=None):
    """Per-tensor serialized sync: one collective per tensor, program order.
    On one device: the same leaves, bit-identical (see the module note)."""
    return _same_leaves(grads)


def tas_shape_gradients(grads, params_shape, mesh, cfg=None):
    """Single coarse sync point between backward and optimizer.
    On one device: the same leaves, bit-identical (see the module note)."""
    return _same_leaves(grads)


def zero_shape_gradients(grads, params_shape, mesh, cfg=None):
    """Fine-grain reduce-scatter onto the ZeRO shards; no barriers.
    On one device: the same leaves, bit-identical (see the module note)."""
    return _same_leaves(grads)


def replicated_opt_state_specs(params_shape, mesh, cfg=None):
    """Baselines keep master/m/v sharded like the params (replicated over
    data) -- the paper's 'every contestant keeps its own copy spinning'."""
    specs = param_specs(params_shape, mesh, cfg=cfg)
    return {"master": specs, "m": specs, "v": specs}


def zero_opt_state_specs(params_shape, mesh, cfg=None):
    """ZeRO-shard the optimizer state over the data axes (shard-parallel
    'critical section': the optimizer update)."""
    specs = _zero_specs(params_shape, mesh, cfg=cfg)
    return {"master": specs, "m": specs, "v": specs}


# ---------------------------------------------------------------------------
# The builtin policies
# ---------------------------------------------------------------------------

SCU = register_policy(PolicyDef(
    name="scu",
    description=(
        "hardware SCU primitives: single-elw barrier/mutex; chip: one fused "
        "synchronization event (the SCU barrier kernel); training: fine-grain "
        "ZeRO reduce-scatter, no barriers"
    ),
    aliases=("SCU",),
    make_sim_state=_no_sim_state,
    sim_barrier=_scu_sim_barrier,
    sim_mutex=_scu_sim_mutex,
    chip_barrier=scu_chip_barrier,
    shape_gradients=zero_shape_gradients,
    opt_state_specs=zero_opt_state_specs,
    trace_safe_barrier=True,
    trace_safe_mutex=True,
))

TAS = register_policy(PolicyDef(
    name="tas",
    description=(
        "TAS spin + SCU-notifier idle-wait; chip: log-n dissemination rounds; "
        "training: one coarse sync point after backward"
    ),
    aliases=("TAS",),
    make_sim_state=BarrierState,
    sim_barrier=_tas_sim_barrier,
    sim_mutex=_tas_sim_mutex,
    chip_barrier=tas_chip_barrier,
    shape_gradients=tas_shape_gradients,
    opt_state_specs=replicated_opt_state_specs,
    trace_barrier=_tas_trace_barrier,
    trace_mutex=_tas_trace_mutex,
))

SW = register_policy(PolicyDef(
    name="sw",
    description=(
        "pure software spin-locks; chip: n serialized ring turns; training: "
        "per-tensor serialized chain"
    ),
    aliases=("SW",),
    make_sim_state=BarrierState,
    sim_barrier=_sw_sim_barrier,
    sim_mutex=_sw_sim_mutex,
    chip_barrier=sw_chip_barrier,
    shape_gradients=sw_shape_gradients,
    opt_state_specs=replicated_opt_state_specs,
    trace_barrier=_sw_trace_barrier,
    trace_safe_mutex=True,
))
