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

The chip-level barriers take their parties on an axis of
``repro_torch.sync.axis``: stacked on the leading axis of one tensor
(``arrive`` is ``(n, *s)`` and so is the released count), or one party a
process over a ``MeshAxis`` of a ``DeviceMesh`` (``arrive`` is the party's
own value, as under ``shard_map``, and the ``scu`` event is one
``all_reduce``).  They *derive the count from the exchanged values* -- the
oracle lives only in tests (``ref_barrier_count``).  All disciplines are
numerically identical; they differ in schedule only.

Layer (c): the reference shapes the gradients' collectives with sharding
constraints and ``optimization_barrier`` chains, which XLA schedules.  On one
device (a mesh given as an ``{axis: size}`` mapping) there are no collectives
to schedule, so each hook returns a new tree with the same leaves in the same
order, bit-identical.  Over a ``DeviceMesh`` (one process a device) the hooks
run the gradient collectives of the data axes themselves, each policy in its
own schedule, and return the mean over the data processes (an
``all_reduce`` writes into the gradient it is handed, as the step hands
over gradients it no longer needs):

  * ``scu`` (and ``tree``, ``tree4``, ``tree_ew``): every leaf's
    ``reduce_scatter`` onto its ZeRO block is issued at once and waited at the
    end (fine grain, no barriers); a leaf with no axis the data processes
    divide takes an ``all_reduce``;
  * ``fifo``: the same, in four stages handed off in leaf order;
  * ``tas``: one coarse ``all_reduce`` of every gradient flattened into one
    buffer (one a dtype);
  * ``sw``: one ``all_reduce`` a tensor in leaf order, each waited before the
    next.

The optimizer-state specs are the reference's, from
``repro_torch.parallel.sharding``; ``step_opt_state_specs`` gives the
placement the port's train step applies.  Over ``model`` a gradient is this
process's block by the parameter specs, whole where the specs keep a leaf
whole (made so by the forward's collectives over ``model``), and the
hooks' collectives run over the data axes alone, within one model
coordinate: each data-axis group of the ``DeviceMesh`` is the processes of
one model block.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional

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
from repro_torch.parallel import dist as pdist
from repro_torch.parallel.sharding import (
    axis_sizes,
    dp_axes,
    entry_axes,
    is_spec,
    param_specs,
    tree_map_with_path,
    zero_spec,
)
from repro_torch.sync.api import PolicyDef, register_policy
from repro_torch.sync.axis import axis_index, axis_size, is_stacked, ppermute, psum

__all__ = ["SCU", "TAS", "SW", "step_opt_state_specs"]


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
# Layer (b): chip-level barriers over a party axis (stacked, or one a process)
# ---------------------------------------------------------------------------


def scu_chip_barrier(arrive: torch.Tensor, axis) -> torch.Tensor:
    """One fused synchronization event: the SCU barrier kernel (K3) on stacked
    parties on a card; over a process axis, one ``all_reduce``."""
    if is_stacked(axis):
        axis_size(arrive, axis)  # checks the axis
        return scu_ops.barrier(arrive)
    return psum(arrive, axis)


def contribution_vector(arrive: torch.Tensor, axis) -> torch.Tensor:
    """Per-party one-hot contribution slots for exchange-based barriers.

    Slot ``j`` holds party ``j``'s arrival word (or 0 until it is heard
    from); combining two vectors with ``maximum`` is a union because each
    slot only ever carries one party's non-negative arrival count.  Stacked,
    party ``i``'s vector is row ``i`` of the result, ``(n, n, *s)``; over a
    process axis, the party's own ``(n, *s)`` vector.
    """
    n = axis_size(arrive, axis)
    vec = torch.zeros((n,) + tuple(arrive.shape), dtype=arrive.dtype, device=arrive.device)
    if is_stacked(axis):
        idx = torch.arange(n, device=arrive.device)
        vec[idx, idx] = arrive
    else:
        vec[int(axis_index(arrive, axis))] = arrive
    return vec


def tas_chip_barrier(arrive: torch.Tensor, axis) -> torch.Tensor:
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
    return vec.sum(dim=1 if is_stacked(axis) else 0)


def sw_chip_barrier(arrive: torch.Tensor, axis) -> torch.Tensor:
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


def _no_collectives(mesh) -> bool:
    """A mesh given as its ``{axis: size}`` mapping (one device), or one with
    no data axes: no gradient collectives."""
    return isinstance(mesh, Mapping) or not dp_axes(mesh)


def _dp(mesh):
    """The data axes of ``mesh`` and the number of processes over them."""
    dp = dp_axes(mesh)
    return dp, math.prod(axis_sizes(mesh)[a] for a in dp)


def _zero_specs(params_shape: Any, mesh, cfg=None) -> Any:
    """ZeRO shard specs over the data axes for every parameter."""
    mesh = axis_sizes(mesh)
    specs = param_specs(params_shape, mesh, cfg=cfg)
    return tree_map_with_path(
        lambda path, s, p: zero_spec(s, tuple(p.shape), mesh), specs, params_shape, is_leaf=is_spec
    )


def _zero_dim(spec, dp) -> Optional[int]:
    """The dimension a ZeRO spec splits over the data axes, or None."""
    for d, entry in enumerate(spec):
        if entry_axes(entry) and set(entry_axes(entry)) <= set(dp):
            return d
    return None


def _leaves_in_order(tree, is_leaf=None) -> list:
    """``(path, leaf)`` of a tree in the reference's leaf order (dict keys
    sorted at every level): the order every process issues its collectives in."""
    out = []
    tree_map_with_path(lambda path, leaf: out.append((path, leaf)), tree, is_leaf=is_leaf)
    return sorted(out, key=lambda item: item[0])


def _zero_reduce(grads, params_shape, mesh, cfg, stages: int):
    """Every leaf's mean over the data processes, on its ZeRO block: a
    ``reduce_scatter`` along the dimension its ZeRO spec splits, or an
    ``all_reduce`` where no dimension is split.  The leaves' collectives are
    issued in ``stages`` groups of leaf order, each group in flight together
    and waited before the next."""
    dp, n = _dp(mesh)
    zspecs = dict(_leaves_in_order(_zero_specs(params_shape, mesh, cfg=cfg), is_leaf=is_spec))
    leaves = _leaves_in_order(grads)
    size = -(-len(leaves) // max(1, min(stages, len(leaves))))
    done = {}
    for start in range(0, len(leaves), size):
        pending = []
        for path, g in leaves[start:start + size]:
            k = _zero_dim(zspecs[path], dp)
            if k is None:
                pending.append((path, pdist.all_reduce(g.contiguous(), mesh, dp, async_op=True)))
            else:
                pending.append((path, pdist.reduce_scatter(g, k, mesh, dp, async_op=True)))
        for path, work in pending:
            done[path] = work.wait().div_(n)
    return tree_map_with_path(lambda path, g: done[path], grads)


def sw_shape_gradients(grads, params_shape, mesh, cfg=None):
    """Per-tensor serialized sync: one collective per tensor, program order.
    On one device: the same leaves, bit-identical (see the module note)."""
    if _no_collectives(mesh):
        return _same_leaves(grads)
    dp, n = _dp(mesh)
    done = {}
    for path, g in _leaves_in_order(grads):  # each all_reduce returns before the next is issued
        done[path] = pdist.all_reduce(g.contiguous(), mesh, dp).div_(n)
    return tree_map_with_path(lambda path, g: done[path], grads)


def tas_shape_gradients(grads, params_shape, mesh, cfg=None):
    """Single coarse sync point between backward and optimizer.
    On one device: the same leaves, bit-identical (see the module note)."""
    if _no_collectives(mesh):
        return _same_leaves(grads)
    dp, n = _dp(mesh)
    leaves = _leaves_in_order(grads)
    done = {}
    for dtype in dict.fromkeys(g.dtype for _, g in leaves):
        group = [(path, g) for path, g in leaves if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for _, g in group])
        pdist.all_reduce(flat, mesh, dp).div_(n)
        for (path, g), piece in zip(group, flat.split([g.numel() for _, g in group])):
            done[path] = piece.view(g.shape)
    return tree_map_with_path(lambda path, g: done[path], grads)


def zero_shape_gradients(grads, params_shape, mesh, cfg=None):
    """Fine-grain reduce-scatter onto the ZeRO shards; no barriers.
    On one device: the same leaves, bit-identical (see the module note)."""
    if _no_collectives(mesh):
        return _same_leaves(grads)
    return _zero_reduce(grads, params_shape, mesh, cfg, stages=1)


def replicated_opt_state_specs(params_shape, mesh, cfg=None):
    """Baselines keep master/m/v sharded like the params (replicated over
    data) -- the paper's 'every contestant keeps its own copy spinning'."""
    specs = param_specs(params_shape, axis_sizes(mesh), cfg=cfg)
    return {"master": specs, "m": specs, "v": specs}


def zero_opt_state_specs(params_shape, mesh, cfg=None):
    """ZeRO-shard the optimizer state over the data axes (shard-parallel
    'critical section': the optimizer update)."""
    specs = _zero_specs(params_shape, mesh, cfg=cfg)
    return {"master": specs, "m": specs, "v": specs}


def step_opt_state_specs(policy, params_shape, mesh, cfg=None):
    """The optimizer-state specs the port's train step applies.

    The policy's own ``opt_state_specs``, except for the baselines'
    ``replicated_opt_state_specs``: there the reference's specs are
    ``param_specs``, whose default FSDP rule splits every weight over the
    data axes too, while its docstring (and the paper's baseline) keeps every
    data process's own copy.  The port's step holds the parameters whole over
    the data axes (its forward reads whole weights), so the baselines' state
    is placed as the parameters are: ``param_specs(..., fsdp=False)``, each
    process's block over ``model``, whole on every data process.  The ZeRO
    policies' state is split over ``model`` the same way, with the ZeRO
    split over the data axes on top.
    """
    if policy.opt_state_specs is replicated_opt_state_specs:
        specs = param_specs(params_shape, axis_sizes(mesh), fsdp=False, cfg=cfg)
        return {"master": specs, "m": specs, "v": specs}
    return policy.opt_state_specs(params_shape, axis_sizes(mesh), cfg)


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
