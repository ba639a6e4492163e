"""The ``repro_torch.sync`` policy API: one registry for synchronization disciplines.

Copy of ``repro/sync/api.py`` with the same protocol, validation and error
texts.  The registry is this package's own: registering a policy here does
not touch ``repro``'s, and the other way round.

The paper compares one synchronization *semantics* under several
*implementations* (Sec. 6.1: SW spin-lock, TAS idle-wait, hardware SCU), and
the repo exercises that comparison at three layers:

  (a) the cycle-accurate cluster simulator -- barrier / mutex generator
      *fragments* made of ``Compute``/``Mem``/``Poll``/``Scu`` ops
      (``repro_torch.core.scu``),
  (b) chip-level barriers -- over parties stacked on the leading axis of a
      tensor on one device, or one party a process of a ``torch.distributed``
      group (``repro_torch.sync.axis``); the ``scu`` policy's barrier is the
      CUDA kernel K3 on stacked parties on a card, an ``all_reduce`` over
      processes,
  (c) the training schedule -- how gradients are synchronized and how the
      optimizer state is sharded.

A :class:`SyncPolicy` carries all three layers for one discipline, so a new
discipline is registered *once* and is benchmarkable everywhere.

Layer hook signatures (see :class:`SyncPolicy`):

  * ``make_sim_state(n_cores)``            -> per-run shared simulator state
  * ``sim_barrier(cluster, cid, state, cost_model)``      -> op generator
  * ``sim_mutex(cluster, cid, t_crit, state, cost_model)`` -> op generator
  * ``chip_barrier(arrive, axis)``         -> arrival count, shaped as ``arrive``
  * ``shape_gradients(grads, params_shape, mesh, cfg)``   -> shaped grads
  * ``opt_state_specs(params_shape, mesh, cfg)``          -> spec dict

All disciplines must be *numerically identical* (same released count, same
update); they may only differ in schedule / collective structure -- exactly
like the paper's variants.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Protocol, Tuple, runtime_checkable

__all__ = [
    "SyncPolicy",
    "PolicyDef",
    "LAYER_HOOKS",
    "register_policy",
    "unregister_policy",
    "get_policy",
    "available_policies",
    "canonical_name",
]

# Every registered policy must provide all of these (cross-layer parity).
LAYER_HOOKS: Tuple[str, ...] = (
    "make_sim_state",
    "sim_barrier",
    "sim_mutex",
    "chip_barrier",
    "shape_gradients",
    "opt_state_specs",
)


@runtime_checkable
class SyncPolicy(Protocol):
    """Structural type of a synchronization policy (see module docstring)."""

    name: str
    description: str

    def make_sim_state(self, n_cores: int) -> Any: ...

    def sim_barrier(self, cluster, cid: int, state, cost_model=None): ...

    def sim_mutex(self, cluster, cid: int, t_crit: int, state, cost_model=None): ...

    def chip_barrier(self, arrive, axis): ...

    def shape_gradients(self, grads, params_shape, mesh, cfg=None): ...

    def opt_state_specs(self, params_shape, mesh, cfg=None): ...


@dataclasses.dataclass(frozen=True)
class PolicyDef:
    """Concrete :class:`SyncPolicy`: one record, all three layers.

    The hooks are plain callables (not bound methods), so their signatures
    are exactly the layer-hook signatures above without ``self``.
    """

    name: str
    description: str
    make_sim_state: Callable[[int], Any]
    sim_barrier: Callable[..., Any]
    sim_mutex: Callable[..., Any]
    chip_barrier: Callable[..., Any]
    shape_gradients: Callable[..., Any]
    opt_state_specs: Callable[..., Any]
    aliases: Tuple[str, ...] = ()  # e.g. the legacy simulator spelling "SCU"
    # Optional simulator hook: native pipelined-chain support.  Signature
    # ``(n_cores, work, state, cost_model, depth) -> List[Program]`` where
    # ``work[item][stage]`` is the Compute-cycle cost of ``item`` at stage
    # ``stage`` (one stage per core).  Policies without it fall back to the
    # barrier-synchronous pipeline emulation in ``core/scu/programs.py`` --
    # the baseline the paper's FIFO extension exists to beat.
    make_pipeline_programs: Optional[Callable[..., Any]] = None
    # Optional simulator hook: native multi-producer work-queue support.
    # Signature ``(n_producers, n_consumers, items, t_produce, t_consume,
    # state, cost_model) -> List[Program]`` (producers first, then
    # consumers).  Policies without it fall back to the mutex-protected
    # shared-queue emulation in ``core/scu/programs.py``.
    make_work_queue_programs: Optional[Callable[..., Any]] = None
    # --- compiled-trace lowering hooks (repro.core.scu.trace) -------------
    # ``trace_barrier(tb, cluster, cid, state, cost_model)`` /
    # ``trace_mutex(tb, cluster, cid, t_crit, state, cost_model)`` emit ONE
    # iteration of the primitive as static trace rows into a
    # ``TraceBuilder`` -- needed when the generator's op stream depends on
    # runtime values (the sense-reversal count check, the TAS re-test), so
    # the value-dependent control flow must be expressed as explicit BR/JMP
    # rows.  ``trace_safe_barrier``/``trace_safe_mutex`` declare the
    # generator fragment free of *cross-core-order-dependent shared Python
    # state*, which makes per-core sentinel tracing sound (value-dependence
    # is proven mechanically by the sentinel; order-dependence -- e.g. the
    # fifo mutex's seed-once token -- cannot be, hence the explicit flag).
    # With neither an emitter nor a safety flag, lowering falls back to the
    # generator path: always correct, never collapsed.
    trace_barrier: Optional[Callable[..., Any]] = None
    trace_mutex: Optional[Callable[..., Any]] = None
    trace_safe_barrier: bool = False
    trace_safe_mutex: bool = False


# name (and alias) -> policy, in registration order (order is meaningful:
# benchmarks print columns in it, with the paper's triad first).
_REGISTRY: Dict[str, SyncPolicy] = {}
_ALIASES: Dict[str, str] = {}


def register_policy(policy: SyncPolicy, *, overwrite: bool = False) -> SyncPolicy:
    """Register ``policy`` under its (case-insensitive) name and aliases.

    Validates cross-layer completeness at registration time: a policy missing
    any layer hook would otherwise fail deep inside a benchmark or a train
    step, far from the actual mistake.
    """
    missing = [
        h for h in LAYER_HOOKS
        if not callable(getattr(policy, h, None))
    ]
    if missing:
        raise TypeError(
            f"policy {getattr(policy, 'name', policy)!r} does not implement "
            f"the full SyncPolicy protocol; missing/uncallable hooks: {missing}"
        )
    name = policy.name.lower()
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"sync policy {name!r} is already registered")
    aliases = tuple(a.lower() for a in getattr(policy, "aliases", ()) or ())
    for alias in aliases:
        # an alias may never capture another policy's name or alias --
        # resolution would silently hijack every existing call site
        if alias != name and (
            alias in _REGISTRY or _ALIASES.get(alias, name) != name
        ):
            raise ValueError(
                f"alias {alias!r} of policy {name!r} collides with an "
                f"already-registered policy name or alias"
            )
    if overwrite:
        for alias, target in list(_ALIASES.items()):
            if target == name:  # drop the replaced policy's stale aliases
                del _ALIASES[alias]
    _REGISTRY[name] = policy
    for alias in aliases:
        _ALIASES[alias] = name
    return policy


def unregister_policy(name: str) -> None:
    """Remove a policy and its aliases.

    Restoration is the caller's responsibility: ``repro_torch.sync`` stays cached
    in ``sys.modules``, so the builtin registrations do NOT re-run -- hold on
    to the policy object and ``register_policy`` it back (see
    ``tests/test_torch_sync_api.py`` for the try/finally pattern).
    """
    cname = canonical_name(name)
    del _REGISTRY[cname]
    for alias, target in list(_ALIASES.items()):
        if target == cname:
            del _ALIASES[alias]


def canonical_name(name: str) -> str:
    """Resolve ``name`` (any case, alias allowed) to the registered name.

    Registered names take precedence over aliases, so an alias can never
    shadow a policy's own name.
    """
    key = str(name).lower()
    if key not in _REGISTRY:
        key = _ALIASES.get(key, key)
    if key not in _REGISTRY:
        raise KeyError(
            f"unknown sync policy {name!r}; available policies: "
            f"{', '.join(available_policies())}"
        )
    return key


def get_policy(name: str) -> SyncPolicy:
    """Resolve a policy by name (case-insensitive, legacy aliases accepted)."""
    return _REGISTRY[canonical_name(name)]


def available_policies() -> Tuple[str, ...]:
    """Registered policy names, in registration order (paper triad first)."""
    return tuple(_REGISTRY)
