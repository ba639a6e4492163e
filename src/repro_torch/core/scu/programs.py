"""The paper's Sec. 6.3 microbenchmarks, lowered to static traces.

Own copy of the lowering half of ``repro/core/scu/programs.py``: the emit and
fragment paths of ``_lower_loop_programs``, and the ``compiled=True``
branches of ``prep_barrier_bench``, ``prep_mutex_bench`` and (its
barrier-synchronous pipeline) ``prep_chain_bench`` as
:func:`trace_barrier_programs`, :func:`trace_mutex_programs` and
:func:`trace_chain_programs`.  Each core loops over iterations of
``Compute`` cycles and the primitive; the result is the per-core
:class:`~repro_torch.core.scu.trace.TraceProgram` list that
``trace_exec.run_traces_torch`` runs.  The policies come from the port's own
registry (``repro_torch.sync``).

The port has no ``Cluster`` (the engine stays in ``repro``).  The lowering
hands the policy hooks a stand-in that raises on any attribute read, so a
fragment that reads the cluster fails loudly instead of tracing wrongly.  No
builtin lowering reads it, but the ``fifo`` policy is refused outright: its
programs run on the SCU's event FIFOs (its pipeline programs read
``cluster.scu``), so its rows carry SCU ops, or fall back to generators for
its mutex, and neither runs without the engine.  Other policies whose rows
carry SCU ops (``scu``, ``tas``, ``tree_ew``) lower, and the executor refuses
them.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from .engine import Compute
from .primitives import DEFAULT_COSTS
from .trace import TraceBuilder, TraceProgram, lower_or_fallback

__all__ = ["trace_barrier_programs", "trace_chain_programs", "trace_mutex_programs"]


class _NoCluster:
    """Stands in for the engine's ``Cluster``, which the port does not carry."""

    __slots__ = ()

    def __getattr__(self, name):
        raise RuntimeError(
            f"a fragment read cluster.{name}, but the port's trace lowering has no Cluster: "
            "the engine stays in the JAX package, and only programs that need no cluster lower here"
        )


_NO_CLUSTER = _NoCluster()


def _lower_loop_programs(
    cl,
    n_cores: int,
    programs: Sequence[Callable],
    n_iters: int,
    emit_iter: Optional[Callable[[TraceBuilder, int, int], None]] = None,
    frag_iter: Optional[Callable] = None,
    label: str = "",
) -> List[TraceProgram]:
    """Lower per-core iteration-loop programs to :class:`TraceProgram`s.

    Strategy per core: the policy's explicit per-iteration trace emitter
    when it has one (``emit_iter``), marked per-iteration sentinel tracing
    when the policy declared its fragment trace-safe (``frag_iter``), else a
    declared generator fallback -- policies whose fragments depend on
    cross-core execution order (shared Python state the sentinel cannot
    observe) must never be sentinel-traced, so the absence of both hooks
    forces the fallback rather than attempting it.
    """
    out = []
    for cid in range(n_cores):
        program = programs[cid]
        if emit_iter is not None:

            def emit(tb, cid=cid):
                for it in range(n_iters):
                    tb.mark()
                    emit_iter(tb, cid, it)

            out.append(lower_or_fallback(program, cl, cid, emit=emit, label=f"{label}:{cid}"))
        elif frag_iter is not None:

            def frags(cid=cid):
                return [(lambda cid=cid, it=it: frag_iter(cid, it)) for it in range(n_iters)]

            out.append(lower_or_fallback(program, cl, cid, fragments=frags, label=f"{label}:{cid}"))
        else:
            out.append(TraceProgram(fallback=program, label=f"{label}:fb:{cid}"))
    return out


def _lowerable_policy(variant: str, chain: bool = False):
    from repro_torch.sync import canonical_name, get_policy  # deferred: repro_torch.sync imports this package

    policy = get_policy(variant)
    if canonical_name(variant) == "fifo" or (chain and policy.make_pipeline_programs is not None):
        raise ValueError(
            f"the {policy.name} policy does not lower to a trace here: its barrier, mutex and chain run on the "
            "SCU's event FIFOs (SCU rows, or generator fallbacks for the mutex), which only the engine in the "
            "JAX package simulates"
        )
    return policy


def _barrier_loop_programs(
    policy, n_cores: int, n_iters: int, work: Callable[[int, int], int], label: str
) -> List[TraceProgram]:
    """Per-core traces of ``n_iters`` x (``work(cid, it)`` Compute cycles, none
    when 0, + one barrier): the lowering that the barrier bench and the
    barrier-synchronous chain share."""
    cl = _NO_CLUSTER
    state = policy.make_sim_state(n_cores)
    cm = DEFAULT_COSTS

    def program(cluster, cid):
        for it in range(n_iters):
            w = work(cid, it)
            if w > 0:
                yield Compute(w)
            yield from policy.sim_barrier(cluster, cid, state, cm)

    emit_iter = frag_iter = None
    if policy.trace_barrier is not None:

        def emit_iter(tb, cid, it):
            w = work(cid, it)
            if w > 0:
                tb.compute(w)
            policy.trace_barrier(tb, cl, cid, state, cm)

    elif policy.trace_safe_barrier:

        def frag_iter(cid, it):
            w = work(cid, it)
            if w > 0:
                yield Compute(w)
            yield from policy.sim_barrier(cl, cid, state, cm)

    return _lower_loop_programs(cl, n_cores, [program] * n_cores, n_iters, emit_iter, frag_iter, label=label)


def trace_barrier_programs(variant: str, n_cores: int, sfr: int = 0, iters: int = 256) -> List[TraceProgram]:
    """Per-core traces of ``iters`` x (``sfr`` Compute cycles + one barrier).

    ``prep_barrier_bench(variant, n_cores, sfr, iters, compiled=True)``'s
    programs, row for row.
    """
    policy = _lowerable_policy(variant)
    return _barrier_loop_programs(policy, n_cores, iters, lambda cid, it: sfr, f"{variant}:barrier")


def trace_chain_programs(variant: str, n_cores: int, sfr: int = 100, iters: int = 32) -> List[TraceProgram]:
    """Per-core traces of the barrier-synchronous pipeline: ``iters`` items
    through ``n_cores`` stages of ``sfr`` Compute cycles each.

    At tick ``t`` core ``c`` computes item ``t - c`` when that item exists,
    then the whole cluster meets at a barrier; ``iters + n_cores - 1`` ticks.
    A core with no item in a tick (the pipeline filling or draining) emits no
    ``Compute`` row and only pays the barrier.  ``prep_chain_bench(variant,
    n_cores, sfr, iters, compiled=True)``'s programs, row for row, for a
    policy without a native pipeline; a policy with one (``fifo``) raises
    ``ValueError``.
    """
    policy = _lowerable_policy(variant, chain=True)

    def work(cid, tick):
        return sfr if 0 <= tick - cid < iters else 0

    return _barrier_loop_programs(policy, n_cores, iters + n_cores - 1, work, f"{variant}:chain")


def trace_mutex_programs(
    variant: str, n_cores: int, t_crit: int = 0, sfr: int = 0, iters: int = 256
) -> List[TraceProgram]:
    """Per-core traces of ``iters`` x (``sfr`` Compute cycles + one critical
    section of ``t_crit`` cycles).

    ``prep_mutex_bench(variant, n_cores, t_crit, sfr, iters, compiled=True)``'s
    programs, row for row.
    """
    policy = _lowerable_policy(variant)
    cl = _NO_CLUSTER
    state = policy.make_sim_state(n_cores)
    cm = DEFAULT_COSTS

    def program(cluster, cid):
        for _ in range(iters):
            if sfr > 0:
                yield Compute(sfr)
            yield from policy.sim_mutex(cluster, cid, t_crit, state, cm)

    emit_iter = frag_iter = None
    if policy.trace_mutex is not None:

        def emit_iter(tb, cid, it):
            if sfr > 0:
                tb.compute(sfr)
            policy.trace_mutex(tb, cl, cid, t_crit, state, cm)

    elif policy.trace_safe_mutex:

        def frag_iter(cid, it):
            if sfr > 0:
                yield Compute(sfr)
            yield from policy.sim_mutex(cl, cid, t_crit, state, cm)

    return _lower_loop_programs(
        cl, n_cores, [program] * n_cores, iters, emit_iter, frag_iter, label=f"{variant}:mutex"
    )
