"""The producer-consumer event-FIFO discipline (paper Sec. 4.3, SCU FIFO).

Counterpart of ``repro/sync/fifo.py``; the chip level runs over a party axis
of ``repro_torch.sync.axis`` (stacked, or one party a process).

The SCU's event FIFO exists precisely for the fine-grain producer-consumer
chains that pure barriers serve poorly: a producer pushes an 8-bit event the
moment a datum is ready and the consumer sleeps clock-gated until its pop is
matched -- no core spins, no core waits for unrelated peers.  MemPool
(Riedel et al., 2023) runs the same pattern at 256 cores, which is why the
scaling sweeps carry this policy to 16/32/64-core clusters.

Registered once as the ``fifo`` :class:`~repro_torch.sync.api.PolicyDef`, the
discipline shows up at every layer:

  * simulator -- producers ``Scu("write", ("fifo", i, "push"), v)``,
    consumers ``Scu("elw", ("fifo", i, "pop"))`` (clock-gated until the FIFO
    comparator matches an event to them).  The barrier is a gather/release
    over FIFOs (arrivals stream into core 0's gather queue; the release is
    one token into each consumer's private queue, so back-to-back barriers
    cannot steal each other's tokens); the mutex passes a single ownership
    token through one queue (pop = acquire, push = release, FIFO-fair).
    :func:`fifo_pipeline_programs` is the native pipelined-chain builder:
    per-link data queues plus a credit queue from the last stage back to the
    first bound the in-flight items to ``depth`` (classic credit flow), so
    stages overlap instead of meeting at a global barrier every tick.
  * chip level -- a point-to-point pipelined chain: the arrival word is
    accumulated along a neighbor send-recv chain (device i adds its word to
    the partial from i-1), then the total streams back along the reverse
    chain -- 2(n-1) pairwise hops, no all-to-all collective.
  * training -- a pipeline-style stage schedule: gradients reduce-scatter
    onto the ZeRO shards exactly like ``scu`` (numerically identical), with
    the tensors grouped into pipeline stages handed off in order.  On one
    device there is nothing to hand off (see ``policies``): the leaves come
    back bit-identical; over a ``DeviceMesh`` the stages are the
    reduce-scatters' hand-off order.
"""

from __future__ import annotations

import torch

from repro_torch.core.scu.engine import Compute, Scu
from repro_torch.core.scu.primitives import DEFAULT_COSTS
from repro_torch.sync.api import PolicyDef, register_policy
from repro_torch.sync.axis import axis_index, axis_size, ppermute
from repro_torch.sync.policies import _no_collectives, _zero_reduce, zero_opt_state_specs, zero_shape_gradients

__all__ = [
    "FIFO",
    "FIFO_PIPELINE_STAGES",
    "FifoState",
    "fifo_barrier",
    "fifo_chip_barrier",
    "fifo_mutex_section",
    "fifo_pipeline_programs",
    "fifo_shape_gradients",
    "fifo_work_queue_programs",
    "chain_fifo_span",
]

# SCU FIFO instance allocation (instance 0 stays the legacy cluster-external
# event queue; SCU(...) provisions 2*n_cores+8 instances by default):
#   1                      barrier gather queue (arrivals -> core 0)
#   2                      mutex ownership-token queue
#   3 .. 3+n-1             per-core barrier release queues
#   3+n .. 3+2n-2          chain link queues (stage i -> i+1 at 3+n+i)
#   3+2n-1                 chain credit queue (last stage -> stage 0)
F_GATHER = 1
F_MUTEX = 2
F_RELEASE_BASE = 3


def _release_addr(cid: int) -> int:
    return F_RELEASE_BASE + cid


def _link_addr(n_cores: int, link: int) -> int:
    return F_RELEASE_BASE + n_cores + link


def _credit_addr(n_cores: int) -> int:
    return F_RELEASE_BASE + 2 * n_cores - 1


def chain_fifo_span(n_cores: int) -> int:
    """Number of SCU FIFO instances the chain programs address (for sizing)."""
    return F_RELEASE_BASE + 2 * n_cores


class FifoState:
    """Per-run FIFO-discipline bookkeeping shared by all cores."""

    def __init__(self, n_cores: int):
        self.n_cores = n_cores
        self.mutex_seeded = False  # the single ownership token, pushed once


# ---------------------------------------------------------------------------
# Layer (a): simulator fragments
# ---------------------------------------------------------------------------


def fifo_barrier(cl, cid: int, st: FifoState, cm=DEFAULT_COSTS):
    """Gather/release barrier over event FIFOs.

    Arrivals stream into core 0's gather queue (producers push and move on to
    their private release pop); core 0 pops ``n-1`` arrival events -- asleep,
    clock-gated, between them -- then pushes one release token into *each*
    consumer's private queue.  Private release queues (rather than one shared
    queue) make back-to-back barriers safe: a fast core re-entering the next
    barrier can only ever pop its own queue, which holds at most its own
    token.
    """
    n = st.n_cores
    yield Compute(cm.call)
    if n == 1:
        yield Compute(cm.ret)
        return
    if cid == 0:
        for _ in range(n - 1):
            yield Compute(1)  # pop address setup
            yield Scu("elw", ("fifo", F_GATHER, "pop"))
        for peer in range(1, n):
            yield Compute(1)  # release address setup
            yield Scu("write", ("fifo", _release_addr(peer), "push"), 1)
    else:
        yield Compute(1)  # push address setup
        yield Scu("write", ("fifo", F_GATHER, "push"), cid % 256)
        yield Compute(1)  # pop address setup
        yield Scu("elw", ("fifo", _release_addr(cid), "pop"))
    yield Compute(cm.ret)


def fifo_mutex_section(cl, cid: int, t_crit: int, st: FifoState, cm=DEFAULT_COSTS):
    """Token-passing mutex: one ownership token circulates through a queue.

    Acquire = pop (clock-gated until the token is matched to this core),
    release = push.  The FIFO's popper queue makes the lock FIFO-fair; the
    single token makes it mutually exclusive.  The first core to run the
    section seeds the token (shared Python-side state, so exactly one push).
    """
    if not st.mutex_seeded:
        st.mutex_seeded = True
        yield Scu("write", ("fifo", F_MUTEX, "push"), 1)
    yield Compute(1)  # pop address setup
    yield Scu("elw", ("fifo", F_MUTEX, "pop"))
    if t_crit > 0:
        yield Compute(t_crit)
    yield Compute(1)  # push address setup
    yield Scu("write", ("fifo", F_MUTEX, "push"), 1)


def _fifo_sim_barrier(cluster, cid, state, cost_model=None):
    yield from fifo_barrier(cluster, cid, state, cost_model or DEFAULT_COSTS)


def _fifo_sim_mutex(cluster, cid, t_crit, state, cost_model=None):
    yield from fifo_mutex_section(
        cluster, cid, t_crit, state, cost_model or DEFAULT_COSTS
    )


def fifo_pipeline_programs(
    n_cores: int, work, state, cost_model=None, depth: int = 8
):
    """Native pipelined chain: one stage per core, credit-bounded in flight.

    ``work[item][stage]`` is the Compute cost of ``item`` at ``stage``.
    Stage ``s`` pops its input event from link ``s-1``, works, and pushes the
    completion event into link ``s``; the last stage returns a credit to
    stage 0, which stops injecting more than ``depth`` items ahead of the
    tail.  Every wait is a clock-gated elw pop -- no spinning, no barrier:
    stages overlap whenever the work is there, which is the whole point of
    the FIFO discipline.

    The credit flow bounds every link queue's occupancy to ``depth``, so
    ``depth`` is additionally clamped to the SCU's guaranteed FIFO capacity
    (``max(16, 2*n_cores)``, the ``SCU(...)`` default): a deeper request
    would overflow the queues, drop events, and deadlock the chain.  The
    programs re-check the actual SCU's provisioning (instance count and
    queue depth) when they start, so a custom under-provisioned SCU fails
    loudly instead of dropping events.  ``cost_model`` is unused: like the
    ``scu`` hardware fragments, the chain is address setup + SCU
    transactions, with no software primitive for the cost model to price.
    """
    items = len(work)
    capacity = max(16, 2 * n_cores)
    depth = max(1, min(int(depth) if depth else items, items, capacity))

    def make(cid):
        def prog(cluster, _cid):
            scu = cluster.scu
            if (
                scu is None
                or len(scu.fifos) < chain_fifo_span(n_cores)
                or scu.fifo.depth < depth
            ):
                raise RuntimeError(
                    f"SCU FIFO provisioning too small for a {n_cores}-stage "
                    f"chain at depth {depth}: need >= "
                    f"{chain_fifo_span(n_cores)} instances of depth >= "
                    f"{depth} (see repro_torch.sync.fifo's instance allocation)"
                )
            for item in range(items):
                if _cid == 0:
                    if item >= depth:  # credit flow bounds in-flight items
                        yield Compute(1)
                        yield Scu("elw", ("fifo", _credit_addr(n_cores), "pop"))
                else:
                    yield Compute(1)
                    yield Scu("elw", ("fifo", _link_addr(n_cores, _cid - 1), "pop"))
                w = int(work[item][_cid])
                if w > 0:
                    yield Compute(w)
                yield Compute(1)
                if _cid < n_cores - 1:
                    yield Scu(
                        "write", ("fifo", _link_addr(n_cores, _cid), "push"),
                        item % 256,
                    )
                else:
                    yield Scu("write", ("fifo", _credit_addr(n_cores), "push"), 1)

        return prog

    return [make(c) for c in range(n_cores)]


F_WORK_QUEUE = F_GATHER  # the work-queue bench runs no barrier: reuse inst 1


def fifo_work_queue_programs(
    n_producers: int, n_consumers: int, items: int,
    t_produce: int, t_consume: int, state, cost_model=None,
):
    """Native event-FIFO work queue: producers block on ``push_wait`` (the
    queue itself is the backpressure -- no credit counter, no lock), and
    consumers clock-gate on ``pop`` until an item event is matched to them.
    Nobody spins and nobody serializes through a mutex: the queue ports move
    one event per cycle each, which is the whole argument for the SCU FIFO
    over lock-based work queues (Sec. 4.3)."""

    def make_producer(quota):
        def prog(cluster, cid):
            for i in range(quota):
                if t_produce > 0:
                    yield Compute(t_produce)
                yield Compute(1)  # push address setup
                yield Scu("elw", ("fifo", F_WORK_QUEUE, "push_wait"), i % 256)

        return prog

    def make_consumer(quota):
        def prog(cluster, cid):
            for _ in range(quota):
                yield Compute(1)  # pop address setup
                yield Scu("elw", ("fifo", F_WORK_QUEUE, "pop"))
                if t_consume > 0:
                    yield Compute(t_consume)

        return prog

    from repro_torch.core.scu.programs import split_quota

    return [make_producer(q) for q in split_quota(items, n_producers)] + [
        make_consumer(q) for q in split_quota(items, n_consumers)
    ]


# ---------------------------------------------------------------------------
# Layer (b): chip-level point-to-point pipelined chain
# ---------------------------------------------------------------------------


def fifo_chip_barrier(arrive: torch.Tensor, axis) -> torch.Tensor:
    """Point-to-point pipelined chain: gather along the ring, stream back.

    Forward phase (n-1 neighbor hops): party i adds its arrival word to the
    partial received from i-1, so after hop k party i holds the sum over
    parties [max(0, i-k) .. i] and the tail ends with the full count.
    Backward phase (n-1 hops): the total streams back down the chain
    (``maximum`` keeps it sticky; counts are non-negative and everyone else
    holds zero).  2(n-1) pairwise sends, no all-to-all -- the chip analogue
    of the simulator's per-link event queues, exact for any group size.
    """
    n = axis_size(arrive, axis)
    if n == 1:
        return arrive
    idx = axis_index(arrive, axis)
    fwd = [(i, (i + 1) % n) for i in range(n)]
    token = arrive
    for _ in range(n - 1):
        incoming = ppermute(token, axis, fwd)
        # party 0 is the head of the chain: the wrap-around hop carries the
        # tail's partial, which must not re-enter the accumulation
        token = arrive + torch.where(idx >= 1, incoming, torch.zeros_like(incoming))
    total = torch.where(idx == n - 1, token, torch.zeros_like(token))
    bwd = [(i, (i - 1) % n) for i in range(n)]
    for _ in range(n - 1):
        total = torch.maximum(total, ppermute(total, axis, bwd))
    return total


# ---------------------------------------------------------------------------
# Layer (c): training -- pipeline-style stage schedule over ZeRO shards
# ---------------------------------------------------------------------------

FIFO_PIPELINE_STAGES = 4  # gradient tensors are grouped into this many stages


def fifo_shape_gradients(grads, params_shape, mesh, cfg=None):
    """Staged hand-off schedule, numerically identical to ``scu``.

    Gradients reduce-scatter onto the ZeRO shards exactly like the ``scu``
    policy; the tensors are grouped into ``FIFO_PIPELINE_STAGES`` contiguous
    stages in leaf order, handed off stage after stage: a stage's collectives
    are in flight together and waited before the next stage's are issued
    (finer than ``tas``'s single sync point, coarser than ``sw``'s per-tensor
    chain).  On one device there is nothing to hand off: the same leaves come
    back, bit-identical.
    """
    if _no_collectives(mesh):
        return zero_shape_gradients(grads, params_shape, mesh, cfg=cfg)
    return _zero_reduce(grads, params_shape, mesh, cfg, stages=FIFO_PIPELINE_STAGES)


FIFO = register_policy(PolicyDef(
    name="fifo",
    description=(
        "producer-consumer event-FIFO chains (SCU FIFO extension): clock-"
        "gated push/pop fragments + credit-bounded pipelined chains; chip: "
        "point-to-point neighbor chain collective; training: staged pipeline "
        "reduce-scatter (numerically identical to scu)"
    ),
    aliases=("FIFO",),
    make_sim_state=FifoState,
    sim_barrier=_fifo_sim_barrier,
    sim_mutex=_fifo_sim_mutex,
    chip_barrier=fifo_chip_barrier,
    shape_gradients=fifo_shape_gradients,
    opt_state_specs=zero_opt_state_specs,
    make_pipeline_programs=fifo_pipeline_programs,
    make_work_queue_programs=fifo_work_queue_programs,
    # the barrier's push/elw sequence is fixed by (cid, n) alone; the mutex
    # is NOT trace-safe: ``mutex_seeded`` is shared Python state mutated in
    # cross-core execution order, which per-core sentinel tracing cannot
    # observe -- it stays on the generator fallback
    trace_safe_barrier=True,
))
