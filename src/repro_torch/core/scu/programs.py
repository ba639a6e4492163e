"""Microbenchmark programs reproducing the paper's Sec. 6.3 experiments.

Own copy of ``repro/core/scu/programs.py`` (the port imports nothing of
``repro``), line for line, with the policies of ``repro_torch.sync``; and
beside it :func:`trace_barrier_programs`, :func:`trace_mutex_programs` and
:func:`trace_chain_programs`, the ``compiled=True`` programs of
``prep_barrier_bench``, ``prep_mutex_bench`` and ``prep_chain_bench`` alone,
which ``trace_exec.run_traces_torch`` runs on a card.

``primitive_cost`` mirrors the paper's methodology: "we let the involved
cores execute a loop eight times that contains the respective primitive 32
times and average the resulting cycle count".  The synchronization-free
region (SFR) between primitives is a run of ``Compute`` cycles (the paper
uses ``nop`` runs), tunable to sweep Fig. 5.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .engine import Cluster, ClusterStats, Compute, FleetConfig, Mem, simulate_fleet
from .primitives import DEFAULT_COSTS
from .scu_unit import SCU
from .trace import TraceProgram, lower_or_fallback

__all__ = [
    "FleetBench",
    "MicrobenchResult",
    "barrier_pipeline_programs",
    "make_fleet",
    "prep_barrier_bench",
    "prep_chain_bench",
    "prep_mutex_bench",
    "prep_work_queue_bench",
    "run_barrier_bench",
    "run_chain_bench",
    "run_mutex_bench",
    "run_nop_bench",
    "run_work_queue_bench",
    "split_quota",
    "trace_barrier_programs",
    "trace_chain_programs",
    "trace_mutex_programs",
    "work_queue_programs",
]


@dataclasses.dataclass
class MicrobenchResult:
    variant: str
    primitive: str
    n_cores: int
    sfr: int
    iters: int
    cycles_total: int
    cycles_per_iter: float
    prim_cycles: float  # cycles_per_iter - ideal (SFR resp. N*T_crit)
    active_core_cycles_per_iter: float
    gated_core_cycles_per_iter: float
    tcdm_per_iter: float
    scu_per_iter: float
    stats: ClusterStats


def _make_cluster(n_cores: int, mode: str = "fastforward") -> Cluster:
    return Cluster(n_cores=n_cores, scu=SCU(n_cores=n_cores), mode=mode)


def _lower_loop_programs(
    cl: Cluster,
    n_cores: int,
    programs,
    n_iters: int,
    emit_iter=None,
    frag_iter=None,
    label: str = "",
):
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

            out.append(
                lower_or_fallback(program, cl, cid, emit=emit, label=f"{label}:{cid}")
            )
        elif frag_iter is not None:

            def frags(cid=cid):
                return [
                    (lambda cid=cid, it=it: frag_iter(cid, it))
                    for it in range(n_iters)
                ]

            out.append(
                lower_or_fallback(
                    program, cl, cid, fragments=frags, label=f"{label}:{cid}"
                )
            )
        else:
            out.append(TraceProgram(fallback=program, label=f"{label}:fb:{cid}"))
    return out


def _lower_whole_programs(cl: Cluster, programs, trace_safe: bool, label: str = ""):
    """Lower pre-built (monolithic) per-core programs: whole-program sentinel
    tracing when the policy declared the fragments order-independent, else
    declared generator fallbacks for every core."""
    if not trace_safe:
        return [
            TraceProgram(fallback=p, label=f"{label}:fb:{cid}")
            for cid, p in enumerate(programs)
        ]
    return [
        lower_or_fallback(p, cl, cid, label=f"{label}:{cid}")
        for cid, p in enumerate(programs)
    ]


def _finalizer(
    variant: str,
    primitive: str,
    n_cores: int,
    sfr: int,
    iters: int,
    ideal_per_iter: float,
) -> Callable[[ClusterStats], MicrobenchResult]:
    """Deferred result builder: wraps finished ClusterStats into a
    MicrobenchResult -- shared by the sequential run_* paths and the
    batched fleet dispatch (:func:`make_fleet`)."""

    def finalize(st: ClusterStats) -> MicrobenchResult:
        per_iter = st.cycles / iters
        return MicrobenchResult(
            variant=variant,
            primitive=primitive,
            n_cores=n_cores,
            sfr=sfr,
            iters=iters,
            cycles_total=st.cycles,
            cycles_per_iter=per_iter,
            prim_cycles=per_iter - ideal_per_iter,
            active_core_cycles_per_iter=st.total_active / iters,
            gated_core_cycles_per_iter=st.total_gated / iters,
            tcdm_per_iter=st.total_tcdm / iters,
            scu_per_iter=st.total_scu / iters,
            stats=st,
        )

    return finalize


def _collect(
    variant: str,
    primitive: str,
    cl: Cluster,
    n_cores: int,
    sfr: int,
    iters: int,
    ideal_per_iter: float,
    warmup_stats: Optional[Tuple[int, Dict[str, float]]] = None,
) -> MicrobenchResult:
    return _finalizer(variant, primitive, n_cores, sfr, iters, ideal_per_iter)(
        cl.run()
    )


@dataclasses.dataclass
class FleetBench:
    """One prepared microbenchmark: a fleet config plus its result builder.

    Built by the ``prep_*_bench`` twins of the ``run_*_bench`` functions and
    dispatched in batches through :func:`make_fleet`; running the config's
    cluster sequentially and finalizing produces the identical result (the
    fleet engine is bit-exact per config)."""

    config: FleetConfig
    finalize: Callable[[ClusterStats], MicrobenchResult]

    def run_sequential(self) -> MicrobenchResult:
        """One-at-a-time execution (the non-batched reference path)."""
        cl = self.config.cluster
        cl.load(self.config.programs)
        return self.finalize(cl.run(self.config.max_cycles))


def make_fleet(benches: Sequence[FleetBench]) -> List[MicrobenchResult]:
    """Run prepared microbenchmarks as one batched fleet.

    The whole list executes as a single flattened array program
    (:func:`repro_torch.core.scu.engine.simulate_fleet`); per-bench results are
    bit-identical to calling ``run_sequential()`` on each bench.  This is
    the dispatch point the sweep benchmarks (Table 1, Fig. 5, chain, work
    queue) funnel through."""
    stats = simulate_fleet([b.config for b in benches])
    return [b.finalize(st) for b, st in zip(benches, stats)]


def prep_barrier_bench(
    variant: str, n_cores: int, sfr: int = 0, iters: int = 256, cost_model=None,
    mode: str = "fastforward", compiled: bool = False,
) -> FleetBench:
    """Prepare (without running) a barrier microbenchmark config.

    ``compiled=True`` lowers every core's program to a static trace
    (:mod:`repro_torch.core.scu.trace`) -- bit-exact stats, and fully-traced runs
    collapse repeated whole-cluster periods instead of simulating them.
    """
    from repro_torch.sync import get_policy  # deferred: repro_torch.sync imports this pkg

    policy = get_policy(variant)
    cl = _make_cluster(n_cores, mode)
    state = policy.make_sim_state(n_cores)
    cm = cost_model or DEFAULT_COSTS

    def program(cluster, cid):
        for _ in range(iters):
            if sfr > 0:
                yield Compute(sfr)
            yield from policy.sim_barrier(cluster, cid, state, cm)

    programs = [program] * n_cores
    if compiled:
        emit_iter = frag_iter = None
        if policy.trace_barrier is not None:

            def emit_iter(tb, cid, it):
                if sfr > 0:
                    tb.compute(sfr)
                policy.trace_barrier(tb, cl, cid, state, cm)

        elif policy.trace_safe_barrier:

            def frag_iter(cid, it):
                if sfr > 0:
                    yield Compute(sfr)
                yield from policy.sim_barrier(cl, cid, state, cm)

        programs = _lower_loop_programs(
            cl, n_cores, programs, iters, emit_iter, frag_iter,
            label=f"{variant}:barrier",
        )
    return FleetBench(
        config=FleetConfig(cluster=cl, programs=programs),
        finalize=_finalizer(variant, "barrier", n_cores, sfr, iters, float(sfr)),
    )


def run_barrier_bench(
    variant: str, n_cores: int, sfr: int = 0, iters: int = 256, cost_model=None,
    mode: str = "fastforward", compiled: bool = False,
) -> MicrobenchResult:
    """Loop of ``iters`` (SFR-compute + barrier) on every core.

    ``variant`` is any registered ``repro_torch.sync`` policy name (legacy
    uppercase spellings like ``"SCU"`` resolve via aliases).  ``mode``
    selects the engine (``"fastforward"`` skips quiescent cycles;
    ``"lockstep"`` is the cycle-by-cycle reference -- identical stats).
    """
    return prep_barrier_bench(
        variant, n_cores, sfr=sfr, iters=iters, cost_model=cost_model,
        mode=mode, compiled=compiled,
    ).run_sequential()


def prep_mutex_bench(
    variant: str, n_cores: int, t_crit: int = 0, sfr: int = 0, iters: int = 256,
    cost_model=None, mode: str = "fastforward", compiled: bool = False,
) -> FleetBench:
    """Prepare (without running) a mutex microbenchmark config."""
    from repro_torch.sync import get_policy  # deferred: repro_torch.sync imports this pkg

    policy = get_policy(variant)
    cl = _make_cluster(n_cores, mode)
    state = policy.make_sim_state(n_cores)
    cm = cost_model or DEFAULT_COSTS

    def program(cluster, cid):
        for _ in range(iters):
            if sfr > 0:
                yield Compute(sfr)
            yield from policy.sim_mutex(cluster, cid, t_crit, state, cm)

    programs = [program] * n_cores
    if compiled:
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

        programs = _lower_loop_programs(
            cl, n_cores, programs, iters, emit_iter, frag_iter,
            label=f"{variant}:mutex",
        )
    ideal = float(n_cores * t_crit + sfr)
    return FleetBench(
        config=FleetConfig(cluster=cl, programs=programs),
        finalize=_finalizer(
            variant, f"mutex_t{t_crit}", n_cores, sfr, iters, ideal
        ),
    )


def run_mutex_bench(
    variant: str, n_cores: int, t_crit: int = 0, sfr: int = 0, iters: int = 256,
    cost_model=None, mode: str = "fastforward", compiled: bool = False,
) -> MicrobenchResult:
    """Loop of (SFR-compute + critical section) on every core.

    Following the paper, the reported primitive cost is the overhead over the
    ideal ``N_C * T_crit`` serialization of the critical sections
    (``T_ideal = N_C T_crit``, Sec. 6.3).
    """
    return prep_mutex_bench(
        variant, n_cores, t_crit=t_crit, sfr=sfr, iters=iters,
        cost_model=cost_model, mode=mode, compiled=compiled,
    ).run_sequential()


def barrier_pipeline_programs(policy, n_cores: int, work, state, cost_model=None):
    """Barrier-synchronous pipeline emulation (the non-FIFO baseline).

    The classic way to run a stage pipeline with only barriers: the whole
    cluster advances in lockstep ticks; at tick ``t`` stage ``s`` works on
    item ``t - s`` (if in range), then everybody meets at a global barrier.
    Stages that have nothing to do this tick still pay the barrier -- the
    exact cost the SCU's event FIFO removes (Sec. 4.3), which is what
    :func:`run_chain_bench` measures.
    """
    cm = cost_model or DEFAULT_COSTS
    items = len(work)

    def make(cid):
        def prog(cluster, _cid):
            for tick in range(items + n_cores - 1):
                item = tick - _cid
                if 0 <= item < items:
                    w = int(work[item][_cid])
                    if w > 0:
                        yield Compute(w)
                yield from policy.sim_barrier(cluster, _cid, state, cm)

        return prog

    return [make(c) for c in range(n_cores)]


def make_pipeline_programs(
    policy, cl: Cluster, n_cores: int, work, state, cost_model=None,
    depth: int = 8,
):
    """Pipeline-program dispatch shared by the chain bench and the
    pipelined apps: the policy's native ``make_pipeline_programs`` hook when
    it has one (validated against the actual SCU FIFO capacity -- a deeper
    credit window than the queues hold would drop events and deadlock),
    else the barrier-synchronous emulation."""
    cm = cost_model or DEFAULT_COSTS
    maker = getattr(policy, "make_pipeline_programs", None)
    if maker is None:
        return barrier_pipeline_programs(policy, n_cores, work, state, cm)
    if cl.scu is not None and depth > cl.scu.fifo.depth:
        raise ValueError(
            f"pipeline depth {depth} exceeds the SCU FIFO depth "
            f"{cl.scu.fifo.depth}; deepen the FIFOs or lower the bound"
        )
    return maker(n_cores, work, state, cm, depth)


def prep_chain_bench(
    variant: str,
    n_cores: int,
    sfr: int = 100,
    iters: int = 32,
    depth: int = 8,
    cost_model=None,
    mode: str = "fastforward",
    compiled: bool = False,
) -> FleetBench:
    """Prepare (without running) a pipelined-chain microbenchmark config."""
    from repro_torch.sync import get_policy  # deferred: repro_torch.sync imports this pkg

    policy = get_policy(variant)
    cl = _make_cluster(n_cores, mode)
    state = policy.make_sim_state(n_cores)
    cm = cost_model or DEFAULT_COSTS
    work = [[sfr] * n_cores for _ in range(iters)]
    programs = make_pipeline_programs(
        policy, cl, n_cores, work, state, cost_model, depth
    )
    if compiled:
        if getattr(policy, "make_pipeline_programs", None) is not None:
            # native (FIFO) chain: monolithic per-core programs, traced whole
            programs = _lower_whole_programs(
                cl, programs, policy.trace_safe_barrier,
                label=f"{variant}:chain",
            )
        else:
            # barrier-synchronous emulation: per-tick loop, same lowering
            # split as the barrier bench
            emit_iter = frag_iter = None

            def _tick_work(cid, tick):
                item = tick - cid
                if 0 <= item < iters:
                    return int(work[item][cid])
                return 0

            if policy.trace_barrier is not None:

                def emit_iter(tb, cid, tick):
                    w = _tick_work(cid, tick)
                    if w > 0:
                        tb.compute(w)
                    policy.trace_barrier(tb, cl, cid, state, cm)

            elif policy.trace_safe_barrier:

                def frag_iter(cid, tick):
                    w = _tick_work(cid, tick)
                    if w > 0:
                        yield Compute(w)
                    yield from policy.sim_barrier(cl, cid, state, cm)

            programs = _lower_loop_programs(
                cl, n_cores, programs, iters + n_cores - 1, emit_iter,
                frag_iter, label=f"{variant}:chain",
            )
    return FleetBench(
        config=FleetConfig(cluster=cl, programs=programs),
        finalize=_finalizer(
            variant, f"chain_d{depth}", n_cores, sfr, iters, float(sfr)
        ),
    )


def run_chain_bench(
    variant: str,
    n_cores: int,
    sfr: int = 100,
    iters: int = 32,
    depth: int = 8,
    cost_model=None,
    mode: str = "fastforward",
    compiled: bool = False,
) -> MicrobenchResult:
    """Pipelined producer-consumer chain: ``n_cores`` stages, ``iters`` items.

    Every item costs ``sfr`` compute cycles at every stage, so the ideal
    steady-state cost is one item per ``sfr`` cycles (stages fully
    overlapped); ``prim_cycles`` is the per-item overhead over that ideal.
    Policies with a native ``make_pipeline_programs`` hook (the ``fifo``
    discipline's credit-bounded chain, bounded to ``depth`` in-flight items)
    run it; everything else falls back to the barrier-synchronous emulation
    -- the baseline the paper's FIFO extension exists to beat.
    """
    return prep_chain_bench(
        variant, n_cores, sfr=sfr, iters=iters, depth=depth,
        cost_model=cost_model, mode=mode, compiled=compiled,
    ).run_sequential()


WQ_CS_CYCLES = 6  # queue-pointer bookkeeping inside the dequeue/enqueue lock
WQ_RETRY_CYCLES = 8  # consumer backoff before re-polling an empty queue
A_WQ_LEVEL = 0x180  # advertised queue occupancy (test before locking)


class _WorkQueue:
    """Occupancy bookkeeping of the shared work queue.

    The item count is Python-side shared state, like the software barriers'
    local-sense arrays: the *synchronization traffic* (the occupancy word
    at :data:`A_WQ_LEVEL`, mutex acquire/release around every queue
    operation, the consumers' retry discipline, or the FIFO policy's native
    push/pop events) runs through simulated ops and is the measured
    quantity; the item payloads themselves are abstract.
    """

    def __init__(self):
        self.available = 0


def split_quota(items: int, n: int) -> list:
    """Fair partition of ``items`` over ``n`` workers (remainder first)."""
    return [items // n + (1 if i < items % n else 0) for i in range(n)]


def work_queue_programs(
    policy, n_producers: int, n_consumers: int, items: int,
    t_produce: int, t_consume: int, state, cost_model=None,
):
    """Multi-producer/multi-consumer work-queue programs for any policy.

    Policies with a native ``make_work_queue_programs`` hook (the ``fifo``
    discipline: blocking ``push_wait`` producers against hardware
    backpressure, clock-gated ``pop`` consumers) build their own programs;
    everything else runs the classic software shape -- a mutex-protected
    shared queue where producers enqueue under the lock and consumers
    poll-and-retry until their quota of items arrived.
    """
    cm = cost_model or DEFAULT_COSTS
    maker = getattr(policy, "make_work_queue_programs", None)
    if maker is not None:
        return maker(
            n_producers, n_consumers, items, t_produce, t_consume, state, cm
        )
    wq = _WorkQueue()

    def make_producer(quota):
        def prog(cluster, cid):
            for _ in range(quota):
                if t_produce > 0:
                    yield Compute(t_produce)
                yield from policy.sim_mutex(cluster, cid, WQ_CS_CYCLES, state, cm)
                wq.available += 1
                yield Mem("sw", A_WQ_LEVEL, wq.available)  # advertise

        return prog

    def make_consumer(quota):
        def prog(cluster, cid):
            got = 0
            while got < quota:
                # test before locking: poll the occupancy word with a plain
                # load and only contend for the lock when the queue looks
                # non-empty.  Besides being how real runtimes shape this
                # loop, it is essential for liveness here: under the
                # cycle-exact simulator, consumers hammering the lock on an
                # empty queue can resonate into perfectly periodic
                # starvation of the producers.  The backoff is additionally
                # staggered by core id (the simulated twin of randomized
                # backoff) so consumer herds don't re-synchronize.
                #
                # The load models the polling traffic; the *decision* reads
                # the Python-side count, which is the coherent value of the
                # occupancy word.  (A real TCDM load is coherent with the
                # enqueue that produced it; trusting the simulated store
                # data instead would re-introduce an artifact of our
                # modeling -- Mem data is captured at yield time but lands
                # at grant time, so a stale snapshot can be granted after a
                # newer one and park the advertised level at 0 forever.)
                yield Mem("lw", A_WQ_LEVEL)
                yield Compute(1 + cm.load_use)
                if wq.available <= 0:
                    yield Compute(WQ_RETRY_CYCLES + cid)
                    continue
                yield from policy.sim_mutex(cluster, cid, WQ_CS_CYCLES, state, cm)
                if wq.available > 0:
                    wq.available -= 1
                    yield Mem("sw", A_WQ_LEVEL, wq.available)
                    got += 1
                    if t_consume > 0:
                        yield Compute(t_consume)
                else:
                    yield Compute(WQ_RETRY_CYCLES + cid)

        return prog

    return [make_producer(q) for q in split_quota(items, n_producers)] + [
        make_consumer(q) for q in split_quota(items, n_consumers)
    ]


def prep_work_queue_bench(
    variant: str,
    n_producers: int,
    n_consumers: int,
    items: int = 64,
    t_produce: int = 30,
    t_consume: int = 30,
    cost_model=None,
    mode: str = "fastforward",
    compiled: bool = False,
) -> FleetBench:
    """Prepare (without running) a multi-producer work-queue config."""
    from repro_torch.sync import get_policy  # deferred: repro_torch.sync imports this pkg

    policy = get_policy(variant)
    n_cores = n_producers + n_consumers
    cl = _make_cluster(n_cores, mode)
    state = policy.make_sim_state(n_cores)
    programs = work_queue_programs(
        policy, n_producers, n_consumers, items, t_produce, t_consume,
        state, cost_model,
    )
    if compiled:
        # the native FIFO queue programs are value- and order-independent
        # (trace-safe); the generic mutex-protected queue branches on shared
        # Python-side occupancy in cross-core execution order, so every
        # non-native policy is a declared generator fallback
        native = getattr(policy, "make_work_queue_programs", None) is not None
        programs = _lower_whole_programs(
            cl, programs, native and policy.trace_safe_barrier,
            label=f"{variant}:wq",
        )
    ideal = items * max(t_produce / n_producers, t_consume / n_consumers)
    return FleetBench(
        config=FleetConfig(cluster=cl, programs=programs),
        finalize=_finalizer(
            variant, f"wq_p{n_producers}c{n_consumers}", n_cores, t_produce,
            items, ideal / items,
        ),
    )


def run_work_queue_bench(
    variant: str,
    n_producers: int,
    n_consumers: int,
    items: int = 64,
    t_produce: int = 30,
    t_consume: int = 30,
    cost_model=None,
    mode: str = "fastforward",
    compiled: bool = False,
) -> MicrobenchResult:
    """Multi-producer work queue: P producers feed C consumers through one
    shared queue; every policy supplies its own queue discipline (see
    :func:`work_queue_programs`).

    The ideal steady state is bounded by the busier side of the queue --
    ``max(P * t_produce, C * t_consume) / (P*C)``-ish per item; we report
    ``cycles_per_iter`` per *item* and the overhead over the ideal
    ``items * max(t_produce / P, t_consume / C)`` schedule.
    """
    return prep_work_queue_bench(
        variant, n_producers, n_consumers, items=items, t_produce=t_produce,
        t_consume=t_consume, cost_model=cost_model, mode=mode,
        compiled=compiled,
    ).run_sequential()


def run_nop_bench(
    n_cores: int, cycles: int = 512, mode: str = "fastforward"
) -> ClusterStats:
    """``cycles`` of straight-line compute on every core (the paper's 512-nop
    run used to normalize power, Sec. 6.3)."""
    cl = _make_cluster(n_cores, mode)

    def program(cluster, cid):
        yield Compute(cycles)

    cl.load([program] * n_cores)
    return cl.run()


# --------------------------------------------------------------------------
# The compiled programs alone, for trace_exec.run_traces_torch
# --------------------------------------------------------------------------


def trace_barrier_programs(variant: str, n_cores: int, sfr: int = 0, iters: int = 256) -> List[TraceProgram]:
    """Per-core traces of ``iters`` x (``sfr`` Compute cycles + one barrier):
    ``prep_barrier_bench(variant, n_cores, sfr, iters, compiled=True)``'s programs."""
    return prep_barrier_bench(variant, n_cores, sfr=sfr, iters=iters, compiled=True).config.programs


def trace_chain_programs(variant: str, n_cores: int, sfr: int = 100, iters: int = 32) -> List[TraceProgram]:
    """Per-core traces of the pipeline of ``iters`` items through ``n_cores``
    stages of ``sfr`` Compute cycles each: ``prep_chain_bench(variant,
    n_cores, sfr, iters, compiled=True)``'s programs.

    Without a native pipeline, at tick ``t`` core ``c`` computes item ``t - c``
    when that item exists, then the whole cluster meets at a barrier;
    ``iters + n_cores - 1`` ticks, and a core with no item in a tick emits no
    ``Compute`` row.  A policy with a native pipeline (``fifo``) runs its own
    programs on the SCU's event FIFOs: they carry SCU rows, which the trace
    executor refuses.
    """
    return prep_chain_bench(variant, n_cores, sfr=sfr, iters=iters, compiled=True).config.programs


def trace_mutex_programs(
    variant: str, n_cores: int, t_crit: int = 0, sfr: int = 0, iters: int = 256
) -> List[TraceProgram]:
    """Per-core traces of ``iters`` x (``sfr`` Compute cycles + one critical
    section of ``t_crit`` cycles): ``prep_mutex_bench(variant, n_cores,
    t_crit, sfr, iters, compiled=True)``'s programs."""
    return prep_mutex_bench(variant, n_cores, t_crit=t_crit, sfr=sfr, iters=iters, compiled=True).config.programs
